"""GAN training with the port on the CPU: ``Trainer`` with ``-gan -perturb
graphn`` on a tiny relation model and GAN (an epoch, finite losses, every
key; the LR boundaries counting two SGD updates a batch under ``rec``, as
the JAX trainer's), a checkpoint round trip with the ``gan`` entry, the
tentpole command through ``python -m sgg_torch.main`` in-process (``-device
cpu``, 128-pixel canvases, tiny widths), the refusals (``-vis_cond``,
``-gan -m sgdet``); and one GAN step from images (the trunk runs) against
the JAX step, 1e-5 relative."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_torch.constants
import sgg_torch.data.synthetic
from sgg_tpu.config import Config as JConfig
from sgg_tpu.train.state import multistep_lr as jmultistep_lr
from sgg_torch import main as cli
from sgg_torch.config import Config
from sgg_torch.models.gan import GANModel, init_gan_weights
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train import trainer as trainer_mod
from sgg_torch.train.trainer import Trainer
from test_torch_resnet_fpn import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

C, R, IMG = 9, 6, 128  # a 128-pixel canvas: an 8x8 map, the CRN's least


@pytest.fixture
def small_canvas(monkeypatch):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)


def _tiny_model(config, train_data, *, device="cuda", seed=0):
    return init_weights(RelModelIMP(
        num_classes=train_data.num_classes,
        num_predicates=train_data.num_predicates, mode=config.mode,
        hidden_dim=16, obj_dim=32), seed).to(device).eval()


def _tiny_gan(config, train_data, *, device="cuda", seed=1):
    return init_gan_weights(GANModel(
        train_data.num_classes, train_data.num_predicates, embed_dim=16,
        hidden_dim=8, fmap_sz=IMG // 16, n_layers_G=2,
        largeD=config.largeD), seed).to(device)


@pytest.fixture
def tiny(monkeypatch, small_canvas):
    monkeypatch.setattr(trainer_mod, "build_model", _tiny_model)
    monkeypatch.setattr(trainer_mod, "build_gan", _tiny_gan)


def _splits(num_train=8):
    return sgg_torch.data.synthetic.synthetic_splits(
        num_train=num_train, num_eval=4, num_classes=C, num_predicates=R,
        max_objects=6, image_size=IMG)


def _config(save_dir=None, **kw):
    kw = {**dict(device="cpu", mode="sgcls", loss="dnorm", batch_size=4,
                 max_nodes=8, max_edges=8, compute_dtype="float32",
                 num_workers=1, gan=True, largeD=True, perturb="graphn",
                 L=0.5, print_interval=1, save_dir=save_dir), **kw}
    return Config(**kw)


def _gan_state(t):
    return {**{k: v.detach().clone() for k, v in t.gan.state_dict().items()},
            **{f"g_opt/{k}/{n}": v.clone()
               for k in ("mu", "nu") for n, v in t.g_opt.state_dict()[k]
               .items()},
            **{f"d_opt/{k}/{n}": v.clone()
               for k in ("mu", "nu") for n, v in t.d_opt.state_dict()[k]
               .items()}}


@pytest.mark.usefixtures("tiny")
def test_gan_trainer_epoch_and_checkpoint_round_trip(tmp_path):
    splits = _splits()
    t = Trainer(_config(str(tmp_path)), splits)
    assert t.perturber is not None and t.gan is not None
    losses = t.train_epoch(0)
    for k in ("obj_loss", "rel_loss", "grad_norm", "G_obj", "G_rel",
              "G_fmap", "obj_loss_rec", "rel_loss_rec", "D_obj", "D_rel",
              "D_fmap", "grad_norm_G", "grad_norm_D", "total"):
        assert k in losses and np.isfinite(losses[k]), (k, losses)
    # two SGD updates a batch (F and rec), one for each Adam
    assert t.optimizer.count == 2 * 2 and t.g_opt.count == t.d_opt.count == 2
    t.save(0)
    payload, _ = ckpt.restore_payload(str(tmp_path))
    assert set(payload["gan"]) == {"params", "stats", "g_opt", "d_opt"}
    other = Trainer(_config(str(tmp_path)), splits)
    assert other.start_epoch == 1 and other.optimizer.count == 4
    assert other.g_opt.count == 2 and other.d_opt.count == 2
    want, got = _gan_state(t), _gan_state(other)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the next step from the saved and the restored state
    batch = next(iter(
        trainer_mod.BatchLoader(splits["train"], batch_size=4, max_nodes=8,
                                max_edges=8, shuffle=False,
                                im_scale=IMG)))
    fake = torch.from_numpy(np.asarray(batch.classes))
    a = t.gan_step(batch, fake, torch.Generator().manual_seed(3))
    b = other.gan_step(batch, fake, torch.Generator().manual_seed(3))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    marks = []  # the phase hook chip_smoke.py times the phases with
    t.gan_step(batch, fake, torch.Generator().manual_seed(4),
               mark=marks.append)
    assert marks == ["F", "G", "D"]


@pytest.mark.usefixtures("tiny")
@pytest.mark.parametrize("ganlosses,per_batch", [("D_G_rec", 2),
                                                 ("D_G", 1)])
def test_lr_boundaries_count_both_sgd_updates(ganlosses, per_batch):
    """Under ``rec`` the schedule's boundaries sit at twice the updates a
    batch, as ``sgg_tpu/train/trainer.py:308-317`` sets them."""
    splits = _splits(num_train=12)
    cfg = _config(ganlosses=ganlosses, steps="0_1", lr_decay=0.5)
    t = Trainer(cfg, splits)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)
                      if f.name != "device" and hasattr(cfg, f.name)})
    want = jmultistep_lr(jcfg.lr * jcfg.batch_size, jcfg.steps,
                         jcfg.lr_decay, t.steps_per_epoch * per_batch)
    got = t.optimizer.schedules["main"]
    lrs = [got(k) for k in range(16)]
    assert np.allclose(lrs, [float(want(k)) for k in range(16)], rtol=1e-6)
    assert lrs.index(lrs[0] * 0.5) == 3 * per_batch


def test_refusals():
    splits = _splits()
    with pytest.raises(NotImplementedError, match="feature bank"):
        Trainer(_config(vis_cond="features.hdf5"), splits,
                model=_tiny_model(_config(), splits["train"], device="cpu"))
    with pytest.raises(ValueError, match="sgdet"):
        Trainer(_config(mode="sgdet"), splits,
                model=_tiny_model(_config(), splits["train"], device="cpu"),
                detector=object())


@pytest.mark.usefixtures("tiny")
def test_cli_trains_the_gan_command(tmp_path, monkeypatch):
    """``python -m sgg_torch.main -m sgcls -loss dnorm -gan -largeD
    -perturb graphn -L 0.2 -topk 5 -graphn_a 2 -split synthetic -device
    cpu`` at tiny widths on 8 train images, an epoch, then the test
    sweep."""
    monkeypatch.setattr(sgg_torch.data.synthetic, "synthetic_splits",
                        functools.partial(
                            sgg_torch.data.synthetic.synthetic_splits,
                            num_train=8))
    run = str(tmp_path / "run")
    results = cli.main(["-m", "sgcls", "-loss", "dnorm", "-b", "4", "-gan",
                        "-largeD", "-perturb", "graphn", "-L", "0.2",
                        "-topk", "5", "-graphn_a", "2", "-split",
                        "synthetic", "-device", "cpu", "-nepoch", "1",
                        "-val_size", "4", "-p", "1", "-nwork", "1",
                        "-max_nodes", "8", "-max_edges", "8", "-save_dir",
                        run])
    assert os.path.exists(os.path.join(run, "test_results.json"))
    assert "sgcls/test_alls_R@100_GC" in results
    payload, epoch = ckpt.restore_payload(run)
    assert epoch == 0 and "gan" in payload
    assert int(payload["gan"]["g_opt"]["count"]) == 2


def test_gan_step_from_images_matches_jax(monkeypatch):
    """One ``D_G_rec`` step from 128-pixel images (the frozen VGG16 trunk
    runs; the layout's frame is the padded canvas) against the JAX step:
    metrics, the gradients each optimizer receives by part, the SGG and GAN
    statistics after (tolerances of ``test_torch_gan_step.py``), but G's
    gradient by part within 1e-3 and ``grad_norm_G`` within 1e-4: the D
    calls G's losses go through have units whose pre-activations lie
    within float32 rounding of 0 here (``D_edges``' first conv 2.7e-6,
    ``D_global``'s fourth 1.5e-6) and gate differently in the two
    packages, which moves the whole of G's gradient (measured: 6.6e-5 to
    1.6e-4 by part, ``grad_norm_G`` 2.4e-5; the Ds' own gradients within
    2.3e-6)."""
    G_GATED = 1e-3
    import types

    import sgg_tpu.models.backbone as jbackbone
    from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
    from sgg_tpu.models.gan import GANModel as JGAN
    from sgg_tpu.models.relhead import RelModelIMP as JModel
    from sgg_tpu.train.assign import sample_edges as jsample_edges
    from sgg_tpu.train.gan_step import create_gan_state
    from sgg_tpu.train.gan_step import make_gan_train_step as jmake_step
    from sgg_tpu.train.state import create_train_state
    from sgg_torch.convert import variables_from_jax
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    from sgg_torch.models.backbone import Dropout
    from sgg_torch.train.gan_step import (create_gan_optimizers,
                                          make_gan_train_step)
    from sgg_torch.train.state import Optimizer
    from test_torch_gan_step import (GRAD_RTOL, RTOL, SN_RTOL, _grad_errs,
                                     _record_port, _recording, rel_err)
    from test_torch_models import random_variables

    monkeypatch.setattr(jbackbone.nn, "Dropout",
                        lambda rate, deterministic=None: (lambda x: x))
    kw = dict(num_images=2, num_classes=C, num_predicates=R, max_objects=5,
              image_size=IMG, with_images=True, seed=8)
    jb = JSynth(**kw).batch([0, 1], max_nodes=6, max_edges=10)
    tb = SyntheticSGGDataset(**kw).batch([0, 1], max_nodes=6, max_edges=10)
    key = jax.random.key(4)
    sampled, pm = jsample_edges(jax.random.split(key, 3)[0], jb.rels,
                                jb.rel_mask, jb.node_mask, max_out=10)
    jm = JModel(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                dtype=jnp.float32)
    jgan = JGAN(num_classes=C, num_predicates=R, hidden_dim=8, n_ch=512,
                fmap_sz=IMG // 16, n_layers_G=2, largeD=True)
    v_sgg = random_variables(jm, (jb.images, jb.boxes, jb.classes,
                                  sampled[..., :2], pm), seed=5)
    v_gan = random_variables(types.SimpleNamespace(init=functools.partial(
        jgan.init, method=JGAN.init_all)), (jb.classes, jb.boxes / IMG,
                                           jb.rels, jb.node_mask,
                                           jb.rel_mask), seed=6)
    ckw = dict(batch_size=2, max_nodes=6, max_edges=10, mode="sgcls",
               loss="dnorm", compute_dtype="float32", gan=True)
    jcfg = JConfig(**ckw)
    want_g = {}
    sgg = create_train_state(jcfg, v_sgg)
    state = create_gan_state(jcfg, sgg.replace(
        tx=_recording(sgg.tx, "sgg", want_g)), v_gan)
    state = state.replace(g_tx=_recording(state.g_tx, "G", want_g),
                          d_tx=_recording(state.d_tx, "D", want_g))
    state, want = jmake_step(jm, jgan, jcfg)(state, jb, jb.classes, None,
                                             key)
    jax.effects_barrier()

    tm = RelModelIMP(num_classes=C, num_predicates=R, hidden_dim=16,
                     obj_dim=32)
    tm.load_state_dict(variables_from_jax(v_sgg), strict=True)
    for mod in tm.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    tgan = GANModel(C, R, hidden_dim=8, n_ch=512, fmap_sz=IMG // 16,
                    n_layers_G=2, largeD=True)
    tgan.load_state_dict(variables_from_jax(v_gan), strict=True)
    cfg = Config(device="cpu", **ckw)
    opt = Optimizer(cfg, tm)
    g_opt, d_opt = create_gan_optimizers(cfg, tgan)
    got_g = {}
    for o, tag in ((opt, "sgg"), (g_opt, "G"), (d_opt, "D")):
        _record_port(o, tag, got_g)

    got = make_gan_train_step(tm, tgan, cfg, opt, g_opt, d_opt)(
        tb, torch.from_numpy(np.asarray(tb.classes)), None,
        edges=(torch.from_numpy(np.array(sampled)),
               torch.from_numpy(np.array(pm))))
    assert {k: len(v) for k, v in got_g.items()} == \
        {k: len(v) for k, v in want_g.items()} == {"sgg": 2, "G": 1, "D": 1}
    for tag, prefix in (("sgg", None), ("G", "G."), ("D", "D_")):
        for g, w in zip(got_g[tag], want_g[tag]):
            errs = _grad_errs(g, w, prefix)
            assert all(e <= GRAD_RTOL.get(p, G_GATED if tag == "G" else RTOL)
                       for p, e in errs.items()), (tag, errs)
    assert set(got) == set(want)
    for k in want:
        assert rel_err(float(got[k]), float(want[k])) <= (
            1e-4 if k == "grad_norm_G" else RTOL), k
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    for module, params, stats in ((tm, state.sgg.params,
                                   state.sgg.batch_stats),
                                  (tgan, state.gan_params, state.gan_stats)):
        ref = variables_from_jax({"params": to_np(params),
                                  "batch_stats": to_np(stats)})
        names = dict(module.named_parameters())
        for k, b in module.state_dict().items():
            if k not in names and not k.endswith("num_batches_tracked"):
                assert rel_err(b.numpy(), ref[k].numpy()) <= (
                    SN_RTOL if k.endswith(("u", "sigma")) else RTOL), k
