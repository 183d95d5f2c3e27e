"""The GAN's feature-bank conditioning (``-vis_cond``) in the port against
``sgg_tpu`` on the CPU in f32:

* ``Generator``/``GANModel`` with ``vis_cond``: the bank's features enter
  ahead of the node features on the channel axis before the projection
  (train mode, BatchNorm statistics after), the same flax variables through
  ``variables_from_jax``; a missing ``vis_features`` raises; the seeded
  init draws the 576-input projection in the JAX initializer's law;
* the conditioned GAN step (``D_G_rec``, largeD) against
  ``make_gan_train_step`` on the same vis tensor, with the tolerances of
  ``test_torch_gan_step.py``: every metric, the gradients each optimizer
  receives by part in norm, the SGG and GAN statistics after;
* ``Trainer._gan_host_inputs``: the classes and the vis tensor equal to the
  JAX trainer's for the same bank file, seed and batches, and the copy to
  a device;
* ``Trainer`` with ``gan=True, vis_cond=<bank>`` trains an epoch on the
  CPU (finite losses, G's projection moved), and ``python -m
  sgg_torch.main ... -gan -largeD -vis_cond <bank> -perturb graphn`` runs
  in-process; without ``h5py``, ``-vis_cond`` raises an ``ImportError``
  naming it before any model is built."""

import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_torch.constants
import sgg_torch.data.synthetic
import sgg_tpu.models.backbone as jbackbone
from sgg_tpu.augment.feature_bank import FeatureBank as JBank
from sgg_tpu.augment.perturb import SceneGraphPerturb as JPerturb
from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.word_vectors import normalized_class_embeddings as jembed
from sgg_tpu.models.gan import GANModel as JGAN
from sgg_tpu.models.gan.gan import Generator as JGenerator
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.train.gan_step import create_gan_state
from sgg_tpu.train.gan_step import make_gan_train_step as jmake_gan_step
from sgg_tpu.train.state import create_train_state
from sgg_tpu.train.trainer import Trainer as JTrainer
from sgg_torch import main as cli
from sgg_torch.augment.feature_bank import FeatureBankWriter
from sgg_torch.config import Config
from sgg_torch.convert import variables_from_jax
from sgg_torch.models.backbone import Dropout
from sgg_torch.models.gan import GANModel, Generator, init_gan_weights
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train import trainer as trainer_mod
from sgg_torch.train.gan_step import (create_gan_optimizers,
                                      make_gan_train_step)
from sgg_torch.train.state import Optimizer
from sgg_torch.train.trainer import GANBatch, Trainer
from test_torch_gan_model import _graph, _port, _t, assert_state_close
from test_torch_gan_model import _variables as _gvariables
from test_torch_gan_step import (GRAD_RTOL, RTOL, SN_RTOL, _batches,
                                 _grad_errs, _record_port, _recording,
                                 rel_err)
from test_torch_models import random_variables
from test_torch_resnet_fpn import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _vis(shape, node_mask, seed):
    """Bank-like features (ReLU outputs) for the valid nodes, zeros for
    padding: (B, N, p, p, C)."""
    rng = np.random.RandomState(seed)
    v = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    return v * np.asarray(node_mask, np.float32)[:, :, None, None, None]


def test_generator_with_vis_cond():
    C, P = 9, 6
    args = _graph(21)
    kw = dict(num_classes=C, num_predicates=P, hidden_dim=8, n_ch=32,
              fmap_sz=13, n_layers=2, vis_cond=True)
    B, N = args[0].shape
    vis = _vis((B, N, 7, 7, 32), args[3], 22)
    jm = JGenerator(**kw)
    v = _gvariables(jm, tuple(map(jnp.asarray, args)), seed=23, train=True,
                    vis_features=jnp.asarray(vis))
    assert v["params"]["proj"]["kernel"].shape == (1, 1, 32 + 8, 8)
    tm = _port(Generator, v, **kw)
    want, mut = jax.jit(lambda v, *a: jm.apply(
        v, *a[:-1], vis_features=a[-1], train=True,
        mutable=["batch_stats"]))(v, *args, vis)
    got = tm.train()(*map(_t, args), vis_features=_t(vis))
    assert got.shape == (B, 13, 13, 32)
    assert rel_err(got.detach().numpy(), want) <= RTOL
    assert_state_close(tm, mut, v["params"])
    # G's backward from one fixed map gradient, by part in norm (a bias
    # before a train-mode BatchNorm gets a gradient of rounding size)
    cot = np.random.RandomState(28).randn(*got.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: (jm.apply(
        {**v, "params": p}, *args, vis_features=vis, train=True,
        mutable=["batch_stats"])[0] * cot).sum()))(v["params"])
    tm.load_state_dict(variables_from_jax(v), strict=True)
    tm.zero_grad()
    (tm(*map(_t, args), vis_features=_t(vis)) * _t(cot)).sum().backward()
    want_g = variables_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    diff, ref = {}, {}
    for k, p in tm.named_parameters():
        part, w = k.split(".")[0], want_g[k].double()
        diff[part] = diff.get(part, 0.0) + float(
            (p.grad.double() - w).square().sum())
        ref[part] = ref.get(part, 0.0) + float(w.square().sum())
    errs = {part: (diff[part] / ref[part]) ** 0.5 for part in diff}
    assert len(errs) == 7 and all(e <= RTOL for e in errs.values()), errs
    assert tm.proj.weight.grad[:, :32].abs().sum() > 0
    # the bank's channels matter, and come first
    other = vis.copy()
    other[0, 0] += 1.0
    assert not torch.equal(tm.eval()(*map(_t, args), vis_features=_t(other)),
                           tm(*map(_t, args), vis_features=_t(vis)))
    with pytest.raises(ValueError, match="vis_features"):
        tm(*map(_t, args))
    gan = GANModel(C, P, hidden_dim=8, n_ch=32, fmap_sz=13, n_layers_G=2,
                   vis_cond=True)
    out = gan.generate(*map(_t, args), vis_features=_t(vis))
    assert out.shape == (B, 13, 13, 32)


def test_init_draws_the_wide_projection_in_the_jax_law():
    """Flax's lecun normal, truncated at 2 std, over the 576 inputs of the
    full-width conditioned projection."""
    gan = init_gan_weights(GANModel(9, 6, vis_cond=True), 0)
    w = gan.G.proj.weight.detach()
    assert w.shape == (64, 512 + 64, 1, 1)
    std = 576 ** -0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert not gan.G.proj.bias.detach().any()


# ---------------------------------------------------------------------------
C, R, B, N, E, FM = 9, 6, 2, 6, 10, 8  # as test_torch_gan_step.py


G_GATED, G_NORM_GATED = 1e-2, 1e-3  # see the test's docstring


def test_conditioned_gan_step_matches_jax(monkeypatch):
    """One ``D_G_rec`` step with ``vis_cond`` from cached maps on the same
    sampled edges, perturbed classes and vis tensor, dropout off.

    G's gradient by part is held within ``G_GATED`` and ``grad_norm_G``
    within ``G_NORM_GATED``: a unit of a D conv that G's adversarial losses
    pass through has its pre-activation at 3.2e-7 of the conv's largest
    magnitude here (float32 rounding), and its ReLU gates differently in
    the two packages, which moves all of G's gradient (measured: 2.7e-3 to
    4.4e-3 by part, ``grad_norm_G`` 1.0e-4; with the reconstruction loss
    alone G's gradient is 0 in both, and the step without ``vis_cond`` on
    the same draws reads 5.2e-6). G's own backward, the projection's bank
    columns included, is held at 1e-5 from a fixed map gradient in
    ``test_generator_with_vis_cond``."""
    monkeypatch.setattr(jbackbone.nn, "Dropout",
                        lambda rate, deterministic=None: (lambda x: x))
    jb, tb, fake, key, edges = _batches(1)[0]
    vis = _vis((B, N, 7, 7, 512), jb.node_mask, 24)
    jm = JModel(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                mode="sgcls", dtype=jnp.float32)
    jgan = JGAN(num_classes=C, num_predicates=R, hidden_dim=8, n_ch=512,
                fmap_sz=FM, n_layers_G=2, largeD=True, vis_cond=True)
    sampled, pm = (jnp.asarray(x.numpy()) for x in edges)
    v_sgg = random_variables(types.SimpleNamespace(init=functools.partial(
        jm.init, fmap=jb.fmaps)), (None, jb.boxes, jb.classes,
                                   sampled[..., :2], pm), seed=25)
    v_gan = random_variables(types.SimpleNamespace(init=functools.partial(
        jgan.init, method=JGAN.init_all, vis_features=jnp.asarray(vis))),
        (jb.classes, jb.boxes / 128.0, jb.rels, jb.node_mask, jb.rel_mask),
        seed=26)
    ckw = dict(batch_size=B, max_nodes=N, max_edges=E, mode="sgcls",
               loss="dnorm", compute_dtype="float32", gan=True, clip=5.0,
               largeD=True, vis_cond="bank.hdf5")
    jcfg = JConfig(**ckw)
    want_g = {}
    sgg = create_train_state(jcfg, v_sgg)
    state = create_gan_state(jcfg, sgg.replace(
        tx=_recording(sgg.tx, "sgg", want_g)), v_gan)
    state = state.replace(g_tx=_recording(state.g_tx, "G", want_g),
                          d_tx=_recording(state.d_tx, "D", want_g))
    state, want = jmake_gan_step(jm, jgan, jcfg)(
        state, jb, jnp.asarray(fake), jnp.asarray(vis), key)
    jax.effects_barrier()

    tm = RelModelIMP(num_classes=C, num_predicates=R, hidden_dim=16,
                     obj_dim=32)
    tm.load_state_dict(variables_from_jax(v_sgg), strict=False)
    for mod in tm.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    tgan = GANModel(C, R, hidden_dim=8, n_ch=512, fmap_sz=FM, n_layers_G=2,
                    largeD=True, vis_cond=True)
    tgan.load_state_dict(variables_from_jax(v_gan), strict=True)
    cfg = Config(device="cpu", **ckw)
    opt = Optimizer(cfg, tm)
    g_opt, d_opt = create_gan_optimizers(cfg, tgan)
    got_g = {}
    for o, tag in ((opt, "sgg"), (g_opt, "G"), (d_opt, "D")):
        _record_port(o, tag, got_g)
    proj0 = tgan.G.proj.weight.detach().clone()
    got = make_gan_train_step(tm, tgan, cfg, opt, g_opt, d_opt)(
        tb, torch.from_numpy(fake), None, edges=edges,
        vis_features=torch.from_numpy(vis))

    assert set(got) == set(want)
    errs = {k: rel_err(float(got[k]), float(want[k])) for k in want}
    assert all(e <= (G_NORM_GATED if k == "grad_norm_G" else RTOL)
               for k, e in errs.items()), errs
    assert {k: len(v) for k, v in got_g.items()} == \
        {k: len(v) for k, v in want_g.items()} == {"sgg": 2, "G": 1, "D": 1}
    for tag, prefix in (("sgg", None), ("G", "G."), ("D", "D_")):
        for g, w in zip(got_g[tag], want_g[tag]):
            errs = _grad_errs(g, w, prefix)
            assert all(e <= GRAD_RTOL.get(p, G_GATED if tag == "G" else RTOL)
                       for p, e in errs.items()), (tag, errs)
    assert float(got_g["G"][0]["G.proj.weight"][:, :512].abs().sum()) > 0
    assert not torch.equal(tgan.G.proj.weight.detach(), proj0)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    for module, params, stats in ((tm, state.sgg.params,
                                   state.sgg.batch_stats),
                                  (tgan, state.gan_params, state.gan_stats)):
        ref = variables_from_jax({"params": to_np(params),
                                  "batch_stats": to_np(stats)})
        names = dict(module.named_parameters())
        for k, b in module.state_dict().items():
            if k not in names and not k.endswith("num_batches_tracked") \
                    and not k.startswith("trunk."):
                assert rel_err(b.numpy(), ref[k].numpy()) <= (
                    SN_RTOL if k.endswith(("u", "sigma")) else RTOL), k


# ---------------------------------------------------------------------------
IMG = 128  # an 8x8 map, the CRN's least


def _splits(**kw):
    return _SYNTHETIC(**{**dict(num_eval=4, image_size=IMG), **kw,
                         **dict(num_train=8, num_classes=C, num_predicates=R,
                                max_objects=6)})


_SYNTHETIC = sgg_torch.data.synthetic.synthetic_splits


def _write_bank(path, train, rows=3):
    """A bank for every class of ``train`` but the last: ``rows`` random
    (7, 7, 512) rows each."""
    rng = np.random.RandomState(27)
    w = FeatureBankWriter(str(path), (7, 7, 512))
    for name in train.ind_to_classes[1:-1]:
        w.append(name, np.maximum(rng.randn(rows, 7, 7, 512), 0))
    w.close()
    return str(path)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)
    monkeypatch.setattr(trainer_mod, "build_model", lambda config, td, *,
                        device="cuda", seed=0: init_weights(RelModelIMP(
                            num_classes=td.num_classes,
                            num_predicates=td.num_predicates,
                            mode=config.mode, hidden_dim=16, obj_dim=32),
                            seed).to(device).eval())
    monkeypatch.setattr(trainer_mod, "build_gan", lambda config, td, *,
                        device="cuda", seed=1: init_gan_weights(GANModel(
                            td.num_classes, td.num_predicates, embed_dim=16,
                            hidden_dim=8, fmap_sz=IMG // 16, n_layers_G=2,
                            largeD=config.largeD,
                            vis_cond=config.vis_cond is not None),
                            seed).to(device))


def _config(**kw):
    return Config(**{**dict(
        device="cpu", mode="sgcls", loss="dnorm", batch_size=4, max_nodes=8,
        max_edges=8, compute_dtype="float32", num_workers=1, gan=True,
        largeD=True, perturb="graphn", L=0.5, print_interval=1), **kw})


@pytest.mark.usefixtures("tiny")
def test_host_inputs_match_the_jax_trainer(tmp_path):
    """The perturbed classes and the bank's samples of them under the node
    mask, batch after batch, equal the JAX trainer's for the same bank
    file and seed (both banks from a fresh ``RandomState(seed)``: the JAX
    trainer's first draw shapes its initialization); the copy to a device
    keeps them."""
    splits = _splits()
    td = splits["train"]
    path = _write_bank(tmp_path / "bank.hdf5", td)
    cfg = _config(vis_cond=path, seed=5)
    t = Trainer(cfg, splits)
    assert t.feature_bank is not None and t.gan.G.vis_cond
    jt = JTrainer.__new__(JTrainer)  # the host-side state it reads
    jt.config = JConfig(**{k: v for k, v in vars(cfg).items()
                           if k not in ("device", "hostname")})
    jt.feature_bank = JBank(path, td.ind_to_classes, pool_sz=7, n_ch=512,
                            seed=cfg.seed)
    jt.perturber = JPerturb(
        cfg.perturb, jembed(td.ind_to_classes, wv_dir=cfg.data),
        td.subj_pred_pairs, td.pred_obj_pairs, L=cfg.L, topk=cfg.topk,
        alpha=cfg.graphn_a, uniform=cfg.uniform,
        degree_smoothing=cfg.degree_smoothing, seed=cfg.seed)
    loader = trainer_mod.BatchLoader(td, batch_size=4, max_nodes=8,
                                     max_edges=8, im_scale=IMG)
    n_vis = 0
    for epoch in (0, 1):
        for batch in loader:
            _, jfake, jvis = jt._gan_host_inputs(batch, epoch)
            item = t._gan_host_inputs(batch, epoch)
            np.testing.assert_array_equal(item.fake_classes, jfake)
            assert item.vis.dtype == np.float32
            np.testing.assert_array_equal(item.vis, jvis)
            n_vis += int(item.vis.any(axis=(2, 3, 4)).sum())
    assert n_vis > 0
    moved = item.to("cpu")
    assert isinstance(moved, GANBatch) and moved.vis.dtype == torch.float32
    assert torch.equal(moved.vis, torch.from_numpy(item.vis))
    assert moved.fake_classes.dtype == torch.int64


@pytest.mark.usefixtures("tiny")
def test_trainer_trains_the_conditioned_gan(tmp_path):
    splits = _splits()
    path = _write_bank(tmp_path / "bank.hdf5", splits["train"])
    t = Trainer(_config(vis_cond=path), splits)
    proj0 = t.gan.G.proj.weight.detach().clone()
    seen = []
    real = t.gan_step

    def step(*a, **kw):
        seen.append(kw["vis_features"])
        return real(*a, **kw)

    t.gan_step = step
    losses = t.train_epoch(0)
    for k in ("obj_loss", "G_obj", "G_fmap", "obj_loss_rec", "D_obj",
              "grad_norm_G", "grad_norm_D", "total"):
        assert np.isfinite(losses[k]), (k, losses)
    assert len(seen) == 2 and all(v.shape == (4, 8, 7, 7, 512)
                                  for v in seen)
    assert not torch.equal(t.gan.G.proj.weight.detach(), proj0)


ARGV = ["-m", "sgcls", "-loss", "dnorm", "-b", "4", "-gan", "-largeD",
        "-perturb", "graphn", "-L", "0.2", "-topk", "5", "-graphn_a", "2",
        "-split", "synthetic", "-device", "cpu", "-nepoch", "1",
        "-val_size", "4", "-p", "1", "-nwork", "1", "-max_nodes", "8",
        "-max_edges", "8"]


@pytest.mark.usefixtures("tiny")
def test_cli_trains_with_vis_cond(tmp_path, monkeypatch):
    monkeypatch.setattr(sgg_torch.data.synthetic, "synthetic_splits",
                        _splits)
    path = _write_bank(tmp_path / "bank.hdf5", _splits()["train"])
    run = str(tmp_path / "run")
    results = cli.main(ARGV + ["-vis_cond", path, "-save_dir", run])
    assert "sgcls/test_alls_R@100_GC" in results
    payload, epoch = ckpt.restore_payload(run)
    assert epoch == 0
    assert payload["gan"]["params"]["G.proj.weight"].shape == (8, 520, 1, 1)
    assert os.path.exists(os.path.join(run, "test_results.json"))


@pytest.mark.usefixtures("tiny")
def test_cli_vis_cond_without_h5py_fails_before_any_work(tmp_path,
                                                         monkeypatch):
    def no_splits(config):
        raise AssertionError("the splits were loaded")

    monkeypatch.setattr(cli, "load_splits", no_splits)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    with pytest.raises(ImportError, match="h5py"):
        cli.main(ARGV + ["-vis_cond", str(tmp_path / "features.hdf5")])
