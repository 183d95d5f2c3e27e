"""Port parity of the training step: ``sgg_torch.train.step.make_train_step``
against ``sgg_tpu.train.step.make_train_step`` on the CPU in f32, with the
same weights (``variables_from_jax``), the same batches and the same
sampled edges, and dropout off on both sides (the packages draw different
random bits). Also the union BatchNorm in train mode, and the float32
master weights of the bf16 model.

Tolerance: 1e-5 relative, per tensor, to its largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_tpu.models.backbone as jbackbone
from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.models.union_features import UnionBoxFeats as JUnion
from sgg_tpu.train.assign import sample_edges as jsample_edges
from sgg_tpu.train.state import create_train_state
from sgg_tpu.train.step import make_train_step as jmake_train_step
from sgg_torch.config import Config
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.models.backbone import Dropout
from sgg_torch.models.relhead import RelModelIMP
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from test_torch_models import random_variables

C, R, IMG, N, E, B = 9, 6, 64, 8, 12, 2
RTOL = 1e-5


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def assert_state_close(tm, jparams, jstats):
    """Every port parameter and BatchNorm statistic against the flax tree."""
    want = variables_from_jax({"params": jparams, "batch_stats": jstats})
    got = tm.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = rel_err(got[k].float().numpy(), w.numpy())
        assert err <= RTOL, (k, err)


def _data(seed=5, n=6):
    kw = dict(num_images=n, num_classes=C, num_predicates=R, max_objects=6,
              image_size=IMG, with_images=True, seed=seed)
    return JSynth(**kw), SyntheticSGGDataset(**kw)


def _no_flax_dropout(monkeypatch):
    monkeypatch.setattr(jbackbone.nn, "Dropout",
                        lambda rate, deterministic=None: (lambda x: x))


def _models(use_bias=True):
    jm = JModel(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                use_bias=use_bias, dtype=jnp.float32)
    js, _ = _data()
    jb = js.batch([0, 1], max_nodes=N, max_edges=E)
    sampled, pm = jsample_edges(jax.random.key(0), jb.rels, jb.rel_mask,
                                jb.node_mask, max_out=E)
    v = random_variables(jm, tuple(map(jnp.asarray, (
        jb.images, jb.boxes, jb.classes, sampled[..., :2], pm))), seed=7)
    tm = RelModelIMP(num_classes=C, num_predicates=R, hidden_dim=16,
                     obj_dim=32, use_bias=use_bias)
    tm.load_state_dict(variables_from_jax(v), strict=True)
    for mod in tm.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return jm, v, tm


# three steps, one LR boundary (steps=(0,) at 2 updates an epoch: the third
# update runs at lr * lr_decay); clip 0.05 is below every step's gradient
# norm here, 1e6 above it
@pytest.mark.parametrize("mode,loss,clip", [
    ("sgcls", "dnorm", 0.05), ("predcls", "dnorm-fgbg", 1e6)])
def test_three_train_steps_match_jax(monkeypatch, mode, loss, clip):
    _no_flax_dropout(monkeypatch)
    jm, v, tm = _models()
    kw = dict(mode=mode, loss=loss, batch_size=B, max_nodes=N, max_edges=E,
              compute_dtype="float32", lr=5e-3, clip=clip, steps=(0,),
              l2=1e-3)
    jcfg, cfg = JConfig(**kw), Config(device="cpu", **kw)
    jm = jm.clone(mode=mode)
    tm.mode = mode
    state = create_train_state(jcfg, v, steps_per_epoch=2)
    jstep = jmake_train_step(jm, jcfg)
    opt = Optimizer(cfg, tm, steps_per_epoch=2)
    step = make_train_step(tm, cfg, opt)
    js, ts = _data()
    norms = []
    for i in range(3):
        idx = [2 * i, 2 * i + 1]
        jb = js.batch(idx, max_nodes=N, max_edges=E)
        tb = ts.batch(idx, max_nodes=N, max_edges=E)
        key = jax.random.key(i)
        k_sample, _ = jax.random.split(key)  # as the JAX step splits it
        sampled, pm = jsample_edges(k_sample, jb.rels, jb.rel_mask,
                                    jb.node_mask, max_out=min(
                                        E, jcfg.rels_per_img))
        state, want = jstep(state, jb, key)
        got = step(tb, None, edges=(torch.from_numpy(np.array(sampled)),
                                    torch.from_numpy(np.array(pm))))
        assert set(got) == set(want)
        for k in want:
            assert rel_err(got[k].numpy(), want[k]) <= RTOL, (i, k)
        norms.append(float(want["grad_norm"]))
    assert (min(norms) > clip) if clip < 1 else (max(norms) < clip)
    assert opt.count == int(state.step) == 3
    assert_state_close(tm, jax.tree_util.tree_map(np.asarray, state.params),
                       jax.tree_util.tree_map(np.asarray, state.batch_stats))


def test_union_batchnorm_train_mode_matches_flax():
    """Train mode normalizes with the biased batch variance and moves the
    running statistics at momentum 0.01, as flax does (torch's own
    BatchNorm2d uses the unbiased variance and momentum 0.1)."""
    _, v, tm = _models()
    rng = np.random.RandomState(9)
    xy = rng.rand(B, 5, 2, 2) * IMG * 0.6
    pb = np.concatenate([xy, xy + rng.rand(B, 5, 2, 2) * 20 + 2],
                        -1).reshape(B, 5, 8).astype(np.float32)
    want, mutated = JUnion(dim=512, dtype=jnp.float32).apply(
        {"params": v["params"]["union_feats"],
         "batch_stats": v["batch_stats"]["union_feats"]}, jnp.asarray(pb),
        train=True, mutable=["batch_stats"])
    feats = tm.union_feats.train()
    got = feats(torch.from_numpy(pb))
    assert rel_err(got.detach().numpy(), want) <= RTOL
    errs = {f"{bn}.{ours}": rel_err(getattr(getattr(feats, bn), ours),
                                    mutated["batch_stats"][bn][theirs])
            for bn in ("bn1", "bn2")
            for ours, theirs in (("running_mean", "mean"),
                                 ("running_var", "var"))}
    assert max(errs.values()) <= 1e-6, errs


def test_bf16_model_keeps_float32_master_weights():
    """bf16 compute: the trunk is stored in bf16 (so K2 and K1 take their
    bf16 routes), every trainable parameter and momentum buffer is f32,
    and a train step moves the heads and leaves the trunk as it was."""
    _, v, tm = _models()
    tm.to_compute_dtype(torch.bfloat16)
    cfg = Config(device="cpu", mode="sgcls", loss="dnorm", batch_size=B,
                 max_nodes=N, max_edges=E, compute_dtype="bfloat16")
    opt = Optimizer(cfg, tm)
    for name, p in tm.named_parameters():
        assert p.dtype == (torch.bfloat16 if name.startswith("trunk.")
                           else torch.float32), name
        assert p.requires_grad == (not name.startswith("trunk.")), name
    assert all(b.dtype == torch.float32 for b in opt.state_dict().values())
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    _, ts = _data()
    metrics = make_train_step(tm, cfg, opt)(
        ts.batch([0, 1], max_nodes=N, max_edges=E),
        torch.Generator().manual_seed(0))
    values = {k: float(x) for k, x in metrics.items()}
    assert all(map(np.isfinite, values.values())), values
    after = tm.state_dict()
    # what bf16 storage would lose: most of fc6's changed elements round
    # back to their old bf16 value
    w0, w1 = before["roi_fmap.fc6.weight"], after["roi_fmap.fc6.weight"]
    changed = w1 != w0
    kept = w1.bfloat16() == w0.bfloat16()
    assert (kept & changed).sum() > 0.5 * changed.sum()
    for k, t in before.items():
        moved = not torch.equal(after[k], t)
        if k.startswith("trunk."):
            assert not moved, k
        elif k.endswith(("fc6.weight", "running_mean", "running_var")):
            assert moved, k
        assert after[k].dtype == t.dtype, k


def test_plain_kernel_versions_stay_differentiable_on_cpu():
    """On the CPU the wrappers take their plain versions, which autograd
    differentiates (on the card they refuse inputs that need a gradient,
    ``tests/test_torch_cuda.py``)."""
    from sgg_torch.ops.roi_align import roi_align
    from sgg_torch.ops.vgg_stem import vgg_conv1
    fmap = torch.randn(1, 5, 6, 8, requires_grad=True)
    boxes = torch.tensor([[[4.0, 2.0, 60.0, 50.0]]])
    roi_align(fmap, boxes, spatial_scale=1 / 16).sum().backward()
    assert fmap.grad is not None and fmap.grad.abs().sum() > 0
    w = torch.randn(3, 3, 3, 64, requires_grad=True)
    vgg_conv1(torch.randn(1, 7, 5, 3), w, torch.zeros(64)).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
