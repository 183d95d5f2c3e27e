"""Port parity of the GAN training step: ``sgg_torch.train.gan_step.
make_gan_train_step`` against ``sgg_tpu.train.gan_step.make_gan_train_step``
on the CPU in f32, with the same weights (``variables_from_jax``), the same
feature-cache batch (the trunk's maps given, ``images=None``), the same
perturbed classes, the same sampled edges and dropout off on both sides
(the packages draw different random bits).

Held, in the ``ganlosses`` cases ``D_G_rec`` (two steps), ``G_rec``, ``D``
and ``D_G_rec`` with ``attachG``: every metric; the gradients each
optimizer receives (the SGG's of the F phase and of ``rec``, G's and the
Ds'), by part in norm; after the step the SGG parameters and BatchNorm
statistics, G's BatchNorm statistics and the Ds' spectral-norm vectors.
The Adam-updated GAN parameters are not held element by element: with
``beta1=0`` Adam's first update is about ``sign(g) * lr``, and a gradient
near 0 in both packages may take either sign. Measured after one step: up
to 341 elements a tensor apart by up to 2 lr, nearly all the biases before
train-mode BatchNorms, whose gradient the BatchNorm cancels; the second
step's ``grad_norm_D`` then differs by 1.3e-4. So the port takes the JAX
step's updated GAN parameters before the second step (its own moments,
BatchNorm statistics and spectral-norm vectors carry over), and its Adam is
held against ``optax.adam`` bit for bit on given gradients instead.

Tolerance: 1e-5 relative (metrics and tensors to their largest magnitude,
gradients by part in norm), but 1e-4 for the gradient of the relation
model's ``union_feats``: it passes backward through a train-mode BatchNorm
over 1x1 maps, where float32 cancels; measured against a float64 JAX
reference, the port's float32 is 2.6e-5 to 3.0e-5 off and JAX's 6.5e-6 to
7.4e-6 (every tensor before ``bn2``). And in the second step 1e-2 for the
gradients of the patch Ds' first two convs and 1e-3 for ``grad_norm_D``:
units of ``D_edges``' first conv have pre-activations within float32
rounding of 0 there (the smallest 1.9e-7), whose ReLUs gate differently in
the two packages, and the second conv reads their output (measured on one
thread: 6.2e-3 and 6.6e-3 of those convs' gradients in norm, the later
layers within 2e-6; ``grad_norm_D`` 1.3e-4). Adam moves those convs apart
in turn, so their spectral-norm vectors after the second step get 1e-3
(measured: ``u`` 2.7e-4, ``sigma`` 2.0e-5; every other vector within
3.2e-6). Every spectral-norm vector after a step gets 1e-4
(``SN_RTOL``): it is iterated from the Adam-updated D weights, which the
sign flips above move by up to 2 lr (measured up to 1.6e-5, on
``D_global``'s fifth conv after a step from images)."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgg_tpu.models.backbone as jbackbone
from sgg_tpu.config import Config as JConfig
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.models.gan import GANModel as JGAN
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.train.assign import sample_edges as jsample_edges
from sgg_tpu.train.gan_step import create_gan_state
from sgg_tpu.train.gan_step import make_gan_train_step as jmake_gan_step
from sgg_tpu.train.state import create_train_state
from sgg_torch.config import Config
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.models.backbone import Dropout
from sgg_torch.models.gan import GANModel
from sgg_torch.models.relhead import RelModelIMP
from sgg_torch.train.gan_step import (create_gan_optimizers,
                                      make_gan_train_step)
from sgg_torch.train.state import Adam, Optimizer
from test_torch_models import random_variables
from test_torch_resnet_fpn import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-5
GRAD_RTOL = {"union_feats": 1e-4}  # see the module docstring
SN_RTOL = 1e-4  # the spectral-norm vectors after a step: see the docstring
# the second step's first patch-D convs and grad_norm_D: see the docstring
GATED_RTOL = {**{f"{d}.SNConv_{i}": 1e-2 for d in ("D_nodes", "D_edges")
                 for i in (0, 1)}, "grad_norm_D": 1e-3}
C, R, B, N, E, FM = 9, 6, 2, 6, 10, 8  # FM: the map's side (128 px / 16)
CASES = {"D_G_rec": dict(ganlosses=("D", "G", "rec")),
         "G_rec": dict(ganlosses=("G", "rec")),
         "D": dict(ganlosses=("D",)),
         "attachG": dict(ganlosses=("D", "G", "rec"), attachG=True)}


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _variables(init, args, seed):
    return random_variables(types.SimpleNamespace(init=init), args, seed)


def _batches(n_steps):
    """Per step the JAX and the port feature-cache batch (maps drawn with
    numpy, ReLU-like), the perturbed classes and the sampled edges."""
    kw = dict(num_images=2 * n_steps, num_classes=C, num_predicates=R,
              max_objects=5, image_size=128, with_images=True, seed=3)
    js, ts = JSynth(**kw), SyntheticSGGDataset(**kw)
    rng = np.random.RandomState(4)
    out = []
    for i in range(n_steps):
        idx = [2 * i, 2 * i + 1]
        fmaps = np.maximum(rng.randn(B, FM, FM, 512), 0).astype(np.float32)
        jb = dataclasses.replace(js.batch(idx, max_nodes=N, max_edges=E),
                                 images=None, fmaps=jnp.asarray(fmaps))
        tb = dataclasses.replace(ts.batch(idx, max_nodes=N, max_edges=E),
                                 images=None, fmaps=fmaps)
        fake = np.array(jb.classes)
        mask = np.asarray(jb.node_mask)
        fake[mask] = fake[mask] % (C - 1) + 1  # every valid node perturbed
        key = jax.random.key(10 + i)
        k_sample = jax.random.split(key, 3)[0]  # as the JAX step splits it
        sampled, pm = jsample_edges(k_sample, jb.rels, jb.rel_mask,
                                    jb.node_mask, max_out=E)
        out.append((jb, tb, fake, key, (torch.from_numpy(np.array(sampled)),
                                         torch.from_numpy(np.array(pm)))))
    return out


def _recording(tx, tag, log):
    """``tx`` that hands the gradients it receives to the host, in program
    order."""
    def update(grads, state, params=None):
        jax.debug.callback(
            lambda g: log.setdefault(tag, []).append(
                jax.tree_util.tree_map(np.asarray, g)), grads, ordered=True)
        return tx.update(grads, state, params)
    return optax.GradientTransformation(tx.init, update)


def _record_port(opt, tag, log):
    real = opt.apply_gradients

    def apply():
        log.setdefault(tag, []).append({
            n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().clone() for n, p in opt.named})
        return real()
    opt.apply_gradients = apply


@functools.lru_cache(maxsize=None)
def _setup():
    """JAX and port models (tiny relation model, GAN with n_ch 512 and
    largeD) with the same random variables."""
    jm = JModel(num_classes=C, num_predicates=R, hidden_dim=16, obj_dim=32,
                mode="sgcls", dtype=jnp.float32)
    jgan = JGAN(num_classes=C, num_predicates=R, hidden_dim=8, n_ch=512,
                fmap_sz=FM, n_layers_G=2, largeD=True)
    jb, _, fake, _, (sampled, pm) = _batches(1)[0]
    v_sgg = _variables(functools.partial(jm.init, fmap=jb.fmaps), (
        None, jb.boxes, jb.classes, jnp.asarray(sampled.numpy()[..., :2]),
        jnp.asarray(pm.numpy())), seed=7)
    v_gan = _variables(functools.partial(jgan.init, method=JGAN.init_all), (
        jb.classes, jb.boxes / 128.0, jb.rels, jb.node_mask, jb.rel_mask),
        seed=8)
    return jm, jgan, v_sgg, v_gan


def _port_models():
    jm, jgan, v_sgg, v_gan = _setup()
    tm = RelModelIMP(num_classes=C, num_predicates=R, hidden_dim=16,
                     obj_dim=32)
    missing, unexpected = tm.load_state_dict(variables_from_jax(v_sgg),
                                             strict=False)
    assert not unexpected and missing and all(
        k.startswith("trunk.") for k in missing)
    for mod in tm.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    tgan = GANModel(C, R, hidden_dim=8, n_ch=512, fmap_sz=FM, n_layers_G=2,
                    largeD=True)
    tgan.load_state_dict(variables_from_jax(v_gan), strict=True)
    return tm, tgan


def _config_kw(case):
    return dict(batch_size=B, max_nodes=N, max_edges=E, mode="sgcls",
                loss="dnorm", compute_dtype="float32", gan=True, clip=5.0,
                **CASES[case])


@functools.lru_cache(maxsize=None)
def _jax_run(case, n_steps):
    """The JAX step's metrics, received gradients and final state."""
    jm, jgan, v_sgg, v_gan = _setup()
    cfg = JConfig(**_config_kw(case))
    log = {}
    sgg = create_train_state(cfg, v_sgg)
    sgg = sgg.replace(tx=_recording(sgg.tx, "sgg", log))
    state = create_gan_state(cfg, sgg, v_gan)
    state = state.replace(g_tx=_recording(state.g_tx, "G", log),
                          d_tx=_recording(state.d_tx, "D", log))
    with pytest.MonkeyPatch.context() as mp:  # dropout off while tracing
        mp.setattr(jbackbone.nn, "Dropout",
                   lambda rate, deterministic=None: (lambda x: x))
        step = jmake_gan_step(jm, jgan, cfg)
        metrics, gan_params = [], []
        to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
        for jb, _, fake, key, _ in _batches(n_steps):
            state, m = step(state, jb, jnp.asarray(fake), None, key)
            metrics.append({k: float(v) for k, v in m.items()})
            gan_params.append(to_np(state.gan_params))
    jax.effects_barrier()
    return (metrics, log, to_np(state.sgg.params),
            to_np(state.sgg.batch_stats), to_np(state.gan_stats),
            gan_params)


def _port_run(case, n_steps, gan_params=()):
    """The port's run; before each later step the GAN takes the JAX run's
    parameters after the step before (``gan_params``)."""
    tm, tgan = _port_models()
    cfg = Config(device="cpu", **_config_kw(case))
    opt = Optimizer(cfg, tm)
    g_opt, d_opt = create_gan_optimizers(cfg, tgan)
    log = {}
    for o, tag in ((opt, "sgg"), (g_opt, "G"), (d_opt, "D")):
        _record_port(o, tag, log)
    step = make_gan_train_step(tm, tgan, cfg, opt, g_opt, d_opt)
    metrics = []
    for i, (_, tb, fake, _, edges) in enumerate(_batches(n_steps)):
        if i:
            with torch.no_grad():
                for k, v in variables_from_jax(
                        {"params": gan_params[i - 1]}).items():
                    tgan.get_parameter(k).copy_(v)
        m = step(tb, torch.from_numpy(fake), None, edges=edges)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, log, tm, tgan


def _part(name: str) -> str:
    """A parameter's part: the relation model's top module; G's and the
    Ds' second (``G.gcn``, ``D_edges.SNConv_0``)."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0][0] in "GD" else parts[0]


def _grad_errs(got, want_tree, prefix=None):
    """Per part, ||got - want|| / ||want|| over the port's names."""
    want = variables_from_jax({"params": want_tree})
    diff, ref = {}, {}
    for name, g in got.items():
        if prefix and not name.startswith(prefix):
            continue
        w = want[name].double()
        p = _part(name)
        diff[p] = diff.get(p, 0.0) + float((g.double() - w).square().sum())
        ref[p] = ref.get(p, 0.0) + float(w.square().sum())
    assert diff
    return {p: (diff[p] / max(ref[p], 1e-30)) ** 0.5 for p in diff}


@pytest.mark.parametrize("case,n_steps", [("D_G_rec", 2), ("G_rec", 1),
                                          ("D", 1), ("attachG", 1)])
def test_gan_steps_match_jax(case, n_steps):
    want_m, want_g, w_params, w_stats, w_gan_stats, w_gan_params = \
        _jax_run(case, n_steps)
    got_m, got_g, tm, tgan = _port_run(case, n_steps, w_gan_params)
    w_gan_params = w_gan_params[-1]
    losses = set(CASES[case]["ganlosses"])
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        assert set(g) == set(w), (i, sorted(g), sorted(w))
        assert ("G_obj" in g) == ("G" in losses)
        assert ("obj_loss_rec" in g) == ("rec" in losses)
        assert ("grad_norm_D" in g) == ("D" in losses)
        errs = {k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w}
        tol = {k: GATED_RTOL.get(k, RTOL) if i == 1 else RTOL for k in w}
        assert all(errs[k] <= tol[k] for k in w), (i, sorted(errs.items()))

    # the gradients each optimizer received, in order, by part
    assert {k: len(v) for k, v in got_g.items()} == \
        {k: len(v) for k, v in want_g.items()}
    for tag, prefix in (("sgg", None), ("G", "G."), ("D", "D_")):
        for i, (g, w) in enumerate(zip(got_g.get(tag, []),
                                       want_g.get(tag, []))):
            errs = _grad_errs(g, w, prefix)
            tol = {**GRAD_RTOL, **(GATED_RTOL if (tag, i) == ("D", 1)
                                   else {})}
            assert all(e <= tol.get(p, RTOL) for p, e in errs.items()
                       ), (tag, i, errs)

    # SGG parameters and statistics, G's statistics, the Ds' vectors
    want = variables_from_jax({"params": w_params, "batch_stats": w_stats})
    got = tm.state_dict()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert rel_err(got[k].numpy(), w.numpy()) <= RTOL, k
    want = variables_from_jax({"params": w_gan_params,
                               "batch_stats": w_gan_stats})
    params = dict(tgan.named_parameters())
    for k, b in tgan.state_dict().items():
        if k in params or k.endswith("num_batches_tracked"):
            continue
        gated = n_steps == 2 and k.rsplit(".", 1)[0] in GATED_RTOL
        tol = 1e-3 if gated else SN_RTOL if k.endswith(("u", "sigma")) \
            else RTOL
        assert rel_err(b.numpy(), want[k].numpy()) <= tol, k
    # what moved: G with G or rec, the Ds with D (both packages)
    _, _, v_sgg, v_gan = _setup()
    start = variables_from_jax(v_gan)
    moved = {p: not torch.equal(t.detach(), start[n])
             for n, t in tgan.named_parameters() for p in [n.split(".")[0]]}
    for prefix, on in (("G", bool(losses & {"G", "rec"})),
                       ("D_", "D" in losses)):
        for n, t in tgan.named_parameters():
            if n.startswith(prefix):
                assert (not torch.equal(t.detach(), start[n])) == on, n
                assert (not np.array_equal(want[n].numpy(),
                                           start[n].numpy())) == on, n
    assert moved


def test_dropout_masks_repeat_for_both_fake_forwards():
    """With dropout on, the detached ``rec`` forward draws the same masks
    as the fake forward before it, as the JAX step gives both one key; its
    running statistics are left as they were."""
    tm, tgan = _port_models()
    for mod in tm.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.5
    cfg = Config(device="cpu", **_config_kw("G_rec"))
    opt = Optimizer(cfg, tm)
    g_opt, d_opt = create_gan_optimizers(cfg, tgan)
    seen = []
    real_forward = tm.forward

    def forward(*a, **kw):
        out = real_forward(*a, **kw)
        seen.append((kw["fmap"] is not None and not kw["fmap"].requires_grad,
                     out["rel_logits"].detach().clone(),
                     tm.union_feats.bn1.running_mean.clone()))
        return out

    tm.forward = forward
    step = make_gan_train_step(tm, tgan, cfg, opt, g_opt, d_opt)
    _, tb, fake, _, edges = _batches(1)[0]
    step(tb, torch.from_numpy(fake), torch.Generator().manual_seed(0),
         edges=edges)
    # F, the fake forward (attached map), the rec forward (detached map)
    assert len(seen) == 3 and [s[0] for s in seen[1:]] == [False, True]
    torch.testing.assert_close(seen[2][1], seen[1][1], rtol=1e-6, atol=1e-6)
    assert torch.equal(tm.union_feats.bn1.running_mean, seen[1][2])
    assert not torch.equal(seen[1][2], seen[0][2])


@pytest.mark.parametrize("b1,b2", [(0.0, 0.9), (0.5, 0.999)])
def test_adam_matches_optax_bitwise(b1, b2):
    """``Adam`` against ``optax.adam`` on the same gradients over four
    updates (one tensor's gradient zero in one, missing in another, which
    optax sees as zero): the same parameters, moments and count, bit for
    bit, and the gradients' global norm (1e-6: summed in another order)."""
    rng = np.random.RandomState(int(b2 * 1000))
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 3, 3, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-6, 2)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(4)]
    grads[2]["b"][:] = 0.0
    missing = (3, "a")
    grads[3]["a"][:] = 0.0
    tx = optax.adam(3e-4, b1=b1, b2=b2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    # op by op: jitted, XLA fuses (1 - b2) g^2 + b2 nu into one FMA
    update = tx.update
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    adam = Adam(sorted(tp.items()), 3e-4, b1, b2)
    for i, g in enumerate(grads):
        u, js = update(g, js, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = None if (i, k) == missing else torch.from_numpy(g[k])
        norm = float(adam.apply_gradients())
        want = float(optax.global_norm(g))
        assert abs(norm - want) <= 1e-6 * want
    state = adam.state_dict()
    assert int(state["count"]) == int(js[0].count) == 4
    for k, p in tp.items():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(state["mu"][k].numpy(),
                                      np.asarray(js[0].mu[k]))
        np.testing.assert_array_equal(state["nu"][k].numpy(),
                                      np.asarray(js[0].nu[k]))
