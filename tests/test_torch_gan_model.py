"""Port parity of the GAN's modules (``sgg_torch.models.gan``) against
``sgg_tpu.models.gan`` on the CPU in f32: the same flax variables (drawn
with numpy, so every leaf matters) go through the JAX module and, via
``sgg_torch.convert``, through the port's; the same seeded inputs.

Tolerance: 1e-5 relative, per tensor, to its largest magnitude (outputs,
running statistics, spectral-norm vectors); ``add_dummy_nodes`` and the
nearest upsampling are held exactly, the adaptive pool's bin matrices
exactly and its products within 1e-6 (the two libraries sum a bin in
their own order)."""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.models.gan import GANModel as JGAN
from sgg_tpu.models.gan import GraphTripleConvNet as JGCN
from sgg_tpu.models.gan import MaskedBatchNorm as JMBN
from sgg_tpu.models.gan import add_dummy_nodes as jadd_dummy_nodes
from sgg_tpu.models.gan import boxes_to_layout as jboxes_to_layout
from sgg_tpu.models.gan import masks_to_layout as jmasks_to_layout
from sgg_tpu.models.gan.crn import RefinementNetwork as JCRN
from sgg_tpu.models.gan.crn import _adaptive_pool_matrix as j_pool_matrix
from sgg_tpu.models.gan.crn import adaptive_avg_pool as jadaptive_avg_pool
from sgg_tpu.models.gan.crn import upsample_nearest as jupsample_nearest
from sgg_tpu.models.gan.discriminators import SNConv as JSNConv
from sgg_tpu.models.gan.gan import Generator as JGenerator
from sgg_torch.convert import variables_from_jax
from sgg_torch.models.gan import (GANModel, Generator, GraphTripleConvNet,
                                  MaskedBatchNorm, RefinementNetwork, SNConv,
                                  add_dummy_nodes, boxes_to_layout,
                                  masks_to_layout)
from sgg_torch.models.gan.crn import (_adaptive_pool_matrix,
                                      adaptive_avg_pool, upsample_nearest)
from test_torch_models import random_variables
from test_torch_resnet_fpn import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RTOL = 1e-5
C, P, B, N, E = 9, 6, 2, 5, 7


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(cls, variables, *args, **kw):
    """A port module loaded strictly from flax variables."""
    m = cls(*args, **kw)
    m.load_state_dict(variables_from_jax(variables), strict=True)
    return m


def assert_state_close(module, mutated, params):
    """Every buffer (running statistics, spectral-norm vectors) of the port
    module against the flax variables after the call."""
    want = variables_from_jax({"params": params, **mutated})
    got = module.state_dict()
    checked = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked") or k in dict(
                module.named_parameters()):
            continue
        assert rel_err(got[k].numpy(), w.numpy()) <= RTOL, k
        checked += 1
    assert checked > 0


def _graph(seed=0):
    """A padded scene-graph batch: classes, [0, 1] boxes, rels, masks (image
    1 has two padded nodes and three padded edges)."""
    rng = np.random.RandomState(seed)
    classes = rng.randint(1, C, (B, N)).astype(np.int32)
    xy = rng.rand(B, N, 2) * 0.6
    boxes = np.concatenate([xy, xy + rng.rand(B, N, 2) * 0.4 + 0.05],
                           -1).astype(np.float32)
    node_mask = np.ones((B, N), bool)
    node_mask[1, 3:] = False
    rels = np.stack([rng.randint(0, 3, (B, E)), rng.randint(0, 3, (B, E)),
                     rng.randint(0, P, (B, E))], -1).astype(np.int32)
    rel_mask = np.ones((B, E), bool)
    rel_mask[1, 4:] = False
    return classes, boxes, rels, node_mask, rel_mask


def _variables(jm, args, seed, **kw):
    """``random_variables`` of ``jm`` called with ``kw`` (a method, a
    flag)."""
    init = types.SimpleNamespace(init=functools.partial(jm.init, **kw))
    return random_variables(init, args, seed=seed)


# ---------------------------------------------------------------------------
def test_add_dummy_nodes_exact():
    args = _graph(1)
    want = jadd_dummy_nodes(*map(jnp.asarray, args))
    got = add_dummy_nodes(*map(_t, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].shape == (B, E + 2 * N, 3)


@pytest.mark.parametrize("n_in,n_out", [(37, 4), (37, 9), (13, 5),
                                        (8, 8), (37, 37)])
def test_resampling_helpers(n_in, n_out):
    rng = np.random.RandomState(n_in * 100 + n_out)
    np.testing.assert_array_equal(
        _adaptive_pool_matrix(n_in, n_out, torch.zeros(())).numpy(),
        j_pool_matrix(n_in, n_out))
    x = rng.randn(2, n_in, n_in + 2, 3).astype(np.float32)  # NHWC
    want = np.asarray(jadaptive_avg_pool(jnp.asarray(x), (n_out, n_out)))
    got = adaptive_avg_pool(_t(x).permute(0, 3, 1, 2),
                            (n_out, n_out)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # torch's legacy nearest rule, exactly
    up = (n_out, n_in + 3)
    want = np.asarray(jupsample_nearest(jnp.asarray(x), up))
    got = upsample_nearest(_t(x).permute(0, 3, 1, 2), up)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    np.testing.assert_array_equal(got.numpy(), torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), size=up, mode="nearest").numpy())


def test_masked_batchnorm_train_eval_and_statistics():
    rng = np.random.RandomState(2)
    x = (rng.randn(B, E, 12) * 3 + 1).astype(np.float32)
    x[1, 4:] = 1e3  # padding: must not bias the statistics
    mask = np.ones((B, E), bool)
    mask[1, 4:] = False
    jm = JMBN()
    v = _variables(jm, (jnp.asarray(x), jnp.asarray(mask)), seed=3,
                   train=True)
    tm = _port(MaskedBatchNorm, v, 12)
    want, mut = jax.jit(lambda v, x, m: jm.apply(
        v, x, m, train=True, mutable=["batch_stats"]))(v, x, mask)
    got = tm.train()(_t(x), _t(mask))
    assert rel_err(got.detach().numpy()[mask], np.asarray(want)[mask]) \
        <= RTOL
    assert_state_close(tm, mut, v["params"])
    want = jm.apply({**v, **mut}, x, mask, train=False)
    got = tm.eval()(_t(x), _t(mask))
    assert rel_err(got.detach().numpy(), want) <= RTOL


def test_gcn_train_mode_and_statistics():
    rng = np.random.RandomState(4)
    classes, boxes, rels, node_mask, rel_mask = _graph(4)
    obj = rng.randn(B, N, 14).astype(np.float32)
    pred = rng.randn(B, E, 10).astype(np.float32)
    edges = rels[..., :2]
    jm = JGCN(output_dim=6, num_layers=2, hidden_dim=8, batch_norm=True)
    args = tuple(map(jnp.asarray, (obj, pred, edges, node_mask, rel_mask)))
    v = _variables(jm, args, seed=5, train=True)
    tm = _port(GraphTripleConvNet, v, 14, 10, 6, num_layers=2, hidden_dim=8,
               batch_norm=True)
    (wo, wp), mut = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    go, gp = tm.train()(*map(_t, (obj, pred, edges.astype(np.int64),
                                  node_mask, rel_mask)))
    assert rel_err(go.detach().numpy()[node_mask],
                   np.asarray(wo)[node_mask]) <= RTOL
    assert rel_err(gp.detach().numpy()[rel_mask],
                   np.asarray(wp)[rel_mask]) <= RTOL
    assert_state_close(tm, mut, v["params"])


@pytest.mark.parametrize("pooling", ["sum", "avg"])
def test_layout(pooling):
    rng = np.random.RandomState(6)
    _, boxes, _, node_mask, _ = _graph(6)
    vecs = rng.randn(B, N, 7, 7, 4).astype(np.float32)
    want = jboxes_to_layout(jnp.asarray(vecs), jnp.asarray(boxes),
                            jnp.asarray(node_mask), 37, 29, pooling=pooling)
    got = boxes_to_layout(_t(vecs), _t(boxes), _t(node_mask), 37, 29,
                          pooling=pooling)
    assert got.shape == (B, 37, 29, 4)
    assert rel_err(got.numpy(), want) <= RTOL
    masks = (rng.rand(B, N, 5, 5) > 0.5).astype(np.float32)
    vec = rng.randn(B, N, 4).astype(np.float32)
    want = jmasks_to_layout(jnp.asarray(vec), jnp.asarray(boxes),
                            jnp.asarray(masks), jnp.asarray(node_mask), 11,
                            pooling=pooling)
    got = masks_to_layout(_t(vec), _t(boxes), _t(masks), _t(node_mask), 11,
                          pooling=pooling)
    assert rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("size", [37, 13])
def test_crn_train_mode_and_statistics(size):
    rng = np.random.RandomState(size)
    layout = rng.randn(B, size, size, 8).astype(np.float32)
    dims = (8, 8, 12, 16)
    jm = JCRN(dims=dims)
    v = _variables(jm, (jnp.asarray(layout),), seed=7, train=True)
    tm = _port(RefinementNetwork, v, dims)
    want, mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, layout)
    got = tm.train()(_t(layout))
    assert got.shape == (B, size, size, 16)
    assert rel_err(got.detach().numpy(), want) <= RTOL
    assert_state_close(tm, mut, v["params"])


def test_snconv_output_and_power_iteration():
    """Every call iterates once from the stored ``u``; only
    ``update_stats`` writes ``u`` and ``sigma``; the bias is not
    normalized; gradients flow through sigma."""
    rng = np.random.RandomState(8)
    x = rng.randn(3, 7, 7, 10).astype(np.float32)
    jm = JSNConv(features=6, kernel=3, padding=1)
    v = _variables(jm, (jnp.asarray(x),), seed=9, train=True)
    tm = _port(SNConv, v, 10, 6, 3, padding=1)
    xt = _t(x).permute(0, 3, 1, 2)
    for train in (False, True):
        want, mut = jax.jit(lambda v, x, t=train: jm.apply(
            v, x, train=t, mutable=["batch_stats"]))(v, x)
        u0 = tm.u.clone()
        got = tm(xt, update_stats=train).permute(0, 2, 3, 1)
        assert rel_err(got.detach().numpy(), want) <= RTOL
        assert torch.equal(tm.u, u0) != train
        assert_state_close(tm, mut, v["params"])
    # the weight gradient through sigma, against JAX's
    gx = rng.randn(3, 7, 7, 6).astype(np.float32)
    want = jax.grad(lambda p: (jm.apply({**v, **mut, "params": p}, x)
                               * gx).sum())(v["params"])
    tm.zero_grad()
    (tm(xt).permute(0, 2, 3, 1) * _t(gx)).sum().backward()
    want = variables_from_jax({"params": want})
    for k, p in tm.named_parameters():
        assert rel_err(p.grad.numpy(), want[k].numpy()) <= RTOL, k


@pytest.fixture(scope="module")
def gans():
    """JAX and port GANModels (n_ch 32, hidden 8, 2 GCN layers) with the
    same variables, largeD off and on, at a 37 map."""
    out = {}
    args = tuple(map(jnp.asarray, _graph(10)))
    for large in (False, True):
        jm = JGAN(num_classes=C, num_predicates=P, hidden_dim=8, n_ch=32,
                  fmap_sz=37, n_layers_G=2, largeD=large)
        v = _variables(jm, args, seed=11 + large, method=JGAN.init_all)
        tm = _port(GANModel, v, C, P, hidden_dim=8, n_ch=32, fmap_sz=37,
                   n_layers_G=2, largeD=large)
        out[large] = (jm, v, tm)
    return out


@pytest.mark.parametrize("size", [37, 11])
@pytest.mark.parametrize("large", [False, True], ids=["D", "largeD"])
def test_global_discriminator(gans, large, size):
    """``D_global`` on 37 (ceil pool, floor pools) and on an odd small map
    (pools skipped, 'same' 3x3 convs below 3), train and eval."""
    jm, v, tm = gans[large]
    tm = copy.deepcopy(tm)  # the train call writes its vectors
    rng = np.random.RandomState(size + large)
    x = np.abs(rng.randn(B, size, size, 32)).astype(np.float32)
    for train in (False, True):
        want, mut = jax.jit(lambda v, x, t=train: jm.apply(
            v, x, train=t, mutable=["batch_stats"],
            method=JGAN.disc_global))(v, x)
        got = tm.disc_global(_t(x), update_stats=train)
        assert got.shape == (B, 1)
        assert rel_err(got.detach().numpy(), want) <= RTOL
    assert_state_close(tm.D_global, {"batch_stats": mut["batch_stats"][
        "D_global"]}, v["params"]["D_global"])


def test_patch_discriminators(gans):
    jm, v, tm = gans[True]
    rng = np.random.RandomState(12)
    classes, _, rels, _, _ = _graph(12)
    nodes = rng.randn(B, N, 7, 7, 32).astype(np.float32)
    edges = rng.randn(B, E, 7, 7, 32).astype(np.float32)
    for method, feats, labels, port in (
            (JGAN.disc_nodes, nodes, classes, tm.disc_nodes),
            (JGAN.disc_edges, edges, rels[..., 2], tm.disc_edges)):
        want = jax.jit(lambda v, f, lb, m=method: jm.apply(
            v, f, lb, method=m))(v, feats, labels)
        got = port(_t(feats), _t(labels))
        assert got.shape == feats.shape[:2] + (1,)
        assert rel_err(got.detach().numpy(), want) <= RTOL


@pytest.mark.parametrize("init_embed", [False, True],
                         ids=["random", "init_embed"])
def test_generator_train_mode_and_statistics(init_embed):
    """The whole generator (embeddings, GCN with the dummy node, spatialize
    convs, projection, layout, CRN, ReLU) in train mode, its BatchNorm
    statistics after, with and without ``init_embed`` tables."""
    from sgg_torch.data.word_vectors import normalized_class_embeddings
    rng = np.random.RandomState(13)
    args = _graph(13)
    kw = dict(num_classes=C, num_predicates=P, hidden_dim=8, n_ch=32,
              fmap_sz=37, n_layers=2)
    if init_embed:
        kw["init_embed_objs"] = normalized_class_embeddings(
            [f"class {i}" for i in range(C)])
        kw["init_embed_rels"] = rng.randn(P, 200).astype(np.float32)
    jm = JGenerator(**kw)
    v = _variables(jm, tuple(map(jnp.asarray, args)), seed=14, train=True)
    if init_embed:  # the tables are the embeddings' initial values
        v["params"]["obj_embed"]["embedding"] = kw["init_embed_objs"]
        v["params"]["rel_embed"]["embedding"] = kw["init_embed_rels"]
    tm = _port(Generator, v, **kw)
    want, mut = jax.jit(lambda v, *a: jm.apply(
        v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    got = tm.train()(*map(_t, args))
    assert got.shape == (B, 37, 37, 32) and got.is_contiguous()
    assert rel_err(got.detach().numpy(), want) <= RTOL
    assert_state_close(tm, mut, v["params"])
    if init_embed:
        from sgg_torch.models.gan import init_gan_weights
        gan = init_gan_weights(GANModel(C, P, hidden_dim=8, n_ch=32,
                                        n_layers_G=2,
                                        init_embed_objs=kw["init_embed_objs"],
                                        init_embed_rels=kw["init_embed_rels"]),
                               0)
        np.testing.assert_array_equal(gan.G.obj_embed.weight.detach(),
                                      kw["init_embed_objs"])
        np.testing.assert_array_equal(gan.G.rel_embed.weight.detach(),
                                      kw["init_embed_rels"])
