"""Port parity of the ResNet50-FPN modules and the ``raw_boxes`` ops, f32 on
the CPU: ``sgg_torch`` against ``sgg_tpu`` on the same numpy draws, every
flax leaf (BatchNorm statistics included: means ~0.1, variances in
0.5-1.5) drawn from a seed and carried over by ``sgg_torch.convert`` with
``strict=True``.

* ``scale_boxes_01``, ``box01_extents`` and ``paint_weights`` exactly
  (zero extents included);
* ``ResNet50FPN`` on a 144 px canvas, whose C4 (9) and C5 (5) make the
  top-down upsampling inexact (a wrong nearest rule shows there), every
  level within 1e-4 of its largest value; ``pool`` alone equals the full
  pyramid's; the level shapes at 592 px;
* ``roi_level_assignment`` exactly, boxes on the level boundaries and of
  zero area included;
* ``multiscale_roi_align`` and its VJP in the maps and the boxes within
  1e-5 of the largest;
* ``RelModelIMP(backbone="resnet50")``: logits within 1e-4 (atol and rtol)
  in predcls and sgcls, with and without deduplicated unions, from images
  and in mode sgdet from a stride-64 map.

The JAX references are computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.models.resnet import ResNet50FPN as JResNet
from sgg_tpu.models.resnet import multiscale_roi_align as jmsra
from sgg_tpu.models.resnet import roi_level_assignment as jlevels
from sgg_tpu.ops import boxes as jboxes
from sgg_tpu.ops import grid_sample as jgrid
from sgg_tpu.train.assign import all_pairs as jall_pairs
from sgg_torch.convert import variables_from_jax
from sgg_torch.models import resnet as tres
from sgg_torch.models.relhead import RelModelIMP
from sgg_torch.ops import boxes as tboxes
from sgg_torch.ops import grid_sample as tgrid
from test_torch_models import random_variables

IMG, B, N = 144, 2, 5
C, R, HID, OBJ = 9, 6, 16, 32
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def one_thread():
    """PyTorch on one CPU thread while a ResNet50 test runs: the suite runs
    several workers on the machine's cores, and ResNet50's convolutions
    with every worker's full thread pool oversubscribe them (a test of 3 s
    alone took 158 s among six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


def _t(x):
    return torch.from_numpy(np.array(x))


def resnet_variables(jm, args, seed):
    """``random_variables`` with each bottleneck's last BatchNorm scale
    (``bn3``) drawn around 0.2 instead of 1, as a trained ResNet's are
    small: with a residual branch as large as its input, the activations
    double block after block (the pyramid reaches ~4e4 over the 16 blocks,
    ~50 with these) and f32 rounding in the 12,544-wide heads grows with
    them."""
    v = random_variables(jm, args, seed=seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a * np.float32(0.2) if jax.tree_util.keystr(p).endswith(
            "['bn3']['scale']") else a, v)


def _rel(x, want):
    return float(np.abs(np.asarray(x) - want).max() / np.abs(want).max())


# -- the raw_boxes ops ------------------------------------------------------

def test_scale_boxes_01_matches_jax():
    rng = np.random.RandomState(0)
    boxes = (rng.rand(3, 7, 4) * 600).astype(np.float32)
    hw = rng.randint(200, 600, (3, 2)).astype(np.float32)
    want = np.asarray(jboxes.scale_boxes_01(jnp.asarray(boxes),
                                            jnp.asarray(hw)))
    got = tboxes.scale_boxes_01(_t(boxes), _t(hw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_dim,in_dim", [(27, 27), (37, 9), (13, 5)])
def test_paint_weights_match_jax(out_dim, in_dim):
    rng = np.random.RandomState(out_dim)
    b = rng.rand(4, 6, 4).astype(np.float32)
    b[..., 2:] = np.minimum(b[..., :2] + b[..., 2:] * 0.6, 1.2)
    b[0, 0, 2] = b[0, 0, 0]  # a zero width
    b[0, 1, 3] = b[0, 1, 1]  # a zero height
    b[1, 0] = [-0.2, 0.3, 0.5, 1.4]  # partly outside [0, 1]
    want = jgrid.box01_extents(jnp.asarray(b))
    got = tgrid.box01_extents(_t(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for s, e in ((0, 2), (1, 3)):
        w = np.asarray(jgrid.paint_weights(want[s], want[e], out_dim,
                                           in_dim))
        g = tgrid.paint_weights(got[s], got[e], out_dim, in_dim).numpy()
        np.testing.assert_array_equal(g, w)
        assert w.shape == (4, 6, out_dim, in_dim) and w.any()


# -- the backbone -----------------------------------------------------------

@pytest.fixture(scope="module")
def backbone():
    x = np.random.RandomState(1).randn(B, IMG, IMG, 3).astype(np.float32)
    jm = JResNet(dtype=jnp.float32)
    v = random_variables(jm, (jnp.asarray(x),), seed=2)
    want = {k: np.asarray(a) for k, a in jax.jit(jm.apply)(
        v, jnp.asarray(x)).items()}
    tm = tres.ResNet50FPN()
    tm.load_state_dict(variables_from_jax(v), strict=True)
    return x, v, want, tm.eval()


def test_batch_stats_are_drawn_not_initial(backbone):
    _, v, _, _ = backbone
    bn = v["batch_stats"]["body"]["layer3_2"]["bn2"]
    assert 0.05 < np.abs(bn["mean"]).mean() < 0.2
    assert 0.5 <= bn["var"].min() and bn["var"].max() <= 1.5
    assert np.abs(v["params"]["body"]["layer3_2"]["bn2"]["scale"]
                  - 1.0).max() > 0.1


def test_resnet50_fpn_levels_match_jax(backbone):
    x, _, want, tm = backbone
    with torch.no_grad():
        got = tm(_t(x))
        pool = tm.pool(_t(x))
    assert set(got) == set(want) == set(tres.LEVELS)
    sides = {"p2": 36, "p3": 18, "p4": 9, "p5": 5, "pool": 3}
    for k, w in want.items():
        assert got[k].shape == w.shape == (B, sides[k], sides[k], 256), k
        err = _rel(got[k].numpy(), w)
        print(f"{k}: {err:.3g} of the largest {np.abs(w).max():.4g}")
        assert err <= 1e-4, k
    np.testing.assert_array_equal(pool.numpy(), got["pool"].numpy())


def test_resnet50_fpn_vjp_matches_jax_in_float64(backbone):
    """The backbone's gradient in every parameter for a random cotangent on
    every level, both packages in float64: in float32 a ReLU whose input
    lies within rounding of 0 passes its gradient in one package and not in
    the other (on these draws such units move ``layer3_2.conv1``'s
    gradient by 3% of its size), which no tolerance separates from a
    fault; in float64 none lies that close."""
    x, v, want, _ = backbone
    cot = {k: np.random.RandomState(5).randn(*w.shape) for k, w in
           want.items()}
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        jm = JResNet(dtype=jnp.float64)

        def f(params):
            o = jm.apply({"params": params,
                          "batch_stats": v64["batch_stats"]},
                         jnp.asarray(x, jnp.float64))
            return sum((o[k] * cot[k]).sum() for k in o)

        grads = jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(f))(v64["params"]))
    jg = variables_from_jax({"params": grads})
    tm = tres.ResNet50FPN()
    tm.load_state_dict(variables_from_jax(v), strict=True)
    tres.set_compute_dtype(tm.double(), torch.float64, store=False)
    out = tm(_t(x).double())
    sum((out[k] * _t(c)).sum() for k, c in cot.items()).backward()
    # (convert stores JAX's gradients in float32: 6e-8 of rounding)
    errs = {n: _rel(p.grad.numpy(), jg[n].double().numpy())
            for n, p in tm.named_parameters()}
    worst = max(errs, key=errs.get)
    print(f"ResNet50-FPN VJP vs JAX (f64): worst {worst} {errs[worst]:.3g}")
    assert errs[worst] <= 1e-6, worst


def test_nearest_upsampling_is_jax_nearest():
    """19 -> 37, the C5 -> C4 step at 592 px: torch's ``nearest-exact``
    picks the rows ``jax.image.resize(method="nearest")`` picks, where
    ``nearest`` differs at 9 of 37."""
    src = np.arange(19, dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(src)[:, None], (37, 1),
                                       "nearest"))[:, 0]
    up = lambda mode: torch.nn.functional.interpolate(  # noqa: E731
        _t(src)[None, None, :, None], size=(37, 1), mode=mode)[0, 0, :, 0]
    np.testing.assert_array_equal(up("nearest-exact").numpy(), want)
    assert (up("nearest").numpy() != want).sum() == 9


def test_level_shapes_at_592_match_jax():
    x = np.zeros((1, 592, 592, 3), np.float32)
    want = jax.eval_shape(JResNet(dtype=jnp.float32).init_with_output,
                          jax.random.key(0), jnp.asarray(x))[0]
    with torch.no_grad():
        got = tres.ResNet50FPN()(_t(x))
    sides = {"p2": 148, "p3": 74, "p4": 37, "p5": 19, "pool": 10}
    for k, side in sides.items():
        assert tuple(got[k].shape) == want[k].shape == (1, side, side, 256)


# -- level assignment and MultiScaleRoIAlign ---------------------------------

def _fpn_boxes(seed, R_=40, canvas=IMG):
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, R_, 2) * canvas * 0.8
    wh = np.exp(rng.rand(B, R_, 2) * np.log(canvas * 4.0))  # 1 px .. 4x
    b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # the level boundaries (sqrt(wh) = 112, 224, 448) and their neighbours
    for i, s in enumerate((112.0, 224.0, 448.0, 111.99, 224.01, 447.9)):
        b[:, i] = [10.0, 5.0, 10.0 + s, 5.0 + s]
    b[:, 6] = [20.0, 20.0, 20.0, 20.0]   # zero area
    b[:, 7] = [50.0, 40.0, 30.0, 20.0]   # inverted
    b[:, 8] = [0.0, 0.0, 56.0, 224.0]    # sqrt(w h) = 112, not square
    return b


def test_roi_level_assignment_matches_jax():
    b = _fpn_boxes(3, R_=200, canvas=600)
    want = np.asarray(jlevels(jnp.asarray(b)))
    got = tres.roi_level_assignment(_t(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert list(got[0, :9]) == [1, 2, 3, 0, 2, 2, 0, 0, 1]
    assert set(np.unique(got)) == {0, 1, 2, 3}


def test_multiscale_roi_align_and_its_vjp_match_jax():
    rng = np.random.RandomState(4)
    strides = (4, 8, 16, 32)
    maps = [rng.randn(B, IMG // s, IMG // s, 8).astype(np.float32)
            for s in strides]
    boxes = _fpn_boxes(5)
    g = rng.randn(B, boxes.shape[1], 7, 7, 8).astype(np.float32)

    want, vjp = jax.vjp(lambda ms, b: jmsra(ms, b, strides),
                        [jnp.asarray(m) for m in maps], jnp.asarray(boxes))
    want_maps, want_boxes = vjp(jnp.asarray(g))
    tmaps = [_t(m).requires_grad_() for m in maps]
    tb = _t(boxes).requires_grad_()
    got = tres.multiscale_roi_align(tmaps, tb, strides)
    got.backward(_t(g))
    errs = {"value": _rel(got.detach().numpy(), np.asarray(want)),
            "boxes": _rel(tb.grad.numpy(), np.asarray(want_boxes))}
    for lvl, (m, w) in enumerate(zip(tmaps, want_maps)):
        errs[f"map {lvl}"] = _rel(m.grad.numpy(), np.asarray(w))
        assert np.abs(np.asarray(w)).max() > 0, lvl  # every level used
    print("multiscale_roi_align vs JAX: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()))
    assert max(errs.values()) <= 1e-5, errs


# -- the relation model on the ResNet50-FPN ---------------------------------

def _graph(seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, N, 2) * IMG * 0.6
    wh = rng.rand(B, N, 2) * IMG * 0.5 + 16
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(
        np.float32)
    classes = rng.randint(1, C, (B, N)).astype(np.int32)
    node_mask = np.ones((B, N), bool)
    node_mask[1, 3:] = False
    images = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    pairs, pm = jall_pairs(jnp.asarray(node_mask))
    return images, boxes, classes, np.array(pairs), np.array(pm)


REL_KW = dict(num_classes=C, num_predicates=R, hidden_dim=HID, obj_dim=OBJ,
              use_bias=True, backbone="resnet50")


@pytest.fixture(scope="module")
def relmodel():
    images, boxes, classes, pairs, pm = _graph()
    jm = JModel(dtype=jnp.float32, **REL_KW)
    v = resnet_variables(jm, tuple(map(jnp.asarray, (images, boxes, classes,
                                                     pairs, pm))), seed=6)
    tm = RelModelIMP(**REL_KW)
    tm.load_state_dict(variables_from_jax(v), strict=True)
    return jm, v, tm.eval()


def test_resnet_relation_model_shapes(relmodel):
    _, v, tm = relmodel
    assert tm.stride == 64 and tm.union_feats.dim == 256
    assert tm.roi_fmap.fc6.in_features == 7 * 7 * 256
    assert tm.roi_fmap.with_final_relu and tm.roi_fmap_obj.with_final_relu
    assert tm.roi_fmap.drop.p == tm.roi_fmap_obj.drop.p == 0.0
    assert "trunk" in v["params"] and not any(
        p.requires_grad for p in tm.trunk.parameters())


@pytest.mark.parametrize("mode,dedup", [("sgcls", False), ("sgcls", True),
                                        ("predcls", True),
                                        ("predcls", False)])
def test_resnet_relation_model_matches_jax(relmodel, mode, dedup):
    jm, v, tm = relmodel
    args = _graph(seed=7)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, mode=mode,
                                          dedup_unions=dedup))(
        v, *map(jnp.asarray, args))
    images, boxes, classes, pairs, pm = args
    with torch.no_grad():
        got = tm(_t(images), _t(boxes), _t(classes).long(),
                 _t(pairs).long(), _t(pm), mode=mode, dedup_unions=dedup)
    assert set(got) == set(want)
    for k in ("obj_logits", "rel_logits", "obj_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(got["obj_preds"].numpy(),
                                  np.asarray(want["obj_preds"]))


def test_resnet_sgdet_relation_model_takes_a_stride_64_map(relmodel):
    """Mode sgdet: no trunk, the detector's ``pool`` level at 1/64."""
    jm, v, _ = relmodel
    _, boxes, classes, pairs, pm = _graph(seed=8)
    fmap = np.random.RandomState(9).randn(B, 3, 3, 256).astype(np.float32)
    sv = {"params": {k: x for k, x in v["params"].items() if k != "trunk"},
          "batch_stats": {k: x for k, x in v["batch_stats"].items()
                          if k != "trunk"}}
    want = jm.clone(mode="sgdet").apply(
        sv, None, *map(jnp.asarray, (boxes, classes, pairs, pm)),
        fmap=jnp.asarray(fmap))
    tm = RelModelIMP(mode="sgdet", **REL_KW)
    assert tm.trunk is None
    tm.load_state_dict(variables_from_jax(sv), strict=True)
    with torch.no_grad():
        got = tm.eval()(None, _t(boxes), _t(classes).long(),
                        _t(pairs).long(), _t(pm), fmap=_t(fmap))
    for k in ("obj_logits", "rel_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
