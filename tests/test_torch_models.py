"""Port parity of the model modules: the same flax variables (perturbed
from their initial values so every leaf matters) go through ``sgg_tpu``'s
modules and, via ``sgg_torch.convert``, through the port's, both in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.models.backbone import RoiHead as JRoiHead
from sgg_tpu.models.backbone import VGG16Trunk as JTrunk
from sgg_tpu.models.frequency_bias import FrequencyBias as JFreq
from sgg_tpu.models.relhead import GRUCell as JGRU
from sgg_tpu.models.relhead import IMPHead as JIMP
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.models.union_features import UnionBoxFeats as JUnion
from sgg_tpu.train.assign import all_pairs as jall_pairs
from sgg_torch.convert import variables_from_jax
from sgg_torch.models.relhead import RelModelIMP

C, R, HID, OBJ, IMG, N = 9, 6, 16, 32, 64, 5
TOL = dict(atol=1e-4, rtol=1e-4)


def _graph(seed=0, B=2):
    rng = np.random.RandomState(seed)
    xy = rng.rand(B, N, 2) * IMG * 0.7
    wh = rng.rand(B, N, 2) * IMG * 0.4 + 4
    boxes = np.concatenate([xy, np.minimum(xy + wh, IMG)], -1).astype(
        np.float32)
    classes = rng.randint(1, C, (B, N)).astype(np.int32)
    node_mask = np.ones((B, N), bool)
    node_mask[1, 3:] = False
    images = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    pairs, pm = jall_pairs(jnp.asarray(node_mask))
    return images, boxes, classes, np.array(pairs), np.array(pm)


def random_variables(jm, args, seed=1):
    """Flax variables of ``jm`` drawn with numpy: He-scaled conv and
    lecun-scaled dense kernels (activations stay O(1) through the trunk),
    nonzero biases and BatchNorm statistics, so every leaf matters."""
    shapes = jax.eval_shape(jm.init, jax.random.key(0), *args)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            gain = 2.0 if len(shape) == 4 else 1.0
            x = rng.randn(*shape) * np.sqrt(gain / fan_in)
        elif name.endswith("['var']"):
            x = rng.rand(*shape) + 0.5
        elif name.endswith("['scale']"):
            x = 1.0 + 0.1 * rng.randn(*shape)
        else:  # biases, BatchNorm means, the frequency table
            x = 0.1 * rng.randn(*shape)
        return np.asarray(x, np.float32)  # a 0-d leaf draws a float

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    images, boxes, classes, pairs, pm = _graph()
    jm = JModel(num_classes=C, num_predicates=R, hidden_dim=HID, obj_dim=OBJ,
                use_bias=True, dtype=jnp.float32)
    v = random_variables(jm, tuple(map(jnp.asarray, (images, boxes, classes,
                                                     pairs, pm))))
    tm = RelModelIMP(num_classes=C, num_predicates=R, hidden_dim=HID,
                     obj_dim=OBJ, use_bias=True)
    tm.load_state_dict(variables_from_jax(v), strict=True)
    return jm, v, tm.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


def test_trunk(models):
    _, v, tm = models
    x = np.random.RandomState(2).randn(2, 48, 40, 3).astype(np.float32)
    want = JTrunk(dtype=jnp.float32).apply(
        {"params": v["params"]["trunk"]}, jnp.asarray(x))
    got = tm.trunk(_t(x))
    assert got.shape == want.shape == (2, 3, 2, 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("final_relu", [False, True])
def test_roi_head(models, dedup, final_relu):
    _, v, tm = models
    rng = np.random.RandomState(3)
    name = "roi_fmap_obj" if final_relu else "roi_fmap"
    x = rng.randn(2, 4, 7, 7, 512).astype(np.float32)
    kw_j, kw_t = {}, {}
    if dedup:
        g = rng.randint(0, 4, (2, 6))
        add = rng.randn(2, 6, 512).astype(np.float32)
        kw_j = dict(gather_idx=jnp.asarray(g), broadcast_add=jnp.asarray(add))
        kw_t = dict(gather_idx=_t(g).long(), broadcast_add=_t(add))
    want = JRoiHead(out_dim=OBJ, with_final_relu=final_relu,
                    dtype=jnp.float32).apply(
        {"params": v["params"][name]}, jnp.asarray(x), **kw_j)
    got = getattr(tm, name)(_t(x), **kw_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_union_feats(models):
    _, v, tm = models
    _, boxes, _, _, _ = _graph(seed=4)
    pb = np.concatenate([boxes[:, [0, 1, 2, 3]], boxes[:, [4, 3, 2, 1]]], -1)
    want = JUnion(dim=512, dtype=jnp.float32).apply(
        {"params": v["params"]["union_feats"],
         "batch_stats": v["batch_stats"]["union_feats"]}, jnp.asarray(pb))
    got = tm.union_feats(_t(pb))
    assert got.shape == want.shape == (2, 4, 1, 1, 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _raw_boxes(tm):
    """``tm`` with its rects branch switched to ``raw_boxes`` (the same
    weights: only the rasterizer differs); restore ``motifs`` after."""
    tm.union_feats.edge_model = "raw_boxes"
    return tm


HW = np.asarray([[IMG, IMG], [48.0, IMG - 8.0]], np.float32)


def test_union_feats_raw_boxes(models):
    _, v, tm = models
    _, boxes, _, _, _ = _graph(seed=4)
    pb = np.concatenate([boxes[:, [0, 1, 2, 3]], boxes[:, [4, 3, 2, 1]]], -1)
    pb[0, 1, 4:] = [10.0, 12.0, 10.0, 30.0]  # a zero-width object box
    want = JUnion(dim=512, edge_model="raw_boxes", dtype=jnp.float32).apply(
        {"params": v["params"]["union_feats"],
         "batch_stats": v["batch_stats"]["union_feats"]}, jnp.asarray(pb),
        im_hw=jnp.asarray(HW))
    try:
        got = _raw_boxes(tm).union_feats(_t(pb), _t(HW))
        with pytest.raises(ValueError, match="im_hw"):
            tm.union_feats(_t(pb))
    finally:
        tm.union_feats.edge_model = "motifs"
    assert got.shape == want.shape == (2, 4, 1, 1, 512)
    motifs = tm.union_feats(_t(pb)).detach().numpy()
    assert np.abs(motifs - np.asarray(want)).max() > 1e-2  # not the same
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,dedup", [("sgcls", True), ("predcls", False)])
def test_full_model_raw_boxes(models, mode, dedup):
    jm, v, tm = models
    images, boxes, classes, pairs, pm = _graph(seed=9)
    want = jm.clone(edge_model="raw_boxes").apply(
        v, *map(jnp.asarray, (images, boxes, classes, pairs, pm)),
        im_hw=jnp.asarray(HW), mode=mode, dedup_unions=dedup)
    try:
        with torch.no_grad():
            got = _raw_boxes(tm)(_t(images), _t(boxes), _t(classes).long(),
                                 _t(pairs).long(), _t(pm), im_hw=_t(HW),
                                 mode=mode, dedup_unions=dedup)
    finally:
        tm.union_feats.edge_model = "motifs"
    for k in ("obj_logits", "rel_logits", "obj_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_sgdet_raw_boxes_needs_im_hw():
    """The SGDet path passes no image sizes, as in the JAX package (whose
    ``raw_boxes`` asserts on them): the port says what is missing."""
    tm = RelModelIMP(num_classes=C, num_predicates=R, mode="sgdet",
                     hidden_dim=HID, obj_dim=OBJ, edge_model="raw_boxes")
    _, boxes, classes, pairs, pm = _graph()
    with pytest.raises(ValueError, match="raw_boxes.*im_hw"):
        tm(None, _t(boxes), _t(classes).long(), _t(pairs).long(), _t(pm),
           fmap=torch.zeros(2, 4, 4, 512))


def test_gru_cell(models):
    _, v, tm = models
    rng = np.random.RandomState(5)
    h = rng.randn(2, 3, HID).astype(np.float32)
    x = rng.randn(2, 3, HID).astype(np.float32)
    want, _ = JGRU(HID, dtype=jnp.float32).apply(
        {"params": v["params"]["imp"]["node_gru"]}, jnp.asarray(h),
        jnp.asarray(x))
    got = tm.imp.node_gru(_t(h), _t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_imp_head(models):
    _, v, tm = models
    rng = np.random.RandomState(6)
    _, _, _, pairs, pm = _graph()
    nf = rng.randn(2, N, OBJ).astype(np.float32)
    ef = rng.randn(2, pairs.shape[1], OBJ).astype(np.float32)
    want = JIMP(num_classes=C, num_predicates=R, hidden_dim=HID,
                dtype=jnp.float32).apply(
        {"params": v["params"]["imp"]}, jnp.asarray(nf), jnp.asarray(ef),
        jnp.asarray(pairs), jnp.asarray(pm))
    got = tm.imp(_t(nf), _t(ef), _t(pairs).long(), _t(pm))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_frequency_bias(models):
    _, v, tm = models
    rng = np.random.RandomState(7)
    s, o = rng.randint(0, C, (2, 7)), rng.randint(0, C, (2, 7))
    want = JFreq(num_classes=C, num_predicates=R).apply(
        {"params": v["params"]["freq_bias"]}, jnp.asarray(s), jnp.asarray(o))
    got = tm.freq_bias(_t(s), _t(o))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=0, rtol=0)


@pytest.mark.parametrize("mode,dedup,use_bias", [
    ("sgcls", False, False), ("sgcls", True, True),
    ("predcls", True, False), ("predcls", False, True)])
def test_full_model(models, mode, dedup, use_bias):
    jm, v, tm = models
    images, boxes, classes, pairs, pm = _graph(seed=8)
    tm.use_bias = use_bias
    try:
        want = jm.clone(use_bias=use_bias).apply(
            v, *map(jnp.asarray, (images, boxes, classes, pairs, pm)),
            mode=mode, dedup_unions=dedup)
        with torch.no_grad():
            got = tm(_t(images), _t(boxes), _t(classes).long(),
                     _t(pairs).long(), _t(pm), mode=mode,
                     dedup_unions=dedup)
    finally:
        tm.use_bias = True
    assert set(got) == set(want)
    for k in ("obj_logits", "rel_logits", "obj_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(got["obj_preds"].numpy(),
                                  np.asarray(want["obj_preds"]))
    if dedup:
        np.testing.assert_array_equal(got["dedup_ok"].numpy(),
                                      np.asarray(want["dedup_ok"]))
