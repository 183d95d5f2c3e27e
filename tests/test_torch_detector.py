"""Port parity of the VGG16 Faster R-CNN: ``sgg_torch.models.detector``
against ``sgg_tpu.models.detector`` on the CPU in f32, same weights
(``variables_from_jax``, loaded with ``strict=True``), same images.

* the whole detector at 96 px (6x6 map, 540 anchors), 8 classes, with
  every cap (RPN pre- and post-NMS top-n, NMS candidates, detections) at or
  above the count it caps: masks and each image's set of labels exact,
  boxes within 4e-3 px and scores within 2e-5 (1.66e-3 px and 1.09e-5
  measured: the RPN's boxes differ in the last bits between the packages,
  and bilinear sampling of the feature map moves the pooled features, and
  so the class logits and box deltas, by ~2e-5 of their size; from JAX's
  own proposals the pooled features agree to 3e-7);
* ``generate_proposals`` and ``postprocess_detections`` on identical
  inputs (the JAX detector's RPN and classifier outputs) with the caps
  crossed: discrete outputs exact, boxes within 1e-3 px;
* the JAX relation model built for SGDet (no trunk) loads strictly into
  the port's trunk-free ``RelModelIMP(mode="sgdet")``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.models.detector import FasterRCNNVGG as JDet
from sgg_tpu.models.detector import generate_proposals as jgen
from sgg_tpu.models.detector import postprocess_detections as jpost
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.models.sgdet import detection_pairs as jdetection_pairs
from sgg_torch.convert import variables_from_jax
from sgg_torch.models.detector import (FasterRCNNVGG, generate_proposals,
                                       init_detector_weights,
                                       postprocess_detections)
from sgg_torch.models.relhead import RelModelIMP
from test_torch_models import random_variables

C, IMG, B = 8, 96, 2
# 1.66e-3 px measured: the box deltas carry the class head's ~2e-5
BOX_ATOL = 4e-3
# every cap at or above what it caps: 540 anchors, 540 proposals,
# 540 * 7 (proposal, class) candidates
UNCAPPED = dict(rpn_pre_nms_top_n=600, rpn_post_nms_top_n=540,
                nms_candidates=4096, detections_per_img=1024)


def _images(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(B, IMG, IMG, 3).astype(np.float32)
    im_hw = np.asarray([[IMG, IMG], [80.0, IMG]], np.float32)
    return images, im_hw


@pytest.fixture(scope="module")
def detectors():
    images, im_hw = _images()
    jd = JDet(num_classes=C, obj_dim=48, dtype=jnp.float32, **UNCAPPED)
    v = random_variables(jd, (jnp.asarray(images), jnp.asarray(im_hw)),
                         seed=4)
    want = {k: np.asarray(x) for k, x in jax.jit(
        lambda v, i, h: jd.apply(v, i, h))(v, images, im_hw).items()}
    td = FasterRCNNVGG(C, obj_dim=48, **UNCAPPED)
    td.load_state_dict(variables_from_jax(v), strict=True)
    return v, want, td.eval()


def assert_detections_match(got, want):
    """The whole uncapped detector's outputs (numpy dicts) of the port and
    of JAX: continuous ones within 1e-4 of their scale, masks exact, each
    image's detections as a set."""
    n_prop = want["proposals"].shape[1]
    n_cls = want["class_logits"].shape[-1]
    # no cap is crossed: every valid candidate reaches NMS
    assert (want["n_candidates"] < n_prop * (n_cls - 1)).all()
    assert (want["mask"].sum(1) < UNCAPPED["detections_per_img"]).all()
    for k in ("fmap", "rpn_obj_logits", "rpn_deltas", "class_logits",
              "box_deltas"):
        scale = max(np.abs(want[k]).max(), 1.0)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * scale,
                                   err_msg=k)
    for k in ("prop_mask", "mask", "n_candidates", "nms_converged"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # random RPN weights give deltas up to the log(1000/16) clamp on
    # anchors up to 724 px: the logits' 2e-6 moves a corner by up to ~1e-2
    np.testing.assert_allclose(got["proposals"], want["proposals"],
                               atol=1e-2)
    # the slots follow the scores, and two detections whose scores differ
    # by less than the packages do may swap slots (image 1 has such a pair,
    # 1.2e-7 apart): each image's detections are held as a set, in
    # (label, box) order
    for b in range(want["mask"].shape[0]):
        sets = []
        for d in (got, want):
            m = d["mask"][b]
            order = np.lexsort(np.round(d["boxes"][b][m], 1).T[::-1])
            order = order[np.argsort(d["labels"][b][m][order],
                                     kind="stable")]
            sets.append({k: d[k][b][m][order]
                         for k in ("labels", "boxes", "scores")})
        np.testing.assert_array_equal(sets[0]["labels"], sets[1]["labels"])
        np.testing.assert_allclose(sets[0]["boxes"], sets[1]["boxes"],
                                   atol=BOX_ATOL)
        np.testing.assert_allclose(sets[0]["scores"], sets[1]["scores"],
                                   atol=2e-5)


def test_whole_detector_matches_jax(detectors):
    _, want, td = detectors
    images, im_hw = _images()
    with torch.no_grad():
        got = td(torch.from_numpy(images), torch.from_numpy(im_hw))
    assert want["mask"].sum() > 20
    assert_detections_match({k: x.numpy() for k, x in got.items()}, want)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("method", ["rounds", "sequential"])
def test_generate_proposals_matches_jax_on_the_same_inputs(detectors,
                                                           method):
    """The RPN's continuous outputs of the JAX detector through both
    packages' proposal filter, with the top-k caps crossed (64 of 540
    before NMS, 24 after)."""
    _, want, _ = detectors
    _, im_hw = _images()
    args = (want["anchors"], want["rpn_obj_logits"], want["rpn_deltas"],
            im_hw)
    kw = dict(pre_nms_top_n=64, post_nms_top_n=24, nms_thresh=0.7,
              nms_method=method)
    jp = [np.asarray(x) for x in jax.jit(functools.partial(jgen, **kw))(
        *map(jnp.asarray, args))]
    tp = [x.numpy() for x in generate_proposals(*map(_t, args), **kw)]
    np.testing.assert_allclose(tp[0], jp[0], atol=1e-3)  # proposals
    np.testing.assert_array_equal(tp[1], jp[1])  # scores: a gather
    np.testing.assert_array_equal(tp[2], jp[2])  # mask
    np.testing.assert_array_equal(tp[3], jp[3])  # converged
    assert jp[2].all()


@pytest.mark.parametrize("cap", [16, 4096])
def test_postprocess_matches_jax_on_the_same_inputs(detectors, cap):
    """The classifier's continuous outputs of the JAX detector through both
    packages' post-processing; at cap 16 more candidates clear the
    threshold than the cap keeps (``n_candidates`` over the cap)."""
    _, want, _ = detectors
    _, im_hw = _images()
    args = (want["class_logits"], want["box_deltas"], want["proposals"],
            want["prop_mask"], im_hw)
    kw = dict(score_thresh=0.05, nms_thresh=0.5, detections_per_img=12,
              nms_candidates=cap, nms_method="rounds")
    jd = {k: np.asarray(x) for k, x in jax.jit(functools.partial(
        jpost, **kw))(*map(jnp.asarray, args)).items()}
    td = {k: x.numpy() for k, x in postprocess_detections(*map(_t, args),
                                                          **kw).items()}
    assert set(td) == set(jd)
    if cap == 16:
        assert (jd["n_candidates"] > cap).all()
    for k in ("labels", "mask", "n_candidates", "nms_converged"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    np.testing.assert_allclose(td["boxes"], jd["boxes"], atol=1e-3)
    np.testing.assert_allclose(td["scores"], jd["scores"], atol=1e-6)


def test_sgdet_relation_variables_load_strictly():
    """The JAX package builds its SGDet relation model on the detector's
    feature map, without a trunk; the port's sgdet model has none
    either."""
    rng = np.random.RandomState(0)
    boxes = rng.rand(1, 4, 4).astype(np.float32) * 40
    boxes[..., 2:] += boxes[..., :2] + 8
    mask = jnp.ones((1, 4), bool)
    pairs, pm = jdetection_pairs(jnp.asarray(boxes), mask, False)
    jm = JModel(num_classes=C, num_predicates=5, mode="sgdet", hidden_dim=16,
                obj_dim=32, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda b, p, m: jm.init(jax.random.key(0), None, b,
                                jnp.ones((1, 4), jnp.int32), p, m,
                                fmap=jnp.zeros((1, 4, 4, 512))),
        jnp.asarray(boxes), pairs, pm)
    assert "trunk" not in shapes["params"]
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)
    tm = RelModelIMP(num_classes=C, num_predicates=5, mode="sgdet",
                     hidden_dim=16, obj_dim=32)
    assert tm.trunk is None
    tm.load_state_dict(variables_from_jax(v), strict=True)
    with pytest.raises(ValueError, match="no trunk"):
        tm(torch.zeros(1, 64, 64, 3), torch.from_numpy(boxes),
           torch.ones(1, 4, dtype=torch.long), torch.from_numpy(
               np.array(pairs)), torch.from_numpy(np.array(pm)))


def test_detector_compute_type_and_training_refused():
    """bf16 compute keeps float32 master weights (the trunk, RPN and box
    head cast them at use, so the detector can train); a frozen detector
    (no parameter requires a gradient) stores those three in bf16; the
    classifier stays f32 either way. Training (``gt_boxes``) runs; what is
    refused is an image batch that asks for a gradient, which no kernel
    computes."""
    heads = ("cls_score", "bbox_pred")
    for frozen in (True, False):
        det = init_detector_weights(FasterRCNNVGG(C, obj_dim=48), 0)
        det.requires_grad_(not frozen).to_compute_dtype(torch.bfloat16)
        assert det.trunk.compute_dtype == det.rpn.compute_dtype \
            == det.box_head.compute_dtype == torch.bfloat16
        for name, p in det.named_parameters():
            want = torch.bfloat16 if frozen and not name.startswith(heads) \
                else torch.float32
            assert p.dtype == want, (frozen, name)
    gt = torch.tensor([[[2.0, 3.0, 20.0, 30.0]]])
    out = det(torch.zeros(1, 32, 32, 3), torch.full((1, 2), 32.0),
              gt_boxes=gt, gt_mask=torch.ones(1, 1, dtype=torch.bool))
    assert torch.equal(out["proposals"][:, -1:], gt)
    assert bool(out["prop_mask"][0, -1])
    with pytest.raises(RuntimeError, match="no CUDA kernel computes"):
        det(torch.zeros(1, 32, 32, 3, requires_grad=True),
            torch.full((1, 2), 32.0))
