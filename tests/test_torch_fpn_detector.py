"""Port parity of the ResNet50-FPN Faster R-CNN, f32 on the CPU:
``sgg_torch.models.detector.FasterRCNNFPN`` against ``sgg_tpu``'s on the
same weights (``detector_variables``: every leaf, BatchNorm statistics
included, drawn from a seed; loaded with ``strict=True``) and images, on a
112 px canvas (levels 28, 14, 7, 4 and 2: the C5 -> C4 upsampling is
inexact), 8 classes, a 48-d box head.

* the whole detector with the per-level top-k (200 of up to 2352 a level)
  and the candidate cap (512 of 812) crossed: every level's RPN outputs
  within 1e-4 of their size, the proposals within 1e-2 px, masks exact and
  each image's detections as a set (labels exact, boxes within 4e-3 px,
  scores within 2e-5), as ``tests/test_torch_detector.py`` holds the VGG
  detector's;
* ``fpn_proposals`` on the JAX detector's own RPN outputs: the same slots;
* one train step against ``pretrain_detector.py``'s own step (``jax.grad``
  through the whole detector, GT boxes appended to the proposals), given
  the same sampler draws: the four losses within 1e-6 of their size, the
  momentum traces (gradient plus decay) of the FPN, RPN and heads each
  within ``TRACE_TOL`` of its largest entry and the ResNet body's within
  ``BODY_TOL`` in norm, BatchNorm statistics untouched;
* ``pretrain(detector=None)`` builds, trains and saves the FPN detector.

The JAX references are computed once per module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pretrain_detector import make_detector_train_step as jax_train_step
from sgg_tpu.data.graph_batch import GraphBatch as JBatch
from sgg_tpu.models.detector import FasterRCNNFPN as JDet
from sgg_tpu.train.state import TrainState
from sgg_torch import constants
from sgg_torch import pretrain_detector as tpre
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.models import detector as tdet
from test_torch_detector_train import _draws, _gt, _sd
from test_torch_resnet_fpn import one_thread, resnet_variables  # noqa: F401

C, IMG, B, N = 8, 112, 2, 6
DET_KW = dict(obj_dim=48, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=128,
              rpn_nms_candidates=512, nms_candidates=1024,
              detections_per_img=64)
BOX_ATOL = 4e-3
LR = 0.005
pytestmark = pytest.mark.usefixtures("one_thread")
# the train step's momentum traces beyond the ResNet body (FPN, RPN, box
# head, classifier), each within TRACE_TOL of its largest entry: 3.5e-5
# measured. The proposals come out ~1e-3 px apart between the packages
# (the last bits of the RPN deltas, through exp), and the RoI-head losses
# reach the RPN through RoIAlign's box gradient, whose taps jump where a
# sample crosses a cell. The body's traces are held in norm at BODY_TOL: a
# ReLU whose input lies within f32 rounding of 0 (one of 25,088 in
# layer3_2.bn1 sits at 6.1e-7 in this step) passes its gradient in one
# package and not in the other, and the body below it follows (8.5e-6 in
# norm on 8 threads, 8.6e-4 on one, where the summation order puts that
# unit on the other side). The body's backward itself is held in float64,
# where no unit lies that close (test_torch_resnet_fpn.py).
TRACE_TOL = 1e-4
BODY_TOL = 1e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def detector_variables(jd, args, seed):
    """``resnet_variables`` with the RPN's box regression kernel drawn at a
    tenth of its scale: deltas of about one anchor size, as a trained RPN
    regresses. At full scale they sit at the log(1000/16) clamp on 512 px
    anchors, where the packages' last-bit differences move a proposal's
    corner by 0.02 px and the stride-4 level's pooled features with it."""
    v = resnet_variables(jd, args, seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a * np.float32(0.1) if jax.tree_util.keystr(p).endswith(
            "['rpn']['bbox_pred']['kernel']") else a, v)


def _images(seed=0):
    """Normalized canvases smooth at the scale of 8 px, as photographs
    are (pixel noise makes the stride-4 level rough, and a proposal corner
    that the packages put 1e-3 px apart then moves the pooled features
    far more than images do)."""
    rng = np.random.RandomState(seed)
    coarse = rng.randn(B, IMG // 8, IMG // 8, 3).astype(np.float32)
    images = np.asarray(jax.image.resize(jnp.asarray(coarse),
                                         (B, IMG, IMG, 3), "linear"))
    im_hw = np.asarray([[IMG, IMG], [96.0, IMG]], np.float32)
    return images, im_hw


@pytest.fixture(scope="module")
def detectors():
    images, im_hw = _images()
    jd = JDet(num_classes=C, dtype=jnp.float32, **DET_KW)
    v = detector_variables(jd, (jnp.asarray(images), jnp.asarray(im_hw)),
                           seed=4)
    out = jax.jit(lambda v, i, h: jd.apply(v, i, h))(v, images, im_hw)
    levels = {k: np.asarray(x) for k, x in out["pyramid"].items()}
    want = {k: np.asarray(x) for k, x in out.items()
            if k not in ("pyramid", "rpn_per_level")}
    td = tdet.FasterRCNNFPN(C, **DET_KW)
    td.load_state_dict(variables_from_jax(v), strict=True)
    return jd, v, want, levels, td.eval()


def test_whole_fpn_detector_matches_jax(detectors):
    _, _, want, levels, td = detectors
    images, im_hw = _images()
    with torch.no_grad():
        got = td(_t(images), _t(im_hw))
    pyramid = {k: x.numpy() for k, x in got.pop("pyramid").items()}
    got = {k: x.numpy() for k, x in got.items()}
    assert got["anchors"].shape == want["anchors"].shape == (3147, 4)
    np.testing.assert_array_equal(got["anchors"], want["anchors"])
    for k in ("p2", "p3", "p4", "p5", "pool"):
        np.testing.assert_allclose(pyramid[k], levels[k],
                                   atol=1e-4 * np.abs(levels[k]).max(),
                                   err_msg=k)
    np.testing.assert_array_equal(got["fmap"], pyramid["pool"])
    for k in ("rpn_obj_logits", "rpn_deltas", "class_logits",
              "box_deltas"):
        scale = max(np.abs(want[k]).max(), 1.0)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * scale,
                                   err_msg=k)
    for k in ("prop_mask", "mask", "n_candidates", "nms_converged"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["prop_mask"].sum() > 100 and want["mask"].sum() > 20
    assert (want["n_candidates"] <= DET_KW["nms_candidates"]).all()
    np.testing.assert_allclose(got["proposals"], want["proposals"],
                               atol=1e-2)
    for b in range(B):  # detections as sets, in (label, box) order
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


@pytest.mark.parametrize("method", ["rounds", "sequential"])
def test_fpn_proposals_on_the_jax_rpn_outputs(detectors, method):
    """JAX's concatenated RPN outputs through the port's proposal stage:
    JAX's proposal slots (rounds NMS converges here, so both methods give
    them)."""
    _, _, want, _, td = detectors
    _, im_hw = _images()
    boxes = tdet.clip_boxes(tdet.decode_boxes(
        _t(want["anchors"])[None], _t(want["rpn_deltas"])), _t(im_hw))
    counts = [s * s * 3 for s in (28, 14, 7, 4, 2)]
    props, mask, conv, _ = tdet.fpn_proposals(
        _t(want["rpn_obj_logits"]), boxes, counts, _t(im_hw),
        pre_nms_top_n=200, post_nms_top_n=128, nms_candidates=512,
        nms_method=method)
    np.testing.assert_array_equal(mask.numpy(), want["prop_mask"])
    assert conv.all()
    np.testing.assert_allclose(props.numpy(), want["proposals"], atol=1e-3)


# -- one train step ---------------------------------------------------------

def _batch():
    gtb, gtc, gtm = _gt(10)
    images, im_hw = _images(12)
    return dict(images=images, im_hw=im_hw, boxes=gtb, classes=gtc,
                node_mask=gtm, rels=np.zeros((B, 1, 3), np.int32),
                rel_mask=np.zeros((B, 1), bool))


@functools.lru_cache(maxsize=None)
def _jax_step():
    """``pretrain_detector.py``'s step (SGD at a constant 0.005) from the
    drawn weights, once for the module."""
    batch = _batch()
    jd = JDet(num_classes=C, dtype=jnp.float32, **DET_KW)
    v = detector_variables(jd, (jnp.asarray(batch["images"]),
                                jnp.asarray(batch["im_hw"])), seed=14)
    tx = optax.chain(optax.add_decayed_weights(5e-4),
                     optax.sgd(LR, momentum=0.9))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]), tx=tx)
    key = jax.random.key(13)
    jb = JBatch(**{k: jnp.asarray(x) for k, x in batch.items()})
    new, metrics = jax_train_step(jd)(state, jb, key)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    K = sum(s * s * 3 for s in (28, 14, 7, 4, 2))
    return dict(v=v, metrics={k: float(x) for k, x in metrics.items()},
                trace=np_(new.opt_state[1][0].trace),
                batch_stats=np_(new.batch_stats), key=key, K=K,
                P=DET_KW["rpn_post_nms_top_n"])


def test_fpn_train_step_matches_jax():
    ref = _jax_step()
    td = tdet.FasterRCNNFPN(C, **DET_KW)
    td.load_state_dict(variables_from_jax(ref["v"]), strict=True)
    stats = {k: b.clone() for k, b in td.named_buffers()}
    opt = tpre.DetectorOptimizer(td, lambda count: LR)
    step = tpre.make_detector_train_step(td, opt)
    k_rpn, k_roi = jax.random.split(ref["key"])
    metrics = step(GraphBatch(**_batch()), None,
                   draws={"rpn": _draws(k_rpn, (B, ref["K"])),
                          "roi": _draws(k_roi, (B, ref["P"]))})
    print("FPN train step losses vs JAX: " + ", ".join(
        f"{k} {abs(float(metrics[k]) - w):.3g}"
        for k, w in ref["metrics"].items()))
    for k, w in ref["metrics"].items():
        assert abs(float(metrics[k]) - w) <= 1e-6 * max(abs(w), 1.0), (
            k, float(metrics[k]), w)
    mine, theirs = opt.state_dict(), _sd(ref["trace"])
    assert set(mine) == set(theirs)
    body = [n for n in theirs if n.startswith("backbone.body.")]
    errs = {}
    for name, w in theirs.items():
        scale = float(np.abs(w).max())
        assert scale > 0, name
        errs[name] = float(np.abs(mine[name].numpy() - w).max()) / scale
    heads = sorted((n for n in errs if n not in body), key=errs.get)[-3:]
    body_err = (sum(float(np.square(mine[n].numpy() - theirs[n]).sum())
                    for n in body)
                / sum(float(np.square(theirs[n]).sum()) for n in body)) ** .5
    print("FPN train step traces vs JAX, worst beyond the body: "
          + ", ".join(f"{n} {errs[n]:.3g}" for n in heads)
          + f"; the body in norm {body_err:.3g}")
    assert errs[heads[-1]] <= TRACE_TOL, heads[-1]
    assert body_err <= BODY_TOL, body_err
    # the BatchNorm statistics are buffers that no step moves
    for k, b in td.named_buffers():
        assert torch.equal(b, stats[k]), k
    bn = "backbone.body.layer2_0.bn_down"
    np.testing.assert_array_equal(
        stats[bn + ".running_var"].numpy(),
        ref["batch_stats"]["backbone"]["body"]["layer2_0"]["bn_down"]["var"])
    assert float(mine[bn + ".weight"].abs().max()) > 0  # BN scales train


def test_pretrain_builds_and_saves_the_fpn_detector(tmp_path, monkeypatch):
    """``pretrain(detector=None)``: the JAX package's default, the FPN
    detector in bf16 over f32 masters (tiny heads here)."""
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.checkpoint import load_detector, load_detector_state

    tiny = functools.partial(tdet.FasterRCNNFPN, obj_dim=32,
                             rpn_pre_nms_top_n=32, rpn_post_nms_top_n=16,
                             detections_per_img=8)
    monkeypatch.setattr(tdet, "FasterRCNNFPN", tiny)
    monkeypatch.setattr(constants, "IM_SCALE", 64)
    splits = synthetic_splits(num_train=4, num_eval=2, num_classes=C,
                              num_predicates=5, max_objects=5,
                              image_size=64)
    det, state = tpre.pretrain(splits, num_epochs=1, batch_size=2,
                               max_nodes=8, save_dir=str(tmp_path / "det"),
                               steps_per_print=1, device="cpu")
    assert isinstance(det.backbone, tdet.ResNet50FPN)
    assert det.rpn.compute_dtype == torch.bfloat16
    assert state.step == 2 and len(state.history) == 2
    assert all(np.isfinite(list(h.values())).all() for h in state.history)
    payload, epoch = load_detector(str(tmp_path / "det"))
    assert epoch == 0 and int(payload["step"]) == 2
    fresh = tiny(C)
    load_detector_state(fresh, payload)
    assert all(p.dtype == torch.float32 for p in fresh.parameters())
    init = tdet.init_detector_weights(tiny(C), 0).state_dict()
    moved = [n for n, p in fresh.named_parameters()
             if not torch.equal(p, init[n])]
    assert len(moved) == len(list(fresh.parameters()))
