"""Port parity of ``sgg_torch.ops.nms`` against ``sgg_tpu.ops.nms`` on the
same numpy inputs: all four NMS methods (indices, keep mask and the
``converged`` flag exactly, the deep suppression chain that ``rounds``
cannot finish included), the box coding (1e-6), ``clip_boxes`` and the
anchors (exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.models.detector import make_anchors as jmake_anchors
from sgg_tpu.ops.boxes import clip_boxes as jclip_boxes
from sgg_tpu.ops.nms import decode_boxes as jdecode
from sgg_tpu.ops.nms import encode_boxes as jencode
from sgg_tpu.ops.nms import nms as jnms
from sgg_torch.models.detector import ROI_WEIGHTS, make_anchors
from sgg_torch.ops.boxes import clip_boxes
from sgg_torch.ops.nms import METHODS, decode_boxes, encode_boxes, nms


def _boxes(rng, B, n, spread):
    boxes = rng.rand(B, n, 4).astype(np.float32) * spread
    boxes[..., 2:] += boxes[..., :2] + rng.rand(B, n, 2).astype(
        np.float32) * 20
    scores = rng.rand(B, n).astype(np.float32)
    # exact ties: the lower index goes first on both sides
    scores[:, 1::7] = scores[:, ::7][:, :scores[:, 1::7].shape[1]]
    valid = rng.rand(B, n) > 0.1
    return boxes, scores, valid


def _jax_nms(boxes, scores, valid, thresh, max_out, method, **kw):
    outs = [jnms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), thresh,
                 max_out, method=method, with_converged=True, **kw)
            for b, s, v in zip(boxes, scores, valid)]
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(3)]


def _check(boxes, scores, valid, thresh, max_out, method, **kw):
    want = _jax_nms(boxes, scores, valid, thresh, max_out, method, **kw)
    got = nms(torch.from_numpy(boxes), torch.from_numpy(scores),
              torch.from_numpy(valid), thresh, max_out, method=method,
              with_converged=True, **kw)
    for g, w, name in zip(got, want, ("indices", "mask", "converged")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return got


# n=200 with max_out 150: more boxes survive than slots; n=37 is not a
# multiple of the chunk
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n,spread,max_out", [(64, 30.0, 64),
                                              (200, 15.0, 150),
                                              (37, 10.0, 50)])
def test_nms_matches_jax(method, n, spread, max_out):
    rng = np.random.RandomState(n)
    boxes, scores, valid = _boxes(rng, 2, n, spread)
    kw = {"chunked": {"chunk": 16}, "rounds": {"rounds": 32}}.get(method, {})
    _, mask, conv = _check(boxes, scores, valid, 0.4, max_out, method, **kw)
    assert conv.all() and mask.any()
    seq = nms(torch.from_numpy(boxes), torch.from_numpy(scores),
              torch.from_numpy(valid), 0.4, max_out)
    for a, b in zip(seq, _check(boxes, scores, valid, 0.4, max_out,
                                "sequential")):
        assert torch.equal(a, b)


def test_nms_rounds_flags_a_deep_chain_as_unconverged():
    """Boxes in a line, each overlapping only its successor, scores
    descending: box 2k's keep needs k rounds (``tests/test_detector.py``)."""
    n = 12
    boxes = np.stack([np.arange(n, dtype=np.float32) * 6.0,
                      np.zeros(n, np.float32),
                      np.arange(n, dtype=np.float32) * 6.0 + 15.0,
                      np.full(n, 10.0, np.float32)], axis=1)[None]
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)[None]
    valid = np.ones((1, n), bool)
    _, _, conv = _check(boxes, scores, valid, 0.3, n, "rounds", rounds=2)
    assert not conv.any()
    _, mask, conv = _check(boxes, scores, valid, 0.3, n, "rounds", rounds=n)
    assert conv.all()
    assert torch.equal(mask, nms(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(valid), 0.3, n)[1])


def test_nms_respects_validity_and_max_out():
    boxes = np.asarray([[[0, 0, 10, 10], [0, 0, 10, 10], [20, 20, 30, 30]]],
                       np.float32)
    scores = np.asarray([[0.9, 0.8, 0.7]], np.float32)
    valid = np.asarray([[False, True, True]])
    idx, mask, _ = _check(boxes, scores, valid, 0.5, 2, "sequential")
    assert idx[mask].tolist() == [1, 2]  # box 0 invalid


def test_box_coding_matches_jax():
    rng = np.random.RandomState(1)
    ref = rng.rand(3, 40, 4).astype(np.float32) * 100
    ref[..., 2:] += ref[..., :2] + 5
    gt = rng.rand(3, 40, 4).astype(np.float32) * 100
    gt[..., 2:] += gt[..., :2] + 5
    deltas = rng.randn(3, 40, 4).astype(np.float32) * 3  # dw, dh clamped
    for w in ((1.0, 1.0, 1.0, 1.0), ROI_WEIGHTS):
        np.testing.assert_allclose(
            encode_boxes(torch.from_numpy(ref), torch.from_numpy(gt),
                         w).numpy(),
            np.asarray(jencode(jnp.asarray(ref), jnp.asarray(gt), w)),
            atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            decode_boxes(torch.from_numpy(ref), torch.from_numpy(deltas),
                         w).numpy(),
            np.asarray(jdecode(jnp.asarray(ref), jnp.asarray(deltas), w)),
            atol=1e-6, rtol=1e-6)


def test_clip_boxes_and_anchors_match_jax():
    rng = np.random.RandomState(2)
    boxes = (rng.rand(2, 30, 4).astype(np.float32) - 0.3) * 200
    hw = np.asarray([[96.0, 80.0], [64.0, 128.0]], np.float32)
    np.testing.assert_array_equal(
        clip_boxes(torch.from_numpy(boxes), torch.from_numpy(hw)).numpy(),
        np.asarray(jclip_boxes(jnp.asarray(boxes), jnp.asarray(hw))))
    for fh, fw in ((6, 6), (37, 37), (3, 5)):
        np.testing.assert_array_equal(make_anchors(fh, fw),
                                      jmake_anchors(fh, fw))
