"""RoIAlign: the port's plain version against ``sgg_tpu``'s XLA op and its
Pallas kernel (interpret mode) in f32, and the numpy model of the CUDA
kernel's folded per-bin tap tables against both. The CUDA kernel K1 itself
is held against the plain version in ``test_torch_cuda.py``, which needs no
JAX and runs on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.ops.roi_align import roi_align as jax_roi_align
from sgg_tpu.ops.roi_align_pallas import roi_align_pallas
from sgg_torch.ops import roi_align as troi


def _case(kind, seed=0):
    rng = np.random.RandomState(seed)
    B, H, W, C = 2, 9, 11, 8
    fmap = rng.randn(B, H, W, C).astype(np.float32)
    R = 70 if kind == "ragged" else 9  # 70: no multiple of any ROI chunk
    boxes = rng.rand(B, R, 4).astype(np.float32) * 140
    boxes[..., 2:] += boxes[..., :2] + 10
    if kind == "degenerate":
        boxes[:, :3] = 0.0                       # zero-size at the origin
        boxes[:, 3] = [50.0, 60.0, 40.0, 20.0]   # x2 < x1, y2 < y1
        boxes[:, 4] = [30.0, 30.0, 30.0, 30.0]   # a point
    if kind == "outside":
        boxes[:, 0] = [-40.0, -30.0, 20.0, 25.0]     # partly left/above
        boxes[:, 1] = [150.0, 120.0, 260.0, 300.0]   # right/below the map
        boxes[:, 2] = [-300.0, -300.0, -100.0, -90.0]  # wholly outside
        boxes[:, 3] = [-16.0, -16.0, 0.0, 0.0]     # ends on the -1 edge
    if kind == "wholemap":
        boxes[:, 0] = [0.0, 0.0, W * 16.0, H * 16.0]   # the whole map
        boxes[:, 1] = [-20.0, -20.0, W * 16.0 + 30.0, H * 16.0 + 30.0]
    return fmap, boxes


KINDS = ["random", "ragged", "degenerate", "outside", "wholemap"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax(kind):
    fmap, boxes = _case(kind)
    want = np.asarray(jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes),
                                    spatial_scale=1 / 16.0))
    got = troi.roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes),
                         spatial_scale=1 / 16.0).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "degenerate", "outside"])
def test_plain_matches_pallas_interpret(kind):
    fmap, boxes = _case(kind, seed=1)
    want = np.asarray(roi_align_pallas(jnp.asarray(fmap), jnp.asarray(boxes),
                                       spatial_scale=1 / 16.0, chunk=4,
                                       interpret=True))
    got = troi.roi_align_reference(torch.from_numpy(fmap),
                                   torch.from_numpy(boxes),
                                   spatial_scale=1 / 16.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cpu_tensor_takes_plain_version():
    fmap, boxes = _case("random")
    before = troi.KERNEL.launches
    troi.roi_align(torch.from_numpy(fmap), torch.from_numpy(boxes),
                   spatial_scale=1 / 16.0)
    assert troi.KERNEL.launches == before


def _tap_tables(boxes, H, W, pooled=7, ratio=2):
    """Per box the (rows, columns) tap tables of ``folded_axis_taps``."""
    x1, y1, roi_w, roi_h = (
        t.numpy() for t in troi._box_frames(torch.from_numpy(boxes),
                                            1 / 16.0))
    return [[(troi.folded_axis_taps(y1[b, r], roi_h[b, r], H, pooled, ratio),
              troi.folded_axis_taps(x1[b, r], roi_w[b, r], W, pooled, ratio))
             for r in range(boxes.shape[1])] for b in range(boxes.shape[0])]


def _dense(table, dim):
    out = np.zeros((len(table), dim), np.float32)
    for p, taps in enumerate(table):
        for index, w in taps:
            out[p, index] = w
    return out


@pytest.mark.parametrize("pooled,ratio", [(7, 2), (7, 1), (5, 3)])
@pytest.mark.parametrize("kind", KINDS)
def test_folded_taps_match_interp_weights(kind, pooled, ratio):
    """At most 2 * ratio distinct, in-range, non-zero taps a bin, and
    scattered densely they are the plain version's Wy and Wx (f32, 1e-6:
    the fold multiplies by 1 / ratio where the plain version averages)."""
    fmap, boxes = _case(kind)
    _, H, W, _ = fmap.shape
    x1, y1, roi_w, roi_h = troi._box_frames(torch.from_numpy(boxes), 1 / 16.0)
    Wy = troi._interp_weights(y1, roi_h, H, pooled, ratio).numpy()
    Wx = troi._interp_weights(x1, roi_w, W, pooled, ratio).numpy()
    tables = _tap_tables(boxes, H, W, pooled, ratio)
    for b, per_box in enumerate(tables):
        for r, (rows, cols) in enumerate(per_box):
            for table, dim in ((rows, H), (cols, W)):
                assert len(table) == pooled
                for taps in table:
                    idx = [i for i, _ in taps]
                    assert len(taps) <= 2 * ratio
                    assert len(set(idx)) == len(idx)
                    assert all(0 <= i < dim and w != 0.0 for i, w in taps)
            np.testing.assert_allclose(_dense(rows, H), Wy[b, r], atol=1e-6,
                                       rtol=0)
            np.testing.assert_allclose(_dense(cols, W), Wx[b, r], atol=1e-6,
                                       rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_folded_tap_walk_matches_jax(kind):
    """The CUDA kernel's walk (per bin, f32 sum of wy * wx * fmap over its
    folded taps) on the model tables, f32: within 1e-6 abs of the plain
    version (same weights, another summation order) and within 1e-5 of
    ``sgg_tpu``'s roi_align, the tolerance the plain version is held to
    there (XLA's sample coordinates differ from both by a few 1e-6)."""
    fmap, boxes = _case(kind, seed=2)
    fmap = fmap[..., :4]
    _, H, W, C = fmap.shape
    want = np.asarray(jax_roi_align(jnp.asarray(fmap), jnp.asarray(boxes),
                                    spatial_scale=1 / 16.0))
    got = np.zeros_like(want)
    for b, per_box in enumerate(_tap_tables(boxes, H, W)):
        for r, (rows, cols) in enumerate(per_box):
            for p, ytaps in enumerate(rows):
                for q, xtaps in enumerate(cols):
                    acc = np.zeros(C, np.float32)
                    for yi, wy in ytaps:
                        for xi, wx in xtaps:
                            acc += np.float32(wy) * np.float32(wx) \
                                * fmap[b, yi, xi]
                    got[b, r, p, q] = acc
    plain = troi.roi_align_reference(torch.from_numpy(fmap),
                                     torch.from_numpy(boxes),
                                     spatial_scale=1 / 16.0).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
