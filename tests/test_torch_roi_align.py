"""RoIAlign: the port's plain version against ``sgg_tpu``'s XLA op and its
Pallas kernel (interpret mode) in f32. The CUDA kernel K1 is held against
the plain version in ``test_torch_cuda.py``, which needs no JAX and runs
on the card."""

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
    return fmap, boxes


KINDS = ["random", "ragged", "degenerate", "outside"]


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
