"""Per-axis bilinear paint weights of ``F.grid_sample`` over a box's affine
grid (``align_corners=False``, zero padding).

Counterpart of ``box01_extents`` and ``paint_weights`` in
``sgg_tpu/ops/grid_sample.py`` (the reference rasterizes ``raw_boxes`` edge
masks with ``grid_sample``, ``lib/get_union_boxes.py:105-116``). The grid
that warps a unit feature into its [0, 1] box is separable by axis, so
painting is ``Wy @ feat @ Wx^T`` with the weights below; the ``raw_boxes``
masks paint a constant image and need only their row sums.
"""

from __future__ import annotations

import numpy as np
import torch


def box01_extents(boxes01: torch.Tensor):
    """(x0, y0, w, h) of [0, 1] boxes, a zero extent replaced by 1e-6 (the
    divisor of ``paint_weights``)."""
    x0, y0 = boxes01[..., 0], boxes01[..., 1]
    ww = boxes01[..., 2] - x0
    hh = boxes01[..., 3] - y0
    ww = torch.where(ww != 0, ww, torch.full_like(ww, 1e-6))
    hh = torch.where(hh != 0, hh, torch.full_like(hh, 1e-6))
    return x0, y0, ww, hh


def paint_weights(start: torch.Tensor, extent: torch.Tensor, out_dim: int,
                  in_dim: int) -> torch.Tensor:
    """(..., out_dim, in_dim) weights along one axis: output position t of
    ``linspace(0, 1, out_dim)`` samples the source at ``((t - start) /
    extent) * in_dim - 0.5`` with the two bilinear taps of
    ``grid_sample`` (a tap outside the source weighs nothing).

    ``t`` is ``jnp.linspace``'s float32 arithmetic, ``i`` times the rounded
    reciprocal of ``out_dim - 1``, so the taps fall where the JAX
    package's do."""
    dev = start.device
    step = float(np.float32(1.0) / np.float32(max(out_dim - 1, 1)))
    i = torch.arange(out_dim, device=dev)
    # the last position is exactly 1 (set by a fill: writing a Python number
    # into one element of a card tensor copies it from the host and waits)
    t = (i.float() * step).masked_fill(i == max(out_dim - 1, 1), 1.0)
    xs = ((t - start[..., None]) / extent[..., None]) * in_dim - 0.5
    x0 = torch.floor(xs)
    frac = xs - x0
    d = torch.arange(in_dim, dtype=xs.dtype, device=dev)
    return ((1.0 - frac)[..., None] * (x0[..., None] == d)
            + frac[..., None] * ((x0[..., None] + 1.0) == d))
