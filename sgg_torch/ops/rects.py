"""Anti-aliased box-pair rasterization ("rects") for union-box features.

Counterpart of ``sgg_tpu/ops/rects.py`` and of the reference's Cython
``draw_union_boxes_c`` (``lib/draw_rectangles/draw_rectangles.pyx:27-67``).
With the subject/object boxes mapped into the union box's ``[0, P]``
frame, the coverage of pixel ``(j, k)`` by a box is a separable product of
clipped 1-D overlaps::

    cov[j, k] = clip(j+1-y1, 0, 1)*clip(y2-j, 0, 1)
              * clip(k+1-x1, 0, 1)*clip(x2-k, 0, 1)
"""

from __future__ import annotations

import torch


def draw_union_rects(pair_boxes: torch.Tensor,
                     pooling_size: int) -> torch.Tensor:
    """(..., E, 8) subject+object boxes -> (..., E, 2, P, P) float32
    coverage in [0, 1]. The caller subtracts 0.5
    (``get_union_boxes.py:67``)."""
    P = pooling_size
    boxes = pair_boxes.float().reshape(*pair_boxes.shape[:-1], 2, 4)
    x1u = boxes[..., 0].amin(-1, keepdim=True)  # (..., E, 1)
    y1u = boxes[..., 1].amin(-1, keepdim=True)
    x2u = boxes[..., 2].amax(-1, keepdim=True)
    y2u = boxes[..., 3].amax(-1, keepdim=True)
    w = x2u - x1u
    h = y2u - y1u
    # degenerate unions (zero-area padded boxes) must not divide by zero
    w = torch.where(w > 0, w, torch.ones_like(w))
    h = torch.where(h > 0, h, torch.ones_like(h))

    # a tensor numerator: ``P / w`` would be ``w.reciprocal() * P``; filled
    # on the device (``new_tensor`` would copy from the host and wait)
    sx = torch.full_like(w, float(P)) / w
    sy = torch.full_like(h, float(P)) / h
    x1 = (boxes[..., 0] - x1u) * sx  # (..., E, 2)
    y1 = (boxes[..., 1] - y1u) * sy
    x2 = (boxes[..., 2] - x1u) * sx
    y2 = (boxes[..., 3] - y1u) * sy

    grid = torch.arange(P, dtype=torch.float32, device=boxes.device)
    j = grid[:, None]  # rows (y)
    k = grid[None, :]  # cols (x)

    def cov1d(g, lo, hi):
        lo = lo[..., None, None]
        hi = hi[..., None, None]
        return (g + 1 - lo).clamp(0.0, 1.0) * (hi - g).clamp(0.0, 1.0)

    return cov1d(j, y1, y2) * cov1d(k, x1, x2)
