"""Box geometry ops (torch, any leading batch dims).

Counterpart of ``sgg_tpu/ops/boxes.py``: ``box_iou`` (reference
``lib/pytorch_misc.py:60-67``, torchvision ``box_iou`` semantics, no +1
offsets) and the union-box construction of
``sgg_models/rel_model_base.py:248-250``.
"""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``[x1, y1, x2, y2]`` boxes; last dim is 4."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    safe = torch.where(union > 0, union, torch.ones_like(union))
    return torch.where(union > 0, inter / safe, torch.zeros_like(union))


def gather_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, 4)[(B, E)] -> (B, E, 4)."""
    return torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))


def union_boxes(boxes: torch.Tensor, subj: torch.Tensor,
                obj: torch.Tensor) -> torch.Tensor:
    """Union box of each (subject, object) pair: (B, N, 4), (B, E) indices
    -> (B, E, 4), the min of the top-left and max of the bottom-right
    corners."""
    b_s = gather_boxes(boxes, subj)
    b_o = gather_boxes(boxes, obj)
    return torch.cat([torch.minimum(b_s[..., :2], b_o[..., :2]),
                      torch.maximum(b_s[..., 2:], b_o[..., 2:])], dim=-1)
