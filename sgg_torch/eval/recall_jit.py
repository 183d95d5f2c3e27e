"""On-device Recall@K for a fast validation loop.

Counterpart of ``sgg_tpu/eval/recall_jit.py``: a vectorized, fixed-shape
graph-constrained Recall@K over padded device tensors, with no host round
trip. It gives the hits of the host evaluator (``eval/sgg_eval.py``) on
the GC protocol in the GT-box modes (predcls/sgcls): the predictions are
the pairs ranked by ``max_nonbg_rel * obj0 * obj1`` (ties in pair order); a
match is the exact (subject class, predicate, object class) triplet with
IoU >= 0.5 on both boxes; a GT triplet counts once however many of the
top K match it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from sgg_torch.constants import RECALL_KS
from sgg_torch.ops.boxes import box_iou


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, ...]]`` along the node axis: x (B, N, ...), idx (B, M)."""
    idx = idx.long()
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
                        .expand(*idx.shape, *x.shape[2:]))


@torch.no_grad()
def batch_recall(
    boxes: torch.Tensor, pred_classes: torch.Tensor, obj_scores: torch.Tensor,
    pairs: torch.Tensor, pair_mask: torch.Tensor, rel_dists: torch.Tensor,
    gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_rels: torch.Tensor,
    gt_rel_mask: torch.Tensor, ks: Sequence[int] = RECALL_KS,
) -> Dict[int, torch.Tensor]:
    """Graph-constrained Recall@K over a padded batch, on the tensors'
    device.

    Args:
      boxes/pred_classes/obj_scores: (B, N, 4)/(B, N)/(B, N) predictions.
      pairs/pair_mask/rel_dists: (B, E, 2)/(B, E)/(B, E, R) candidates.
      gt_*: (B, N, 4)/(B, N)/(B, E_gt, 3)/(B, E_gt) ground truth.

    Returns {k: (B,) per-image recalls}; an image without GT relations
    reports 0 (mask it out when averaging).
    """
    # GC predicate choice and ranking score (surgery.py:40-47)
    pred_score, pred_p = rel_dists[..., 1:].max(dim=-1)
    pred_p = pred_p + 1                                        # (B, E)
    s0 = torch.gather(obj_scores, 1, pairs[..., 0].long())
    s1 = torch.gather(obj_scores, 1, pairs[..., 1].long())
    score = torch.where(pair_mask, pred_score * s0 * s1,
                        torch.full_like(pred_score, -float("inf")))
    order = torch.argsort(-score, dim=-1, stable=True)        # (B, E)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order).contiguous())

    # the triplet match matrix (B, E, E_gt)
    p_sub_cls = _take(pred_classes, pairs[..., 0])
    p_obj_cls = _take(pred_classes, pairs[..., 1])
    g_sub_cls = _take(gt_classes, gt_rels[..., 0])
    g_obj_cls = _take(gt_classes, gt_rels[..., 1])
    cls_match = ((p_sub_cls[:, :, None] == g_sub_cls[:, None, :])
                 & (p_obj_cls[:, :, None] == g_obj_cls[:, None, :])
                 & (pred_p[:, :, None] == gt_rels[..., 2][:, None, :]))

    iou = box_iou(boxes.float(), gt_boxes.float())             # (B, N, N)
    sub_iou = _take(_take(iou, pairs[..., 0]).transpose(1, 2),
                    gt_rels[..., 0]).transpose(1, 2)           # (B, E, E_gt)
    obj_iou = _take(_take(iou, pairs[..., 1]).transpose(1, 2),
                    gt_rels[..., 1]).transpose(1, 2)
    match = (cls_match & (sub_iou >= 0.5) & (obj_iou >= 0.5)
             & pair_mask[:, :, None] & gt_rel_mask[:, None, :])

    n_gt = gt_rel_mask.sum(-1).clamp(min=1).float()
    out = {}
    for k in ks:
        matched_gt = (match & (rank[:, :, None] < k)).any(dim=1)
        out[k] = matched_gt.sum(-1) / n_gt
    return out
