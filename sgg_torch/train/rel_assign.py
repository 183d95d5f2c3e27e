"""SGDet relation target assignment: detections -> GT relations.

Counterpart of ``sgg_tpu/train/rel_assign.py`` (reference
``lib/rel_assignments.py``): a detection matches a GT object of the same
class at IoU >= 0.5; each GT relation samples one FG pair among the matching
(subject, object) detection pairs, weighted by the IoU product (the
reference's ``npr.choice`` with ``num_sample_per_gt = 1``), FG capped at
``REL_FG_FRACTION * 64 = 16`` an image; BG pairs come from overlapping
non-FG detection pairs, filling to 64 an image; an image with nothing gets
one dummy relation (``rel_assignments.py:119-121``).

As ``train/assign.py`` splits the edge sampler, ``select_rel_assignments``
is the deterministic core over given draws (the Gumbel noise, the FG-cap
uniforms, the BG uniforms) and ``rel_assignments`` draws them from a
``torch.Generator``. The whole batch is one set of tensor ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from sgg_torch.constants import REL_FG_FRACTION
from sgg_torch.ops.boxes import box_iou
from sgg_torch.parallel.mesh import global_rand

RELS_PER_IMAGE_DET = 64  # rel_assignments.py:109


def _per_rel(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, Ng)[:, :, idx (B, Eg)] -> (B, Eg, N)."""
    B, N, _ = x.shape
    return torch.gather(x, 2, idx[:, None, :].expand(B, N, idx.shape[1])
                        ).transpose(1, 2)


def select_rel_assignments(gumbel: torch.Tensor, u_cap: torch.Tensor,
                           u_bg: torch.Tensor, det_boxes, det_labels,
                           det_mask, gt_boxes, gt_classes, gt_rels,
                           gt_rel_mask, *, max_out: int = RELS_PER_IMAGE_DET,
                           fg_thresh: float = 0.5,
                           filter_non_overlap: bool = True):
    """``_assign_one`` of the JAX package over the whole batch, on given
    draws.

    gumbel (B, Eg, N, N) Gumbel noise; u_cap (B, Eg) and u_bg (B, N*N)
    uniforms in [0, 1). det_* (B, N, ...) padded detections; gt_* (B, Ng
    or Eg, ...) padded GT. Returns (rels (B, max_out, 3) int64 over
    detection indices ``(subj, obj, predicate)``, mask (B, max_out)).
    Ties break as the JAX package's (``argmax``: the first maximum; sorts:
    stable, lower index first), so the same draws give the same rels.
    """
    B, N = det_mask.shape
    dev = det_mask.device
    inf = float("inf")
    max_fg = int(round(REL_FG_FRACTION * max_out))
    det_labels = det_labels.long()
    gt_rels = gt_rels.long()

    iou = box_iou(det_boxes, gt_boxes)  # (B, N, Ng)
    is_match = ((det_labels[:, :, None] == gt_classes[:, None, :].long())
                & (iou >= fg_thresh) & det_mask[:, :, None])

    # FG: one weighted sample per GT relation
    ms = _per_rel(is_match, gt_rels[..., 0])  # (B, Eg, N) subject matches
    mo = _per_rel(is_match, gt_rels[..., 1])  # object matches
    iou_s = _per_rel(iou, gt_rels[..., 0])
    iou_o = _per_rel(iou, gt_rels[..., 1])
    off_diag = ~torch.eye(N, dtype=torch.bool, device=dev)
    cand = (ms[..., :, None] & mo[..., None, :] & off_diag
            & gt_rel_mask[:, :, None, None])  # (B, Eg, N, N)
    w = iou_s[..., :, None] * iou_o[..., None, :]
    logits = torch.where(cand, torch.log(w.clamp(min=1e-12)), -inf)
    flat = (logits + gumbel).flatten(2)  # (B, Eg, N*N)
    pick = flat.argmax(dim=2)
    fg_valid = cand.flatten(2).any(dim=2)
    fg_subj = torch.div(pick, N, rounding_mode="floor")
    fg_obj = pick - fg_subj * N
    fg_pred = gt_rels[..., 2]

    # cap FG at max_fg by random rank (rel_assignments.py:101-102)
    u = torch.where(fg_valid, u_cap, inf)
    rank = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1,
                         stable=True)
    fg_keep = fg_valid & (rank < max_fg)
    fg_score = torch.where(fg_keep, 2.0 + u, -inf)

    # BG: overlapping non-FG detection pairs with non-background labels
    if filter_non_overlap:
        pair_iou = box_iou(det_boxes, det_boxes)
        possible = (pair_iou > 0) & (pair_iou < 1)
    else:
        possible = off_diag.expand(B, N, N)
    possible = (possible & det_mask[:, :, None] & det_mask[:, None, :]
                & (det_labels[:, :, None] > 0) & (det_labels[:, None, :] > 0)
                & off_diag & ~cand.any(dim=1))  # every FG candidate out
    bg_score = torch.where(possible.reshape(B, N * N), u_bg, -inf)
    grid = torch.arange(N, device=dev)
    bg_subj = grid[:, None].expand(N, N).reshape(-1).expand(B, -1)
    bg_obj = grid[None, :].expand(N, N).reshape(-1).expand(B, -1)

    all_score = torch.cat([fg_score, bg_score], 1)
    all_subj = torch.cat([fg_subj, bg_subj], 1)
    all_obj = torch.cat([fg_obj, bg_obj], 1)
    all_pred = torch.cat([fg_pred, torch.zeros_like(bg_subj)], 1)
    pad = max(0, max_out - all_score.shape[1])
    if pad:
        all_score = torch.cat([all_score, all_score.new_full((B, pad), -inf)],
                              1)
        all_subj, all_obj, all_pred = (
            torch.cat([a, a.new_zeros((B, pad))], 1)
            for a in (all_subj, all_obj, all_pred))

    top_s, top_i = torch.sort(all_score, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :max_out], top_i[:, :max_out]
    mask = top_s > -inf
    rels = torch.stack([torch.where(mask, torch.gather(a, 1, top_i), 0)
                        for a in (all_subj, all_obj, all_pred)], dim=2)
    # the dummy relation (0, 0, 0) when nothing survives
    none = ~mask.any(dim=1)
    mask = torch.cat([mask[:, :1] | none[:, None], mask[:, 1:]], 1)
    return rels, mask


def rel_assignments(generator: Optional[torch.Generator], det_boxes,
                    det_labels, det_mask, gt_boxes, gt_classes, gt_rels,
                    gt_rel_mask, *, max_out: int = RELS_PER_IMAGE_DET,
                    fg_thresh: float = 0.5, filter_non_overlap: bool = True):
    """Batched SGDet relation sampling (``rel_assignments`` of the JAX
    package): draws the Gumbel noise (B, Eg, N, N), the FG-cap uniforms
    (B, Eg) and the BG uniforms (B, N*N), in that order, from
    ``generator`` (on the detections' device) and returns
    ``select_rel_assignments`` of them.

    Under a data-parallel group each draw is made at the global batch's
    shape and the rank keeps its rows (``parallel.global_rand``), as
    ``sample_edges``: every other axis is fixed by the configuration (Eg
    is the loader's padded GT edge count, N the detector's
    ``detections_per_img``), so a rank draws what one process draws for
    its images."""
    B, N = det_mask.shape
    Eg = gt_rels.shape[1]
    dev = det_mask.device
    tiny = torch.finfo(torch.float32).tiny
    u = global_rand((B, Eg, N, N), generator, dev)
    gumbel = -torch.log(-torch.log(u.clamp_(min=tiny)))
    u_cap = global_rand((B, Eg), generator, dev)
    u_bg = global_rand((B, N * N), generator, dev)
    return select_rel_assignments(
        gumbel, u_cap, u_bg, det_boxes, det_labels, det_mask, gt_boxes,
        gt_classes, gt_rels, gt_rel_mask, max_out=max_out,
        fg_thresh=fg_thresh, filter_non_overlap=filter_non_overlap)
