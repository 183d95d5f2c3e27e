"""Faster R-CNN detector, VGG16 trunk and single-scale anchors.

Counterpart of the VGG half of ``sgg_tpu/models/detector.py`` (the
torchvision ``FasterRCNN`` assembly the reference wraps,
``sgg_models/rel_model_base.py:83-117``): VGG16 stride-16 features (the
trunk's first conv is kernel K2), single-level anchors (sizes 32-512,
ratios 0.5/1/2), an RPN with a 3x3 conv head, RoIAlign 7x7 over the
proposals (kernel K1) and the TwoMLPHead 4096-d box head, class-specific box
regression, score threshold 0.2 and 50 detections an image.

Everything has fixed shapes, as in the JAX package: proposal generation
keeps a static top-k before and after NMS (``sgg_torch.ops.nms``),
detections are padded ``(B, D)`` sets with validity masks. The detector is
frozen on this slice's paths (SGDet evaluation and relation training):
callers run it under ``torch.no_grad()``. Training it (``gt_boxes``) comes
with the detector-pretraining slice; ``FasterRCNNFPN`` with the
ResNet50-FPN slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.constants import POOL_SIZE, STRIDE, VGG_OBJ_DIM
from sgg_torch.models.backbone import RoiHead, VGG16Trunk
from sgg_torch.models.relhead import FMAP_CHANNELS, init_weights
from sgg_torch.ops.boxes import clip_boxes
from sgg_torch.ops.nms import decode_boxes, nms
from sgg_torch.ops.roi_align import roi_align

ANCHOR_SIZES = (32, 64, 128, 256, 512)  # rel_model_base.py:94
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
ROI_WEIGHTS = (10.0, 10.0, 5.0, 5.0)  # torchvision roi-head box coder


def make_anchors(fh: int, fw: int, stride: int = STRIDE,
                 sizes=ANCHOR_SIZES, ratios=ANCHOR_RATIOS) -> np.ndarray:
    """(fh*fw*A, 4) anchors, torchvision AnchorGenerator semantics
    (zero-centered cell anchors shifted by stride)."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for r in ratios:
            h = np.sqrt(area / r)
            w = r * h
            cell.append([-w / 2, -h / 2, w / 2, h / 2])
    cell = np.asarray(cell, np.float32)  # (A, 4)
    ys = (np.arange(fh, dtype=np.float32)) * stride
    xs = (np.arange(fw, dtype=np.float32)) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4)


def _conv_in(conv: nn.Conv2d, x: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``conv(x)`` in ``dtype`` (weight and bias cast at use)."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding)


class RPNHead(nn.Module):
    """3x3 conv -> objectness + 4 deltas per anchor (torchvision RPNHead),
    NHWC in; the outputs in float32, anchors ordered (h, w, a)."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.num_anchors = num_anchors
        self.compute_dtype = torch.float32
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, fmap: torch.Tensor):
        dt = self.compute_dtype
        x = fmap.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        t = F.relu(_conv_in(self.conv, x, dt))
        obj = _conv_in(self.cls_logits, t, dt).permute(0, 2, 3, 1)
        deltas = _conv_in(self.bbox_pred, t, dt).permute(0, 2, 3, 1)
        B, H, W, A = obj.shape
        return (obj.reshape(B, H * W * A).float(),
                deltas.reshape(B, H * W * A, 4).float())


def _top_sorted(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: a stable descending sort, so equal
    values keep the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image rows: (B, K, ...)[(B, M)] -> (B, M, ...)."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def generate_proposals(anchors, obj_logits, deltas, im_hw, *,
                       pre_nms_top_n: int, post_nms_top_n: int,
                       nms_thresh: float = 0.7, min_size: float = 1e-3,
                       nms_method: str = "sequential", nms_rounds: int = 16):
    """Per-batch proposal generation (torchvision RPN filter_proposals).

    anchors (K, 4); obj_logits (B, K); deltas (B, K, 4); im_hw (B, 2).
    Returns (proposals (B, P, 4), scores (B, P), mask (B, P),
    nms_converged (B,)).
    """
    boxes = clip_boxes(decode_boxes(anchors[None], deltas), im_hw)
    K = obj_logits.shape[1]
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    valid = (ws > min_size) & (hs > min_size)
    k = min(pre_nms_top_n, K)
    # the top k at a 128-aligned width with ranks >= k invalid, as the JAX
    # package does: the same top k, the same NMS shapes
    k_pad = min(-(-k // 128) * 128, K)
    top_s, top_i = _top_sorted(
        torch.where(valid, obj_logits, float("-inf")), k_pad)
    rank = torch.arange(k_pad, device=obj_logits.device)
    nms_valid = (top_s > float("-inf")) & (rank < k)
    idx, mask, conv = nms(_take(boxes, top_i), top_s, nms_valid, nms_thresh,
                          post_nms_top_n, method=nms_method,
                          rounds=nms_rounds, with_converged=True)
    return _take(boxes, _take(top_i, idx)), _take(top_s, idx), mask, conv


def postprocess_detections(class_logits, box_deltas, proposals, prop_mask,
                           im_hw, *, score_thresh: float, nms_thresh: float,
                           detections_per_img: int,
                           nms_candidates: int = 1024,
                           nms_method: str = "sequential",
                           nms_rounds: int = 16) -> Dict[str, torch.Tensor]:
    """torchvision RoIHeads.postprocess_detections with fixed shapes.

    class_logits (B, P, C); box_deltas (B, P, C*4); proposals (B, P, 4).
    Returns boxes (B, D, 4), labels (B, D), scores (B, D), mask (B, D),
    ``n_candidates`` (B,) and ``nms_converged`` (B,).

    ``nms_candidates`` caps each image's (proposal, class) candidates
    entering NMS at the top M scores (the raw P*(C-1) grid would need an
    (M, M) IoU matrix of 23 GB at the VG sizes). The cap is exact whenever
    at most M candidates clear ``score_thresh``; ``n_candidates`` counts
    them before the cap, so callers detect an overflow and re-run with a
    larger M (``sgdet_eval_with_retry``).
    """
    B, P, C = class_logits.shape
    scores = torch.softmax(class_logits, dim=-1)
    boxes_all = decode_boxes(proposals[:, :, None, :],
                             box_deltas.reshape(B, P, C, 4),
                             weights=ROI_WEIGHTS)
    boxes_all = clip_boxes(boxes_all.reshape(B, P * C, 4),
                           im_hw).reshape(B, P, C, 4)
    # drop the background column; flatten (P, C-1)
    b = boxes_all[:, :, 1:].reshape(B, P * (C - 1), 4)
    s = scores[:, :, 1:].reshape(B, P * (C - 1))
    lbl = torch.arange(1, C, device=s.device).repeat(P)  # (P*(C-1),)
    valid = (s > score_thresh) & prop_mask[:, :, None].expand(
        B, P, C - 1).reshape(B, -1)
    # min box size (torchvision min_size=1e-2 after regression)
    valid &= ((b[..., 2] - b[..., 0]) > 1e-2) & ((b[..., 3] - b[..., 1])
                                                 > 1e-2)
    n_cand = valid.sum(dim=1)  # before the cap: the overflow signal
    M = min(nms_candidates, s.shape[1])
    cs, ci = _top_sorted(torch.where(valid, s, float("-inf")), M)
    clbl = lbl[ci]
    cvalid = cs > float("-inf")
    # per-class NMS through the coordinate offset trick, kept exactly as the
    # JAX package computes it (its f32 rounding decides near-threshold IoUs)
    offset = clbl.float()[..., None] * (
        im_hw.max(dim=1).values + 1000.0)[:, None, None]
    idx, mask, conv = nms(_take(b, ci) + offset, cs, cvalid, nms_thresh,
                          detections_per_img, method=nms_method,
                          rounds=nms_rounds, with_converged=True)
    fi = _take(ci, idx)
    return {"boxes": _take(b, fi), "labels": lbl[fi],
            "scores": torch.where(mask, _take(cs, idx), 0.0), "mask": mask,
            "n_candidates": n_cand, "nms_converged": conv}


class FasterRCNNVGG(nn.Module):
    """Single-scale VGG16 Faster R-CNN with padded outputs.

    Module names follow the flax ones (``trunk.conv.{i}``, ``rpn.conv``,
    ``rpn.cls_logits``, ``rpn.bbox_pred``, ``box_head.fc6``/``fc7``,
    ``cls_score``, ``bbox_pred``), so ``convert.variables_from_jax`` maps a
    JAX ``FasterRCNNVGG``'s variables onto its ``state_dict``.
    ``nms_method``/``nms_candidates`` are the defaults that a call may
    override (the retry wrapper escalates them per call, on one instance).
    """

    def __init__(self, num_classes: int, pool_size: int = POOL_SIZE,
                 stride: int = STRIDE, obj_dim: int = VGG_OBJ_DIM,
                 score_thresh: float = 0.2, nms_thresh: float = 0.5,
                 detections_per_img: int = 50, rpn_pre_nms_top_n: int = 1000,
                 rpn_post_nms_top_n: int = 512, rpn_nms_thresh: float = 0.7,
                 nms_candidates: int = 1024, nms_method: str = "rounds",
                 nms_rounds: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.pool_size = pool_size
        self.stride = stride
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.rpn_pre_nms_top_n = rpn_pre_nms_top_n
        self.rpn_post_nms_top_n = rpn_post_nms_top_n
        self.rpn_nms_thresh = rpn_nms_thresh
        self.nms_candidates = nms_candidates
        self.nms_method = nms_method
        self.nms_rounds = nms_rounds
        A = len(ANCHOR_SIZES) * len(ANCHOR_RATIOS)
        self.trunk = VGG16Trunk()
        self.rpn = RPNHead(FMAP_CHANNELS, A)
        # torchvision TwoMLPHead: fc6-relu-fc7-relu, no dropout
        self.box_head = RoiHead(pool_size * pool_size * FMAP_CHANNELS,
                                obj_dim, with_final_relu=True)
        self.box_head.drop.p = 0.0
        # float32 whatever the compute type, as in the JAX package
        self.cls_score = nn.Linear(obj_dim, num_classes)
        self.bbox_pred = nn.Linear(obj_dim, num_classes * 4)
        self._anchors: Dict = {}

    def to_compute_dtype(self, dtype: torch.dtype) -> "FasterRCNNVGG":
        """Compute in ``dtype``: the trunk, RPN and box head are stored in
        it (the detector is frozen, so that is the same as casting at use,
        and K2 and K1 take their ``dtype`` routes); ``cls_score`` and
        ``bbox_pred`` stay float32."""
        for mod in (self.trunk, self.rpn, self.box_head):
            mod.to(dtype)
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = dtype
        return self

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        """``make_anchors`` on ``device``, copied there once per map size
        (a copy in the step would wait for the card)."""
        key = (fh, fw, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                make_anchors(fh, fw, self.stride)).to(device)
        return self._anchors[key]

    def forward(self, images, im_hw, *, fmap=None,
                score_thresh: Optional[float] = None,
                nms_method: Optional[str] = None,
                nms_candidates: Optional[int] = None,
                gt_boxes=None) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) (or ``fmap`` (B, h, w, 512)); im_hw (B, 2).

        Returns the detections (``postprocess_detections``' keys, with
        ``nms_converged`` covering the RPN's NMS too) and ``fmap``,
        ``proposals``, ``prop_mask``, ``rpn_obj_logits``, ``rpn_deltas``,
        ``class_logits``, ``box_deltas``, ``anchors``."""
        if gt_boxes is not None:
            raise NotImplementedError(
                "detector training (gt_boxes: GT proposals, RPN and RoI-head "
                "losses) comes with the detector-pretraining slice")
        method = nms_method or self.nms_method
        if fmap is None:
            fmap = self.trunk(images)
        B, fh, fw, _ = fmap.shape
        anchors = self.anchors(fh, fw, fmap.device)
        im_hw = im_hw.float()

        obj_logits, rpn_deltas = self.rpn(fmap)
        proposals, _, prop_mask, rpn_conv = generate_proposals(
            anchors, obj_logits, rpn_deltas, im_hw,
            pre_nms_top_n=self.rpn_pre_nms_top_n,
            post_nms_top_n=self.rpn_post_nms_top_n,
            nms_thresh=self.rpn_nms_thresh, nms_method=method,
            nms_rounds=self.nms_rounds)

        pooled = roi_align(fmap, proposals, spatial_scale=1.0 / self.stride,
                           pooled=self.pool_size)
        feats = self.box_head(pooled).float()
        class_logits = self.cls_score(feats)
        box_deltas = self.bbox_pred(feats)

        dets = postprocess_detections(
            class_logits, box_deltas, proposals, prop_mask, im_hw,
            score_thresh=(self.score_thresh if score_thresh is None
                          else score_thresh),
            nms_thresh=self.nms_thresh,
            detections_per_img=self.detections_per_img,
            nms_candidates=nms_candidates or self.nms_candidates,
            nms_method=method, nms_rounds=self.nms_rounds)
        dets["nms_converged"] = dets["nms_converged"] & rpn_conv
        dets.update({
            "fmap": fmap, "proposals": proposals, "prop_mask": prop_mask,
            "rpn_obj_logits": obj_logits, "rpn_deltas": rpn_deltas,
            "class_logits": class_logits, "box_deltas": box_deltas,
            "anchors": anchors,
        })
        return dets


def init_detector_weights(model: FasterRCNNVGG, seed: int) -> FasterRCNNVGG:
    """Seeded random weights with the initializers of ``init_weights``
    (He normal convs, lecun normal dense layers, zero biases), drawn on the
    CPU from one generator."""
    return init_weights(model, seed)
