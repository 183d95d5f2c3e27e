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
frozen on the SGDet paths (evaluation and relation training: callers run
it under ``torch.no_grad()``) and trains in detector pretraining
(``sgg_torch/pretrain_detector.py``): ``gt_boxes`` join the proposals, and
the RPN and RoI-head losses below (``sgg_tpu/models/detector.py:407-530``,
torchvision's RPN and RoIHeads semantics) assign and sample targets with
fixed shapes. As in the JAX package, the graph runs through the proposal
boxes (RoIAlign and the RoI-head box targets are differentiable in them),
so the RoI-head losses reach the RPN.

``FasterRCNNFPN`` is the ResNet50-FPN detector of ``sgg_tpu/models/
detector.py:266-401`` (the reference's ``maskrcnn_resnet50_fpn`` without
its mask head): one anchor size a pyramid level, an RPN shared over the
five levels, each level's top-k on its raw logits, a 2048-candidate cap,
NMS that keeps the levels apart, MultiScaleRoIAlign over P2-P5 (four K1
launches) and a 1024-d box head; its ``fmap`` is the stride-64 ``pool``
level, which the relation head pools from.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.constants import (POOL_SIZE, RESNET_OBJ_DIM, STRIDE,
                                  VGG_OBJ_DIM)
from sgg_torch.models.backbone import RoiHead, VGG16Trunk
from sgg_torch.models.relhead import FMAP_CHANNELS, init_weights
from sgg_torch.models.resnet import (FPN_CHANNELS, LEVELS, STRIDES,
                                     ResNet50FPN, multiscale_roi_align,
                                     set_compute_dtype)
from sgg_torch.ops.boxes import box_iou, clip_boxes
from sgg_torch.ops.nms import decode_boxes, encode_boxes, nms
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
    nms_converged (B,), the anchor index of each proposal slot (B, P)). The proposals keep the graph to ``deltas``; the
    selection (top-k, NMS) reads detached values, its outcome being
    indices.
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
    idx, mask, conv = nms(_take(boxes, top_i).detach(), top_s.detach(),
                          nms_valid, nms_thresh, post_nms_top_n,
                          method=nms_method, rounds=nms_rounds,
                          with_converged=True)
    keep = _take(top_i, idx)
    return _take(boxes, keep), _take(top_s, idx), mask, conv, keep


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


class _FasterRCNN(nn.Module):
    """What the two detectors share: their settings, the TwoMLPHead box
    head (fc6-relu-fc7-relu, no dropout) and the float32 classifier after
    the backbone and the RPN, the compute type, and everything from the
    RPN's proposals on (``_detect``). ``nms_method``/``nms_candidates`` are
    the defaults that a call may override (the retry wrapper escalates
    them per call, on one instance)."""

    def __init__(self, num_classes: int, backbone: Tuple[str, nn.Module],
                 rpn: nn.Module, channels: int, pool_size: int, obj_dim: int,
                 score_thresh: float, nms_thresh: float,
                 detections_per_img: int, rpn_pre_nms_top_n: int,
                 rpn_post_nms_top_n: int, rpn_nms_thresh: float,
                 nms_candidates: int, nms_method: str, nms_rounds: int):
        super().__init__()
        self.num_classes = num_classes
        self.pool_size = pool_size
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.rpn_pre_nms_top_n = rpn_pre_nms_top_n
        self.rpn_post_nms_top_n = rpn_post_nms_top_n
        self.rpn_nms_thresh = rpn_nms_thresh
        self.nms_candidates = nms_candidates
        self.nms_method = nms_method
        self.nms_rounds = nms_rounds
        self.add_module(*backbone)
        self.rpn = rpn
        self.box_head = RoiHead(pool_size * pool_size * channels, obj_dim,
                                with_final_relu=True)
        self.box_head.drop.p = 0.0
        # float32 whatever the compute type, as in the JAX package
        self.cls_score = nn.Linear(obj_dim, num_classes)
        self.bbox_pred = nn.Linear(obj_dim, num_classes * 4)
        self._anchors: Dict = {}

    def to_compute_dtype(self, dtype: torch.dtype) -> "_FasterRCNN":
        """Compute the backbone, RPN and box head in ``dtype`` (K2 and K1
        take their ``dtype`` routes) over float32 master weights cast at
        use, as flax's ``dtype=`` layers do, so that the detector can
        train. A detector with no parameter that requires a gradient
        (frozen, as on the SGDet paths) stores their convs and dense layers
        in ``dtype`` instead: the same numbers without the casts (a
        ResNet's BatchNorms stay float32, as flax keeps them).
        ``cls_score`` and ``bbox_pred`` stay float32."""
        frozen = not any(p.requires_grad for p in self.parameters())
        for name, mod in self.named_children():
            if name not in ("cls_score", "bbox_pred"):
                set_compute_dtype(mod, dtype, store=frozen)
        return self

    def _detect(self, pool, proposals, rpn_mask, rpn_conv, index, im_hw, *,
                gt_boxes, gt_mask, score_thresh, nms_candidates, method):
        """From the RPN's proposals on: the GT boxes appended (training),
        ``pool(proposals)`` (RoIAlign) through the box head and the
        classifier, the detections; the outputs that do not depend on the
        backbone."""
        prop_mask = rpn_mask
        if gt_boxes is not None:
            proposals, prop_mask = append_gt_proposals(
                proposals, rpn_mask, gt_boxes.float(), gt_mask)
        feats = self.box_head(pool(proposals.contiguous())).float()
        class_logits = self.cls_score(feats)
        box_deltas = self.bbox_pred(feats)
        dets = postprocess_detections(
            class_logits.detach(), box_deltas.detach(), proposals.detach(),
            prop_mask, im_hw,
            score_thresh=(self.score_thresh if score_thresh is None
                          else score_thresh),
            nms_thresh=self.nms_thresh,
            detections_per_img=self.detections_per_img,
            nms_candidates=nms_candidates or self.nms_candidates,
            nms_method=method, nms_rounds=self.nms_rounds)
        dets["nms_converged"] = dets["nms_converged"] & rpn_conv
        dets.update({"proposals": proposals, "prop_mask": prop_mask,
                     "class_logits": class_logits, "box_deltas": box_deltas,
                     "proposal_index": index, "rpn_prop_mask": rpn_mask})
        return dets


class FasterRCNNVGG(_FasterRCNN):
    """Single-scale VGG16 Faster R-CNN with padded outputs.

    Module names follow the flax ones (``trunk.conv.{i}``, ``rpn.conv``,
    ``rpn.cls_logits``, ``rpn.bbox_pred``, ``box_head.fc6``/``fc7``,
    ``cls_score``, ``bbox_pred``), so ``convert.variables_from_jax`` maps a
    JAX ``FasterRCNNVGG``'s variables onto its ``state_dict``.
    """

    def __init__(self, num_classes: int, pool_size: int = POOL_SIZE,
                 stride: int = STRIDE, obj_dim: int = VGG_OBJ_DIM,
                 score_thresh: float = 0.2, nms_thresh: float = 0.5,
                 detections_per_img: int = 50, rpn_pre_nms_top_n: int = 1000,
                 rpn_post_nms_top_n: int = 512, rpn_nms_thresh: float = 0.7,
                 nms_candidates: int = 1024, nms_method: str = "rounds",
                 nms_rounds: int = 16):
        A = len(ANCHOR_SIZES) * len(ANCHOR_RATIOS)
        super().__init__(
            num_classes, ("trunk", VGG16Trunk()), RPNHead(FMAP_CHANNELS, A),
            FMAP_CHANNELS, pool_size, obj_dim, score_thresh, nms_thresh,
            detections_per_img, rpn_pre_nms_top_n, rpn_post_nms_top_n,
            rpn_nms_thresh, nms_candidates, nms_method, nms_rounds)
        self.stride = stride

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
                gt_boxes=None, gt_mask=None,
                proposal_index=None) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) (or ``fmap`` (B, h, w, 512)); im_hw (B, 2).

        ``gt_boxes`` (B, N, 4) with ``gt_mask`` (B, N), for training: the
        GT boxes take the last N proposal slots (``append_gt_proposals``).
        ``proposal_index``, a previous call's ``(proposal_index,
        rpn_prop_mask)``, takes those anchors' decoded boxes as the RPN's
        proposals instead of selecting them anew (to hold two devices' steps
        on the same proposals).

        Returns the detections (``postprocess_detections``' keys, with
        ``nms_converged`` covering the RPN's NMS too; no gradient reaches
        them) and ``fmap``, ``proposals``, ``prop_mask``,
        ``rpn_obj_logits``, ``rpn_deltas``, ``class_logits``,
        ``box_deltas``, ``anchors``, ``proposal_index`` and
        ``rpn_prop_mask`` (the RPN's, before the GT boxes)."""
        method = nms_method or self.nms_method
        if fmap is None:
            fmap = self.trunk(images)
        B, fh, fw, _ = fmap.shape
        anchors = self.anchors(fh, fw, fmap.device)
        im_hw = im_hw.float()

        obj_logits, rpn_deltas = self.rpn(fmap)
        if proposal_index is None:
            proposals, _, rpn_mask, rpn_conv, index = generate_proposals(
                anchors, obj_logits, rpn_deltas, im_hw,
                pre_nms_top_n=self.rpn_pre_nms_top_n,
                post_nms_top_n=self.rpn_post_nms_top_n,
                nms_thresh=self.rpn_nms_thresh, nms_method=method,
                nms_rounds=self.nms_rounds)
        else:
            index, rpn_mask = proposal_index
            proposals = _take(clip_boxes(decode_boxes(anchors[None],
                                                      rpn_deltas), im_hw),
                              index)
            rpn_conv = torch.ones_like(rpn_mask[:, 0])
        dets = self._detect(
            lambda p: roi_align(fmap, p, spatial_scale=1.0 / self.stride,
                                pooled=self.pool_size),
            proposals, rpn_mask, rpn_conv, index, im_hw, gt_boxes=gt_boxes,
            gt_mask=gt_mask, score_thresh=score_thresh,
            nms_candidates=nms_candidates, method=method)
        dets.update({"fmap": fmap, "rpn_obj_logits": obj_logits,
                     "rpn_deltas": rpn_deltas, "anchors": anchors})
        return dets


def fpn_proposals(obj_logits, boxes, counts, im_hw, *, pre_nms_top_n: int,
                  post_nms_top_n: int, nms_candidates: int,
                  nms_thresh: float = 0.7, nms_method: str = "sequential",
                  nms_rounds: int = 16):
    """The FPN RPN's proposals (``FasterRCNNFPN.__call__`` of the JAX
    package): per level the top ``pre_nms_top_n`` of its raw logits (no
    validity mask), the top ``nms_candidates`` of those over all levels
    among the boxes wider and taller than 1e-3, then NMS with the levels
    kept apart by a coordinate offset of the (float) level index times
    ``max(h, w) + 1000``.

    obj_logits (B, K) and boxes (B, K, 4) (decoded, clipped) over the
    levels in order, ``counts`` the anchors of each level. Returns
    (proposals (B, P, 4) with the graph to ``boxes``, mask (B, P),
    nms_converged (B,), the anchor index of each proposal slot (B, P)).
    The selection reads detached values."""
    obj, det_boxes = obj_logits.detach(), boxes.detach()
    cand, cand_s, cand_lvl, start = [], [], [], 0
    for lvl, n in enumerate(counts):
        s, i = _top_sorted(obj[:, start:start + n], min(pre_nms_top_n, n))
        cand.append(i + start)
        cand_s.append(s)
        cand_lvl.append(torch.full_like(s, float(lvl)))
        start += n
    cand, cand_s, cand_lvl = (torch.cat(x, 1)
                              for x in (cand, cand_s, cand_lvl))
    cb = _take(det_boxes, cand)
    valid = ((cb[..., 2] - cb[..., 0]) > 1e-3) & (
        (cb[..., 3] - cb[..., 1]) > 1e-3)
    cs, ci = _top_sorted(torch.where(valid, cand_s, float("-inf")),
                         min(nms_candidates, cand.shape[1]))
    offset = _take(cand_lvl, ci)[..., None] * (
        im_hw.max(dim=1).values + 1000.0)[:, None, None]
    idx, mask, conv = nms(_take(cb, ci) + offset, cs, cs > float("-inf"),
                          nms_thresh, post_nms_top_n, method=nms_method,
                          rounds=nms_rounds, with_converged=True)
    keep = _take(_take(cand, ci), idx)
    return _take(boxes, keep), mask, conv, keep


class FasterRCNNFPN(_FasterRCNN):
    """ResNet50-FPN Faster R-CNN with padded outputs.

    Module names follow the flax ones (``backbone.body``/``backbone.fpn``,
    ``rpn``, ``box_head``, ``cls_score``, ``bbox_pred``), so
    ``convert.variables_from_jax`` maps a JAX ``FasterRCNNFPN``'s
    variables onto its ``state_dict``. The backbone's BatchNorms use their
    running statistics (``models/resnet.py``).
    """

    SIZES = ANCHOR_SIZES  # one anchor size a level, P2 to pool

    def __init__(self, num_classes: int, pool_size: int = POOL_SIZE,
                 obj_dim: int = RESNET_OBJ_DIM, score_thresh: float = 0.2,
                 nms_thresh: float = 0.5, detections_per_img: int = 50,
                 rpn_pre_nms_top_n: int = 1000,
                 rpn_post_nms_top_n: int = 512, rpn_nms_thresh: float = 0.7,
                 nms_candidates: int = 1024, rpn_nms_candidates: int = 2048,
                 nms_method: str = "rounds", nms_rounds: int = 16):
        super().__init__(
            num_classes, ("backbone", ResNet50FPN()),
            RPNHead(FPN_CHANNELS, len(ANCHOR_RATIOS)), FPN_CHANNELS,
            pool_size, obj_dim, score_thresh, nms_thresh, detections_per_img,
            rpn_pre_nms_top_n,  # a level
            rpn_post_nms_top_n, rpn_nms_thresh, nms_candidates, nms_method,
            nms_rounds)
        self.rpn_nms_candidates = rpn_nms_candidates

    def anchors(self, sizes, device):
        """Every level's ``make_anchors`` (one size by the three ratios)
        concatenated (K, 4) on ``device``, copied there once per pyramid
        shape, and the anchors a level."""
        key = (tuple(sizes), str(device))
        if key not in self._anchors:
            per = [make_anchors(fh, fw, stride, sizes=(size,))
                   for (fh, fw), stride, size in zip(sizes, STRIDES,
                                                     self.SIZES)]
            self._anchors[key] = (torch.from_numpy(np.concatenate(per)).to(
                device), [len(a) for a in per])
        return self._anchors[key]

    def forward(self, images, im_hw, *, pyramid=None,
                score_thresh: Optional[float] = None,
                nms_method: Optional[str] = None,
                nms_candidates: Optional[int] = None,
                gt_boxes=None, gt_mask=None,
                proposal_index=None) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3) (or ``pyramid``, the backbone's output);
        im_hw (B, 2). ``gt_boxes``/``gt_mask`` and ``proposal_index`` (an
        index into the concatenated anchors) as in ``FasterRCNNVGG``.

        Returns ``FasterRCNNVGG``'s keys, ``fmap`` being the ``pool`` level
        (B, h, w, 256), with ``pyramid``; ``anchors``, ``rpn_obj_logits``
        and ``rpn_deltas`` are the levels' concatenated."""
        method = nms_method or self.nms_method
        if pyramid is None:
            pyramid = self.backbone(images)
        maps = [pyramid[lvl] for lvl in LEVELS]
        anchors, counts = self.anchors([m.shape[1:3] for m in maps],
                                       maps[0].device)
        im_hw = im_hw.float()
        heads = [self.rpn(m) for m in maps]
        obj_logits = torch.cat([o for o, _ in heads], 1)
        rpn_deltas = torch.cat([d for _, d in heads], 1)
        boxes = clip_boxes(decode_boxes(anchors[None], rpn_deltas), im_hw)
        if proposal_index is None:
            proposals, rpn_mask, rpn_conv, index = fpn_proposals(
                obj_logits, boxes, counts, im_hw,
                pre_nms_top_n=self.rpn_pre_nms_top_n,
                post_nms_top_n=self.rpn_post_nms_top_n,
                nms_candidates=self.rpn_nms_candidates,
                nms_thresh=self.rpn_nms_thresh, nms_method=method,
                nms_rounds=self.nms_rounds)
        else:
            index, rpn_mask = proposal_index
            proposals = _take(boxes, index)
            rpn_conv = torch.ones_like(rpn_mask[:, 0])
        dets = self._detect(
            lambda p: multiscale_roi_align(maps[:4], p, STRIDES[:4],
                                           pooled=self.pool_size),
            proposals, rpn_mask, rpn_conv, index, im_hw, gt_boxes=gt_boxes,
            gt_mask=gt_mask, score_thresh=score_thresh,
            nms_candidates=nms_candidates, method=method)
        dets.update({"fmap": pyramid["pool"], "pyramid": pyramid,
                     "rpn_obj_logits": obj_logits, "rpn_deltas": rpn_deltas,
                     "anchors": anchors})
        return dets


def init_detector_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights with the initializers of ``init_weights``
    (He normal convs, lecun normal for the ResNet's and the dense layers,
    zero biases, identity BatchNorms), drawn on the CPU from one
    generator."""
    return init_weights(model, seed)


# ---------------------------------------------------------------------------
# training: target assignment, sampling and losses (torchvision RPN and
# RoIHeads semantics, sgg_tpu/models/detector.py:407-530), batched over
# images with fixed shapes


def _smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def assign_targets(boxes, gt_boxes, gt_mask, hi: float, lo: float,
                   allow_low_quality: bool = True):
    """torchvision Matcher over (B, K, 4) (or shared (K, 4)) boxes and
    (B, N, 4) GT boxes: label 1 where the best IoU >= hi, 0 where < lo,
    -1 between; with ``allow_low_quality`` every GT's best boxes are forced
    positive. Returns (labels (B, K) int64, matched GT index (B, K)); ties
    go to the lower index, as ``jnp.argmax``. Decisions only: the IoUs are
    taken on detached boxes."""
    iou = box_iou(boxes.detach(), gt_boxes.detach())  # (B, K, N)
    iou = torch.where(gt_mask[:, None, :], iou, -1.0)
    best = iou.max(dim=2).values
    matched = iou.argmax(dim=2)
    labels = torch.where(best >= hi, 1, torch.where(best < lo, 0, -1))
    if allow_low_quality:
        gt_best = torch.where(gt_mask, iou.max(dim=1).values, -2.0)
        force = (iou == gt_best[:, None, :]) & gt_mask[:, None, :] & (iou > 0)
        labels = torch.where(force.any(dim=2), 1, labels)
    return labels, matched


def _ranks(u: torch.Tensor) -> torch.Tensor:
    """Rank of each entry along the last axis (``argsort(argsort(u))``,
    stable: equal values rank by index)."""
    order = torch.argsort(u, dim=-1, stable=True)
    ar = torch.arange(u.shape[-1], device=u.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def sample_balanced(u_pos: torch.Tensor, u_neg: torch.Tensor,
                    labels: torch.Tensor, num: int, pos_fraction: float):
    """torchvision BalancedPositiveNegativeSampler from given uniforms
    (``_sample_balanced`` of the JAX package, whose two draws are ``u_pos``
    and ``u_neg``, each shaped like ``labels``): the positives of lowest
    ``u_pos`` up to ``int(num * pos_fraction)``, then the negatives of
    lowest ``u_neg`` up to ``num`` in all. Returns (pos, neg) masks."""
    n_pos_target = int(num * pos_fraction)
    is_pos, is_neg = labels == 1, labels == 0
    rank_p = _ranks(torch.where(is_pos, u_pos, 2.0))
    n_pos = is_pos.sum(-1, keepdim=True).clamp(max=n_pos_target)
    pos = is_pos & (rank_p < n_pos)
    rank_n = _ranks(torch.where(is_neg, u_neg, 2.0))
    n_neg = torch.minimum(is_neg.sum(-1, keepdim=True), num - n_pos)
    neg = is_neg & (rank_n < n_neg)
    return pos, neg


def balanced_draws(generator: Optional[torch.Generator], shape,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler's two uniforms in [0, 1), from ``generator`` (which lives
    on ``device``), ``u_pos`` first."""
    return (torch.rand(shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device))


def rpn_losses(draws, anchors, obj_logits, rpn_deltas, gt_boxes, gt_mask,
               batch_per_image: int = 256, pos_fraction: float = 0.5):
    """RPN objectness BCE + box smooth-L1 (torchvision compute_loss), per
    image over its sampled anchors, averaged over the batch. ``draws``:
    ``(u_pos, u_neg)`` (B, K)."""
    labels, matched = assign_targets(anchors, gt_boxes, gt_mask, 0.7, 0.3)
    pos, neg = sample_balanced(*draws, labels, batch_per_image, pos_fraction)
    sel = pos | neg
    tgt = encode_boxes(anchors, _take(gt_boxes, matched))
    box_l = torch.where(pos, _smooth_l1(rpn_deltas - tgt).sum(-1),
                        0.0).sum(-1)
    bce = F.binary_cross_entropy_with_logits(
        obj_logits, (labels == 1).float(), reduction="none")
    obj_l = torch.where(sel, bce, 0.0).sum(-1)
    denom = sel.sum(-1).clamp(min=1).float()
    return {"loss_rpn_box_reg": (box_l / denom).mean(),
            "loss_objectness": (obj_l / denom).mean()}


def append_gt_proposals(proposals, prop_mask, gt_boxes, gt_mask):
    """torchvision ``RoIHeads.add_gt_proposals`` with fixed shapes: the N GT
    slots overwrite the last N (lowest-score) proposal slots where
    ``gt_mask`` holds; a padded GT slot keeps its proposal and its mask."""
    N = gt_boxes.shape[1]
    if N == 0:
        return proposals, prop_mask
    tail_b = torch.where(gt_mask[..., None], gt_boxes, proposals[:, -N:])
    tail_m = prop_mask[:, -N:] | gt_mask
    return (torch.cat([proposals[:, :-N], tail_b], dim=1),
            torch.cat([prop_mask[:, :-N], tail_m], dim=1))


def roi_head_losses(draws, proposals, prop_mask, class_logits, box_deltas,
                    gt_boxes, gt_classes, gt_mask,
                    batch_per_image: int = 512, pos_fraction: float = 0.25):
    """RoI-head cross entropy + class-specific box smooth-L1 (torchvision
    fastrcnn_loss) over the sampled proposals, averaged over the batch.
    The box targets are encoded from the proposals with their graph, as in
    the JAX package. ``draws``: ``(u_pos, u_neg)`` (B, P)."""
    B, P, C = class_logits.shape
    labels, matched = assign_targets(proposals, gt_boxes, gt_mask, 0.5, 0.5,
                                     allow_low_quality=False)
    labels = torch.where(prop_mask, labels, -1)
    pos, neg = sample_balanced(*draws, labels, batch_per_image, pos_fraction)
    sel = pos | neg
    cls_target = torch.where(pos, torch.gather(gt_classes.long(), 1,
                                               matched), 0)
    denom = sel.sum(-1).clamp(min=1).float()
    ce = F.cross_entropy(class_logits.reshape(B * P, C),
                         cls_target.reshape(-1),
                         reduction="none").reshape(B, P)
    ce = torch.where(sel, ce, 0.0).sum(-1) / denom
    tgt = encode_boxes(proposals, _take(gt_boxes, matched),
                       weights=ROI_WEIGHTS)
    per_cls = torch.gather(box_deltas.reshape(B, P, C, 4), 2,
                           cls_target[..., None, None].expand(B, P, 1, 4))
    box_l = torch.where(pos, _smooth_l1(per_cls[:, :, 0] - tgt).sum(-1),
                        0.0).sum(-1) / denom
    return {"loss_classifier": ce.mean(), "loss_box_reg": box_l.mean()}
