"""SGDet: scene-graph detection, the frozen detector feeding the relation
head.

Counterpart of ``sgg_tpu/models/sgdet.py`` (reference
``sgg_models/rel_model_base.py:209-242`` detector branch and
``rel_model_stanford.py``): the frozen Faster R-CNN makes up to 50
detections an image; candidate pairs are the ordered detection pairs that
overlap (``rel_model_base.py:152-154``); training targets come from
``rel_assignments``; the IMP head then classifies objects and predicates as
in SGCls, on the detector's feature map.

The JAX package picks the pair-budget rung inside its compiled program. A
PyTorch program cannot choose a shape from a device value without waiting
for the card, so the retry eval step has two stages that never wait:
``detect`` (detector, per-image threshold, pairs, and the exactness flags)
and ``relate`` (relation head at a given rung); ``sgdet_eval_with_retry``
reads the flags once between them, in one device-to-host copy a pass, and
picks the rung and any escalation from them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sgg_torch.config import Config
from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.device import resolve_device
from sgg_torch.ops.boxes import box_iou
from sgg_torch.train.assign import (all_pairs, compact_pairs,
                                    unordered_union_index)
from sgg_torch.train.losses import edge_losses, node_losses
from sgg_torch.train.rel_assign import rel_assignments
from sgg_torch.train.state import Optimizer
from sgg_torch.utils import counters

# default candidate-pair budget of the compacted eval step: covers any image
# with up to ~32 mutually overlapping detections, with an exact dense
# fall-back beyond it
SGDET_EVAL_MAX_PAIRS = 1024
THRESHOLDS = (0.2, 0.05, 0.01)  # the reference's retry ladder, eval.py:125


def detection_pairs(det_boxes, det_mask, require_overlap: bool):
    """Candidate pairs over detections (rel_model_base.py:148-163). With
    ``require_overlap`` an image whose detections do not overlap at all
    gets ONE (0, 0) self-pair (rel_model_base.py:159-161), not all pairs."""
    pairs, pair_mask = all_pairs(det_mask)
    if require_overlap:
        B, D = det_mask.shape
        iou = box_iou(det_boxes, det_boxes).reshape(B, D * D)
        ov = torch.gather(iou, 1, pairs[..., 0] * D + pairs[..., 1])
        overlap_mask = pair_mask & (ov > 0)
        any_overlap = overlap_mask.any(dim=1)  # (B,)
        slot0 = torch.arange(pair_mask.shape[1],
                             device=pair_mask.device)[None, :] == 0
        fb_mask = slot0 & ~any_overlap[:, None] & det_mask[:, 0:1]
        pairs = torch.where(any_overlap[:, None, None], pairs, 0)
        pair_mask = torch.where(any_overlap[:, None], overlap_mask, fb_mask)
    return pairs, pair_mask


NODE_KEYS = ("det_boxes", "det_labels", "det_scores", "obj_logits",
             "obj_preds", "obj_scores")
PAIR_KEYS = ("rel_logits", "rel_dists", "pairs")


def _zero_padded(out, det_mask, pair_mask):
    """Zero every output entry outside its validity mask, so a run whose
    threshold was applied afterwards is byte-comparable to one detected at
    that threshold, and exported outputs carry no garbage rows."""
    for keys, m in ((NODE_KEYS, det_mask), (PAIR_KEYS, pair_mask)):
        for k in keys:
            if k in out:
                v = out[k]
                out[k] = torch.where(
                    m.reshape(m.shape + (1,) * (v.dim() - 2)), v,
                    torch.zeros((), dtype=v.dtype, device=v.device))
    return out


def _cached(batch: GraphBatch) -> Dict[str, torch.Tensor]:
    """A feature-cache batch carries the VGG16 trunk's map: the detector
    starts at the RPN (the FPN detector is never cached)."""
    return {} if batch.fmaps is None else {"fmap": batch.fmaps}


def _pad_edges(x: torch.Tensor, size: int) -> torch.Tensor:
    """Pad the edge axis (1) with zero slots up to ``size``."""
    pad = size - x.shape[1]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


class SgdetRetryEvalStep:
    """One SGDet eval pass with per-image threshold selection
    (``make_sgdet_retry_eval_step`` of the JAX package).

    The reference re-detects an image at lower score thresholds (0.2 ->
    0.05 -> 0.01) until it has >= 2 detections (lib/eval.py:125-133,
    227-228). The detector's NMS keeps in descending score order and each
    keep depends only on higher-scored keeps, so the detections at
    threshold t are the ``score > t`` prefix of those at the lowest one
    (when at most ``nms_candidates`` candidates clear it): one detector
    pass at min(thresholds) gives every threshold's detections by masking.

    ``detect(batch)`` runs the detector, selects per image the first
    threshold with >= 2 detections (else the last) and builds the candidate
    pairs; ``relate(det, rung, dedup)`` runs the relation head on the pairs
    compacted to ``rung`` (``None``: all) and pads the edge axis to the top
    rung. Neither waits for the card. ``rungs`` is the ladder: the
    ``pair_ladder`` budgets below ``max_pairs``, then ``max_pairs``; with
    no ``max_pairs`` (or one at or above the dense count) the pairs stay
    dense. ``__call__`` is ``relate(detect(batch))`` at the smallest rung
    that covers the batch, which it reads from the card.
    """

    def __init__(self, detector, relmodel, thresholds=THRESHOLDS,
                 require_overlap: bool = True,
                 max_pairs: Optional[int] = None, dedup: bool = True,
                 pair_ladder: Sequence[int] = (256,),
                 nms_method: Optional[str] = None,
                 nms_candidates: Optional[int] = None, device="cuda"):
        self.detector, self.relmodel = detector, relmodel
        self.ts = sorted(thresholds, reverse=True)
        self.require_overlap = require_overlap
        self.dedup = dedup
        self.nms_method, self.nms_candidates = nms_method, nms_candidates
        self.device = resolve_device(device)
        D = detector.detections_per_img
        self.n_pairs = D * (D - 1)
        self.rungs = ()
        if max_pairs is not None and max_pairs < self.n_pairs:
            self.rungs = tuple(sorted({r for r in (pair_ladder or ())
                                       if r < max_pairs})) + (max_pairs,)
        # made once here: a host-to-device copy inside a step would wait
        self._ts = torch.tensor(self.ts, dtype=torch.float32,
                                device=self.device)

    @torch.inference_mode()
    def detect(self, batch: GraphBatch) -> Dict[str, torch.Tensor]:
        batch = batch.to(self.device)
        self.detector.eval()
        det = self.detector(batch.images, batch.im_hw, **_cached(batch),
                            score_thresh=self.ts[-1],
                            nms_method=self.nms_method,
                            nms_candidates=self.nms_candidates)
        base_mask, scores = det["mask"], det["scores"]
        # per image the first threshold with >= 2 detections, else the last
        masks_t = torch.stack([base_mask & (scores > t) for t in self.ts], 1)
        ok = masks_t.sum(dim=2) >= 2  # (B, T)
        sel = torch.where(ok.any(dim=1), ok.int().argmax(dim=1),
                          len(self.ts) - 1)
        mask = torch.gather(masks_t, 1, sel[:, None, None].expand(
            -1, 1, masks_t.shape[2]))[:, 0]
        boxes = torch.where(mask[..., None], det["boxes"], 0.0)
        pairs, pair_mask = detection_pairs(boxes, mask, self.require_overlap)
        _, _, _, n_unique = unordered_union_index(
            pairs, pair_mask, 1, num_nodes=mask.shape[1])
        return {"fmap": det["fmap"], "det_boxes": boxes,
                "det_labels": torch.where(mask, det["labels"], 0),
                "det_scores": torch.where(mask, scores, 0.0),
                "det_mask": mask, "pairs": pairs, "pair_mask": pair_mask,
                "sel_thresh": self._ts[sel],
                "pair_count": pair_mask.sum(dim=1), "n_unique": n_unique,
                "n_nms_candidates": det["n_candidates"],
                "nms_converged": det["nms_converged"]}

    def flags(self, det) -> Dict[str, int]:
        """The four exactness flags of a ``detect`` output, in one
        device-to-host copy."""
        v = torch.stack([det["nms_converged"].all().long(),
                         det["n_nms_candidates"].max().long(),
                         det["pair_count"].max().long(),
                         det["n_unique"].max().long()]).tolist()
        return dict(zip(("converged", "n_candidates", "pair_count",
                         "n_unique"), v))

    def rung_for(self, pair_count: int) -> Optional[int]:
        """The smallest rung covering ``pair_count`` (the top one if none
        does; ``None`` without a ladder)."""
        if not self.rungs:
            return None
        return next((r for r in self.rungs if r >= pair_count),
                    self.rungs[-1])

    @torch.inference_mode()
    def relate(self, det, rung: Optional[int] = None,
               dedup: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        dedup = self.dedup if dedup is None else dedup
        self.relmodel.eval()
        pairs, pair_mask = det["pairs"], det["pair_mask"]
        if rung is not None:
            pairs, pair_mask, _ = compact_pairs(pairs, pair_mask, rung)
        out = self.relmodel(None, det["det_boxes"], det["det_labels"], pairs,
                            pair_mask, fmap=det["fmap"], mode="sgdet",
                            dedup_unions=dedup)
        if rung is not None:  # pad the edge axis to the top rung
            top = self.rungs[-1]
            out["rel_logits"] = _pad_edges(out["rel_logits"], top)
            pairs, pair_mask = _pad_edges(pairs, top), _pad_edges(pair_mask,
                                                                  top)
        out.update({k: det[k] for k in (
            "det_boxes", "det_labels", "det_scores", "det_mask", "sel_thresh",
            "pair_count", "n_nms_candidates", "nms_converged")})
        out.update({"pairs": pairs, "pair_mask": pair_mask,
                    "rel_dists": torch.softmax(out["rel_logits"], dim=-1),
                    "n_det": det["det_mask"].sum(dim=1)})
        return _zero_padded(out, det["det_mask"], pair_mask)

    def __call__(self, batch: GraphBatch) -> Dict[str, torch.Tensor]:
        det = self.detect(batch)
        rung = self.rung_for(self.flags(det)["pair_count"]) \
            if self.rungs else None
        return self.relate(det, rung)


def make_sgdet_retry_eval_step(detector, relmodel, thresholds=THRESHOLDS,
                               require_overlap: bool = True,
                               max_pairs: Optional[int] = None,
                               dedup: bool = True, pair_ladder=(256,),
                               nms_method: Optional[str] = None,
                               nms_candidates: Optional[int] = None,
                               device="cuda") -> SgdetRetryEvalStep:
    """The retry eval step (``SgdetRetryEvalStep``) on ``device``, the card
    unless the caller asks for the CPU. ``nms_method``/``nms_candidates``
    override the detector's own for this step (the escalations of
    ``sgdet_eval_with_retry``; the one detector instance is shared)."""
    return SgdetRetryEvalStep(detector, relmodel, thresholds,
                              require_overlap, max_pairs, dedup, pair_ladder,
                              nms_method, nms_candidates, device)


def make_sgdet_eval_step(detector, relmodel, score_thresh: float = 0.2,
                         require_overlap: bool = True, dedup: bool = True,
                         device="cuda"):
    """``eval_step(batch) -> outputs`` at one score threshold: detection
    boxes, classes and scores plus the relation outputs over all
    overlapping detection pairs (no retry, no compaction)."""
    step = SgdetRetryEvalStep(detector, relmodel, (score_thresh,),
                              require_overlap, None, dedup, (), None, None,
                              device)

    def eval_step(batch: GraphBatch) -> Dict[str, torch.Tensor]:
        out = step.relate(step.detect(batch))
        for k in ("sel_thresh", "pair_count"):
            del out[k]
        return out

    return eval_step


def sgdet_eval_with_retry(detector, relmodel, batch: GraphBatch,
                          thresholds=THRESHOLDS, require_overlap: bool = True,
                          max_pairs: Optional[int] = SGDET_EVAL_MAX_PAIRS,
                          device="cuda") -> Dict[str, np.ndarray]:
    """Per-image box-threshold retry (reference lib/eval.py:125-133,
    227-228) in one detector pass, with every exactness cap checked and
    escalated (``sgdet_eval_with_retry`` of the JAX package):

    * rounds-NMS budget: an image not converged (a suppression chain deeper
      than ``detector.nms_rounds``) re-detects with ``sequential`` NMS;
    * NMS candidate cap: more candidates clearing the lowest threshold than
      the cap kept re-detects with the cap doubled until it covers;
    * pair budget: more valid pairs than ``max_pairs`` runs the relation
      head on the dense pairs;
    * unordered-union dedup: more unique pairs than half the edge budget
      runs the relation head without dedup.

    Each pass reads the four flags in one device-to-host copy; a re-run
    re-checks all of them. The events count in ``sgg_torch.utils.counters``
    (``sgdet_batches``, ``sgdet_nms_unconverged``,
    ``sgdet_nms_cand_overflow``, ``sgdet_pair_overflow``,
    ``sgdet_dedup_fallback``). Returns the outputs as numpy arrays.
    """
    counters.bump("sgdet_batches")
    method = detector.nms_method
    cap = detector.nms_candidates
    mp = max_pairs
    batch = batch.to(resolve_device(device))

    def make(method, cap, mp):
        return make_sgdet_retry_eval_step(
            detector, relmodel, thresholds=thresholds,
            require_overlap=require_overlap, max_pairs=mp,
            nms_method=method, nms_candidates=cap, device=device)

    step = make(method, cap, mp)
    det = step.detect(batch)
    flags = step.flags(det)
    # each escalation is monotone (sequential NMS stays, the cap only
    # grows), so this ends; the bound is a safety net
    for _ in range(8):
        if not flags["converged"] and method != "sequential":
            counters.bump("sgdet_nms_unconverged")
            method = "sequential"
        elif flags["n_candidates"] > cap:
            counters.bump("sgdet_nms_cand_overflow")
            while cap < flags["n_candidates"]:
                cap *= 2
        else:
            break
        step = make(method, cap, mp)
        det = step.detect(batch)
        flags = step.flags(det)
    if mp is not None and flags["pair_count"] > mp:
        counters.bump("sgdet_pair_overflow")
        step = make(method, cap, None)
    rung = step.rung_for(flags["pair_count"])
    edges = rung if rung is not None else step.n_pairs
    dedup = flags["n_unique"] <= max(edges // 2, 1)
    if not dedup:
        counters.bump("sgdet_dedup_fallback")
    out = step.relate(det, rung, dedup)
    return {k: v.cpu().numpy() for k, v in out.items()}


def make_sgdet_train_step(detector, relmodel, config: Config,
                          optimizer: Optimizer, require_overlap: bool = True):
    """Returns ``train_step(batch, generator, rels=None) -> metrics``: the
    frozen detector (under ``torch.no_grad()``) -> ``rel_assignments`` ->
    the relation head in train mode -> node and edge losses -> clipped SGD
    of the relation model (``optimizer``; the detector is not in it).

    Object targets are the class of each detection's best-IoU GT box at
    IoU >= 0.5, else background. ``rels``, a ``(rels, mask)`` pair as
    ``rel_assignments`` returns, replaces the sampler. The generator lives
    on ``config.device``; the sampler draws from it first, then dropout.
    The metrics (``obj_loss``, ``rel_loss``, ``total``,
    ``nms_converged_frac``: the share of images whose NMS provably gave the
    greedy result) are device scalars; the step does not wait for the
    card.
    """
    dev = resolve_device(config.device)
    loss_weights = (config.alpha, config.beta, config.gamma)

    def train_step(batch: GraphBatch, generator: Optional[torch.Generator],
                   rels=None) -> Dict[str, torch.Tensor]:
        batch = batch.to(dev)
        detector.eval()
        with torch.no_grad():
            det = detector(batch.images, batch.im_hw, **_cached(batch))
        boxes, labels, mask = det["boxes"], det["labels"], det["mask"]
        if rels is None:
            rels = rel_assignments(
                generator, boxes, labels, mask, batch.boxes, batch.classes,
                batch.rels, batch.rel_mask,
                filter_non_overlap=require_overlap)
        sampled, rel_mask = rels[0].to(dev, torch.long), rels[1].to(dev)
        pairs, rel_labels = sampled[..., :2], sampled[..., 2]

        iou = box_iou(boxes, batch.boxes)
        iou = torch.where(batch.node_mask[:, None, :], iou, -1.0)
        best = iou.max(dim=2).values
        matched = iou.argmax(dim=2)  # the first maximum, as jnp.argmax
        obj_targets = torch.where(
            best >= 0.5, torch.gather(batch.classes, 1, matched), 0)

        relmodel.train()
        optimizer.zero_grad()
        out = relmodel(None, boxes, labels, pairs, rel_mask,
                       fmap=det["fmap"], mode="sgdet", generator=generator)
        losses = {}
        losses.update(node_losses(out["obj_logits"], obj_targets, mask))
        losses.update(edge_losses(out["rel_logits"], rel_labels, rel_mask,
                                  config.loss, loss_weights))
        total = sum(losses.values())
        total.backward()
        optimizer.apply_gradients()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        metrics["nms_converged_frac"] = det["nms_converged"].float().mean()
        return metrics

    return train_step
