"""Scene-graph evaluation: Recall@K / mean-Recall / per-triplet statistics.

Numpy-parity rebuild of the reference evaluator
(``lib/sgg_eval.py``, itself derived from Danfei Xu's and
KERN's community-standard code). The metric semantics are pinned exactly —
they are the contract every model is judged by:

* Graph-constrained (GC): one predicate per predicted pair (argmax over
  non-background predicate scores), pairs ranked by the caller
  (``filter_dets`` order). No-GC (``multiple_preds``): every (pair, predicate)
  combination scored ``obj0 * obj1 * rel_score`` and the top
  ``MAX_RECALL_K=300`` kept (``sgg_eval.py:195-203``).
* A prediction matches a GT relation iff the (subj_class, predicate,
  obj_class) triplet matches exactly AND both boxes have IoU ≥ 0.5 with the
  GT boxes (``sgg_eval.py:377-417``); ``phrdet`` matches the union box
  instead.
* Recall@K = |GT relations matched by the top-K predictions| / |GT|
  (union semantics — one prediction can match several GTs,
  ``sgg_eval.py:223-230``).
* Modes: predcls substitutes GT boxes+classes, sgcls GT boxes, sgdet uses
  detections; objcls/preddet/phrdet input substitutions as in
  ``sgg_eval.py:142-192``.
* Mean recall: per-predicate evaluators averaged KERN-style
  (``sgg_eval.py:420-481``).
* Per-triplet ranks and inverse-frequency-normalized recalls
  (``sgg_eval.py:213-273``).

This module is pure numpy on the host — it mirrors the reference's role as a
reporting-grade evaluator. It is the port's own copy of
``sgg_tpu/eval/sgg_eval.py``; the two packages share no code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from sgg_torch.constants import MAX_RECALL_K, RECALL_KS


# ---------------------------------------------------------------------------
# small numpy utilities (reference lib/pytorch_misc.py analogues)

def intersect_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, d) x (M, d) -> (N, M) bool: rows equal elementwise."""
    if a.shape[1] != b.shape[1]:
        raise ValueError("arrays must have the same row width")
    return (a[:, None] == b[None]).all(-1)


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    """Indices (as coordinate rows) of scores sorted descending."""
    return np.column_stack(
        np.unravel_index(np.argsort(-scores.ravel()), scores.shape))


def np_box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, torchvision semantics (no +1)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)
    return iou


# ---------------------------------------------------------------------------
# core matching

def _to_triplets(rel_pairs, predicates, classes, boxes):
    """(E,2) pairs + (E,) predicates -> class triplets + paired boxes."""
    so_cls = classes[rel_pairs]
    triplets = np.column_stack([so_cls[:, 0], predicates, so_cls[:, 1]])
    triplet_boxes = np.column_stack([boxes[rel_pairs[:, 0]],
                                     boxes[rel_pairs[:, 1]]])
    return triplets, triplet_boxes


def match_predictions(gt_triplets, gt_boxes8, pred_triplets, pred_boxes8,
                      iou_thresh: float = 0.5,
                      phrdet: bool = False) -> List[List[int]]:
    """For each prediction, the list of GT relation indices it matches.

    Exact class-triplet match + both-box IoU test (union-box IoU for phrdet).
    Reference: ``_compute_pred_matches`` (sgg_eval.py:377-417).
    """
    keeps = intersect_2d(gt_triplets, pred_triplets)
    pred_to_gt: List[List[int]] = [[] for _ in range(len(pred_triplets))]
    for gt_ind in np.nonzero(keeps.any(1))[0]:
        gt_box = gt_boxes8[gt_ind]
        cand = np.nonzero(keeps[gt_ind])[0]
        boxes = pred_boxes8[cand]
        if phrdet:
            gt_union = np.concatenate([np.minimum(gt_box[:2], gt_box[4:6]),
                                       np.maximum(gt_box[2:4], gt_box[6:])])
            pred_union = np.concatenate(
                [np.minimum(boxes[:, :2], boxes[:, 4:6]),
                 np.maximum(boxes[:, 2:4], boxes[:, 6:])], axis=1)
            ok = np_box_iou(gt_union[None], pred_union)[0] >= iou_thresh
        else:
            sub_iou = np_box_iou(gt_box[None, :4], boxes[:, :4])[0]
            obj_iou = np_box_iou(gt_box[None, 4:], boxes[:, 4:])[0]
            ok = (sub_iou >= iou_thresh) & (obj_iou >= iou_thresh)
        for p in cand[ok]:
            pred_to_gt[int(p)].append(int(gt_ind))
    return pred_to_gt


def rank_predicted_rels(pred_rel_inds: np.ndarray, rel_scores: np.ndarray,
                        obj_scores: np.ndarray, multiple_preds: bool,
                        max_k: Optional[int] = MAX_RECALL_K):
    """Turn per-pair predicate distributions into a ranked relation list.

    GC: argmax non-bg predicate per pair, caller's pair order kept.
    No-GC: all (pair, predicate) combos scored obj0*obj1*rel and sorted,
    top ``max_k`` kept (``None`` = keep all, used for per-triplet ranks).
    Reference: ``evaluate_from_dict`` (sgg_eval.py:195-203,239-240).

    Returns (pred_rels (M,3) [s_idx, o_idx, predicate], predicate_scores (M,)).
    """
    if multiple_preds:
        obj_scores_per_rel = obj_scores[pred_rel_inds].prod(1)
        overall = obj_scores_per_rel[:, None] * rel_scores[:, 1:]
        score_inds = argsort_desc(overall)
        if max_k is not None:
            score_inds = score_inds[:max_k]
        pred_rels = np.column_stack(
            [pred_rel_inds[score_inds[:, 0]], score_inds[:, 1] + 1])
        predicate_scores = rel_scores[score_inds[:, 0], score_inds[:, 1] + 1]
    else:
        pred_rels = np.column_stack(
            [pred_rel_inds, 1 + rel_scores[:, 1:].argmax(1)])
        predicate_scores = rel_scores[:, 1:].max(1)
    return pred_rels, predicate_scores


def evaluate_recall(gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes,
                    pred_classes, iou_thresh: float = 0.5,
                    phrdet: bool = False) -> List[List[int]]:
    """pred_to_gt matching for one image (reference sgg_eval.py:280-341)."""
    if pred_rels.size == 0:
        return [[]]
    assert gt_rels.shape[0] > 0
    gt_triplets, gt_boxes8 = _to_triplets(gt_rels[:, :2], gt_rels[:, 2],
                                          gt_classes, gt_boxes)
    assert pred_rels[:, :2].max() < pred_classes.shape[0]
    assert np.all(pred_rels[:, 2] > 0)
    pred_triplets, pred_boxes8 = _to_triplets(pred_rels[:, :2],
                                              pred_rels[:, 2], pred_classes,
                                              pred_boxes)
    return match_predictions(gt_triplets, gt_boxes8, pred_triplets,
                             pred_boxes8, iou_thresh, phrdet)


def recall_at_ks(pred_to_gt: List[List[int]], num_gt: int,
                 ks: Sequence[int] = RECALL_KS) -> Dict[int, float]:
    """Union-semantics Recall@K (reference sgg_eval.py:223-230)."""
    out = {}
    for k in ks:
        matched = set()
        for matches in pred_to_gt[:k]:
            matched.update(matches)
        out[k] = len(matched) / num_gt
    return out


# ---------------------------------------------------------------------------
# evaluator

def triplet_key(subj_cls: int, predicate: int, obj_cls: int) -> str:
    """Triplet-count dictionary key (reference sgg_eval.py:217)."""
    return f"{subj_cls}_{predicate}_{obj_cls}"


class SGGEvaluator:
    """Accumulates per-image recalls for one mode.

    API analogue of ``BasicSceneGraphEvaluator`` (sgg_eval.py:15-275);
    internals are vectorized fresh code pinned by golden tests.
    """

    TRIPLET_KS = (5, 10, 15, 20, 50)

    def __init__(self, mode: str, multiple_preds: bool = False,
                 triplet_counts: Optional[dict] = None,
                 per_triplet: bool = False, ks: Sequence[int] = RECALL_KS):
        assert mode in ("predcls", "sgcls", "sgdet", "phrdet", "preddet",
                        "objcls"), mode
        self.mode = mode
        self.multiple_preds = multiple_preds
        self.per_triplet = per_triplet
        self.triplet_counts = triplet_counts or {}
        self.ks = tuple(ks)
        self.recalls: Dict[int, List[float]] = {k: [] for k in self.ks}
        self.recalls_norm: Dict[int, List[float]] = {k: [] for k in self.ks}
        self.ranks: List[float] = []
        self.rank_counts: List[float] = []
        self.triplet_ranks: Dict[str, List[float]] = {}

    # -- input substitution per mode (reference sgg_eval.py:142-192)
    def _substitute(self, gt_entry, pred_entry):
        gt_rels = np.asarray(gt_entry["gt_relations"])
        gt_boxes = np.asarray(gt_entry["gt_boxes"], dtype=float)
        gt_classes = np.asarray(gt_entry["gt_classes"])
        pred_rel_inds = np.asarray(pred_entry["pred_rel_inds"])
        rel_scores = np.asarray(pred_entry["rel_scores"])
        if self.mode == "predcls":
            pred_boxes = gt_boxes
            pred_classes = gt_classes
            obj_scores = np.ones(gt_classes.shape[0])
        elif self.mode in ("sgcls", "objcls"):
            pred_boxes = gt_boxes
            pred_classes = np.asarray(pred_entry["pred_classes"])
            obj_scores = np.asarray(pred_entry["obj_scores"])
            if self.mode == "objcls":
                # assume perfect predicate recognition (sgg_eval.py:155-158)
                pred_rel_inds = gt_rels[:, :2]
                rel_scores = np.zeros((len(gt_rels), rel_scores.shape[1]))
                rel_scores[np.arange(len(gt_rels)), gt_rels[:, 2]] = 1
        elif self.mode in ("sgdet", "phrdet", "preddet"):
            # preddet only consumes pred_rel_inds/rel_scores; boxes pass
            # through untouched (sgg_eval.py:164-191)
            pred_boxes = np.asarray(pred_entry["pred_boxes"], dtype=float)
            pred_classes = np.asarray(pred_entry["pred_classes"])
            obj_scores = np.asarray(pred_entry["obj_scores"])
        else:
            raise ValueError(self.mode)
        return (gt_rels, gt_boxes, gt_classes, pred_rel_inds, rel_scores,
                pred_boxes, pred_classes, obj_scores)

    def _gt_weights(self, gt_rels, gt_classes):
        counts = np.zeros(len(gt_rels))
        for i, (s, o, p) in enumerate(gt_rels):
            counts[i] = self.triplet_counts.get(
                triplet_key(gt_classes[s], p, gt_classes[o]), 0)
        return normalize_counts(counts)

    def add_image(self, gt_entry: dict, pred_entry: dict,
                  iou_thresh: float = 0.5) -> Optional[List[List[int]]]:
        """Evaluate one image and accumulate (reference evaluate_from_dict)."""
        (gt_rels, gt_boxes, gt_classes, pred_rel_inds, rel_scores, pred_boxes,
         pred_classes, obj_scores) = self._substitute(gt_entry, pred_entry)

        if self.mode == "preddet":
            # Only predictions over GT pairs are ranked (sgg_eval.py:164-191).
            prc = intersect_2d(pred_rel_inds, gt_rels[:, :2])
            if prc.size == 0:
                for k in self.ks:
                    self.recalls[k].append(0.0)
                    if self.per_triplet:
                        self.recalls_norm[k].append(0.0)
                return None
            sel = prc.argmax(0)
            sel_inds = pred_rel_inds[sel]
            sel_scores = rel_scores[sel]
            order = argsort_desc(sel_scores[:, 1:])
            ranked = np.column_stack([sel_inds[order[:, 0]], order[:, 1] + 1])
            matches = intersect_2d(ranked, gt_rels)
            for k in self.ks:
                rec = float(matches[:k].any(0).sum()) / float(len(gt_rels))
                self.recalls[k].append(rec)
                if self.per_triplet:
                    self.recalls_norm[k].append(rec)
            return None

        pred_rels, _ = rank_predicted_rels(pred_rel_inds, rel_scores,
                                           obj_scores, self.multiple_preds)
        pred_to_gt = evaluate_recall(gt_rels, gt_boxes, gt_classes, pred_rels,
                                     pred_boxes, pred_classes, iou_thresh,
                                     phrdet=self.mode == "phrdet")
        weights = (self._gt_weights(gt_rels, gt_classes)
                   if self.per_triplet else None)
        for k in self.ks:
            matched = set()
            for m in pred_to_gt[:k]:
                matched.update(m)
            self.recalls[k].append(len(matched) / len(gt_rels))
            if self.per_triplet:
                idx = np.asarray(sorted(matched), dtype=int)
                self.recalls_norm[k].append(float(weights[idx].sum()))

        if self.per_triplet:
            self._add_triplet_ranks(gt_rels, gt_boxes, gt_classes,
                                    pred_rel_inds, rel_scores, obj_scores,
                                    pred_boxes, pred_classes)
        return pred_to_gt

    def _add_triplet_ranks(self, gt_rels, gt_boxes, gt_classes, pred_rel_inds,
                           rel_scores, obj_scores, pred_boxes, pred_classes):
        """Per-GT-relation rank of its first matching prediction in the
        unconstrained ranking restricted to the same box pair
        (reference sgg_eval.py:236-272 — its "naive and slow" per-relation
        ``evaluate_recall`` loop, vectorized here over (rankings x GT);
        parity-tested against the reference in
        tests/test_eval_reference_parity.py)."""
        ranked, _ = rank_predicted_rels(pred_rel_inds, rel_scores, obj_scores,
                                        multiple_preds=True, max_k=None)
        iou = np_box_iou(pred_boxes.astype(float), gt_boxes.astype(float))
        r_sub, r_obj, r_p = ranked[:, 0], ranked[:, 1], ranked[:, 2]
        for s, o, p in gt_rels:
            key = triplet_key(gt_classes[s], p, gt_classes[o])
            same_pair = ((r_sub == s) & (r_obj == o)) | \
                        ((r_sub == o) & (r_obj == s))
            match = (same_pair & (r_p == p)
                     & (pred_classes[r_sub] == gt_classes[s])
                     & (pred_classes[r_obj] == gt_classes[o])
                     & (iou[r_sub, s] >= 0.5) & (iou[r_obj, o] >= 0.5))
            hits = np.nonzero(match)[0]
            if hits.size:
                # rank within the same-pair candidate subset
                rank = float(same_pair[:hits[0]].sum())
            else:
                rank = float(MAX_RECALL_K + 1)
            self.ranks.append(rank)
            self.rank_counts.append(float(self.triplet_counts.get(key, 0)))
            self.triplet_ranks.setdefault(key, []).append(rank)

    def save(self, fn: str) -> None:
        """Dump the accumulated evaluator state (reference
        ``BasicSceneGraphEvaluator.save``, sgg_eval.py:57-58)."""
        np.save(fn, {
            "mode": self.mode,
            "multiple_preds": self.multiple_preds,
            "recalls": self.recalls,
            "recalls_norm": self.recalls_norm,
            "ranks": self.ranks,
            "rank_counts": self.rank_counts,
            "triplet_ranks": self.triplet_ranks,
        })

    # -- reporting (reference print_stats, sgg_eval.py:65-120)
    def mean_recalls(self) -> Dict[int, float]:
        return {k: float(np.mean(v)) if len(v) else float("nan")
                for k, v in self.recalls.items()}

    def results(self, verbose: bool = False) -> Dict[str, float]:
        out = {}
        for k, v in self.mean_recalls().items():
            out[f"R@{k}"] = v
        if self.per_triplet and self.ranks:
            ranks = np.asarray(self.ranks, np.float32)
            counts = np.asarray(self.rank_counts, np.float32)
            weights = normalize_counts(counts)
            for k in self.TRIPLET_KS:
                rec = ranks < k
                out[f"tripletR@{k}"] = float(rec.mean())
                out[f"tripletR@{k}_norm"] = float((rec * weights).sum())
            out["meanrank_triplet"] = float(ranks.mean())
            out["meanrank_triplet_norm"] = float((ranks * weights).sum())
            out["medianrank_triplet"] = float(np.median(ranks))
            medians, mcounts = [], []
            for key, v in self.triplet_ranks.items():
                if v:
                    medians.append(np.median(v))
                    mcounts.append(self.triplet_counts.get(key, 0))
            if medians:
                medians = np.asarray(medians)
                w = normalize_counts(np.asarray(mcounts, np.float32))
                out["medianrankclass_triplet"] = float(medians.mean())
                out["medianrank_triplet_norm"] = float((medians * w).sum())
        if verbose:
            gc = "(NO GC)" if self.multiple_preds else "(GC)"
            n = len(next(iter(self.recalls.values())))
            print(f"================{self.mode}{gc}: {n} images ================")
            for k in self.ks:
                print("R@%i: %f" % (k, out[f"R@{k}"]))
        return out


def normalize_counts(counts: np.ndarray) -> np.ndarray:
    """Inverse-frequency weights summing to 1 (reference sgg_eval.py:60-63)."""
    weights = 1.0 / (counts + 1)
    return weights / weights.sum()


# ---------------------------------------------------------------------------
# mean recall over predicates (reference sgg_eval.py:420-500)

class MeanRecallEvaluator:
    """Per-predicate evaluators averaged into mR@K (KERN-style)."""

    def __init__(self, mode: str, predicate_names: Sequence[str],
                 multiple_preds: bool = False, ks: Sequence[int] = RECALL_KS):
        # predicate_names[0] is background and excluded.
        self.mode = mode
        self.ks = tuple(ks)
        self.predicate_names = list(predicate_names)[1:]
        self.evaluators = [
            SGGEvaluator(mode, multiple_preds=multiple_preds, ks=ks)
            for _ in self.predicate_names]

    def add_image(self, gt_entry: dict, pred_entry: dict):
        gt_rels = np.asarray(gt_entry["gt_relations"])
        for pred_id, ev in enumerate(self.evaluators, start=1):
            mask = gt_rels[:, 2] == pred_id
            if not mask.any():
                continue
            sub_entry = dict(gt_entry)
            sub_entry["gt_relations"] = gt_rels[mask]
            ev.add_image(sub_entry, pred_entry)

    def results(self) -> Dict[str, float]:
        """mR@K: nan-recall predicates contribute 0 but stay in the
        denominator (reference sgg_eval.py:442-455)."""
        out = {}
        for k in self.ks:
            total = 0.0
            for ev in self.evaluators:
                r = ev.mean_recalls()
                if not np.isnan(r[100 if 100 in r else k]):
                    total += r[k]
            out[f"mR@{k}"] = total / len(self.evaluators)
        return out
