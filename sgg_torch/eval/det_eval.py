"""Object-detection evaluation: COCO-style mAP over IoU thresholds.

The port's copy of ``sgg_tpu/eval/det_eval.py`` (numpy only). It replaces
the reference's pycocotools plumbing (``detector/coco_eval.py``,
``coco_utils.py`` — a faux-COCO conversion of VG feeding
``CocoEvaluator``) with a self-contained numpy implementation of the same
protocol: per-class average precision with 101-point interpolation,
greedy matching to GT by descending score at each IoU threshold, the
maxDets=100 per-(image, class) cap, averaged over IoU 0.5:0.95 (plus
AP50/AP75 reported separately). Differentially validated against an
independent COCOeval-protocol oracle in the JAX package's tests; the
port's is held against the JAX package's (tests/test_torch_det_eval.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from sgg_torch.eval.sgg_eval import np_box_iou

COCO_IOUS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point interpolated AP (recall is nondecreasing — it comes
    from a cumsum over score-ordered detections)."""
    # precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, grid, side="left")
    p = np.where(idx < len(precision),
                 precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(p.mean())


class DetectionEvaluator:
    """Accumulates per-image detections/GT and computes mAP.

    ``max_dets``: per-(image, class) cap on scored detections before
    matching (pycocotools maxDets, default 100).
    """

    def __init__(self, num_classes: int, ious: Sequence[float] = COCO_IOUS,
                 max_dets: int = 100):
        self.num_classes = num_classes
        self.ious = tuple(ious)
        self.max_dets = max_dets
        # per class: list of (score, tp-flags over self.ious) tuples
        self._dets: Dict[int, List] = {c: [] for c in range(1, num_classes)}
        self._gt_count = np.zeros(num_classes, np.int64)

    def add_image(self, det_boxes, det_labels, det_scores, gt_boxes,
                  gt_labels):
        """All arrays unpadded numpy for one image."""
        self._gt_count += np.bincount(gt_labels,
                                      minlength=self.num_classes)
        T = len(self.ious)
        for c in set(det_labels.tolist()):
            if c == 0:
                continue
            d_idx = np.nonzero(det_labels == c)[0]
            g_idx = np.nonzero(gt_labels == c)[0]
            order = d_idx[np.argsort(-det_scores[d_idx],
                                     kind="stable")][:self.max_dets]
            iou = (np_box_iou(det_boxes[order], gt_boxes[g_idx])
                   if len(g_idx) else np.zeros((len(order), 0)))
            tp = np.zeros((len(order), T), bool)
            for ti, t in enumerate(self.ious):
                taken = np.zeros(len(g_idx), bool)
                for rank in range(len(order)):
                    if iou.shape[1]:
                        cand = np.where(~taken, iou[rank], -1.0)
                        j = cand.argmax()
                        if cand[j] >= t:
                            taken[j] = True
                            tp[rank, ti] = True
            for rank, di in enumerate(order):
                self._dets[c].append((float(det_scores[di]), tp[rank]))

    def results(self) -> Dict[str, float]:
        ap_per_iou = {t: [] for t in self.ious}
        for c in range(1, self.num_classes):
            n_gt = self._gt_count[c]
            if n_gt == 0:
                continue
            recs = self._dets[c]
            if not recs:
                for t in self.ious:
                    ap_per_iou[t].append(0.0)
                continue
            scores = np.asarray([r[0] for r in recs])
            tp_all = np.stack([r[1] for r in recs])        # (D, T)
            order = np.argsort(-scores, kind="stable")
            tp_all = tp_all[order].astype(np.float64)
            tp_cum = np.cumsum(tp_all, axis=0)              # (D, T)
            fp_cum = np.cumsum(1.0 - tp_all, axis=0)
            for ti, t in enumerate(self.ious):
                recall = tp_cum[:, ti] / n_gt
                precision = tp_cum[:, ti] / np.maximum(
                    tp_cum[:, ti] + fp_cum[:, ti], 1e-9)
                ap_per_iou[t].append(_ap_from_pr(recall, precision))
        out = {}
        means = [np.mean(v) if v else 0.0 for v in ap_per_iou.values()]
        out["mAP"] = float(np.mean(means))
        if 0.5 in ap_per_iou:
            out["AP50"] = float(np.mean(ap_per_iou[0.5])
                                if ap_per_iou[0.5] else 0.0)
        if 0.75 in ap_per_iou:
            out["AP75"] = float(np.mean(ap_per_iou[0.75])
                                if ap_per_iou[0.75] else 0.0)
        return out
