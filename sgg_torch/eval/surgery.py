"""Model outputs → ranked evaluation entry (reference ``lib/surgery.py``).

``filter_dets`` ranks candidate pairs by
``max_nonbg_predicate_score * obj_score_subj * obj_score_obj`` descending and
returns the ranked pair indices plus the per-predicate score rows in that
order (``lib/surgery.py:40-55``). Pure numpy on host data:
the caller (eval/driver.py) walks images one by one over already-fetched
arrays whose shapes vary per image (valid-node slices, ladder-rung pair
widths); a device sort would pay a round trip per image for an argsort
over a few thousand elements — the reference's own surgery is
numpy/torch-CPU here too. The port's own copy of ``sgg_tpu/eval/surgery.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rank_pairs(obj_scores: np.ndarray, pair_inds: np.ndarray,
               rel_dists: np.ndarray, pair_mask: np.ndarray) -> np.ndarray:
    """Ranking over candidate pairs (invalid pairs sort last).

    Args:
      obj_scores: (N,) per-object scores.
      pair_inds: (E, 2) candidate pair indices.
      rel_dists: (E, R) per-pair predicate distributions (softmaxed).
      pair_mask: (E,) validity.

    Returns:
      order (E,) ranking (stable for ties).
    """
    obj_scores = np.asarray(obj_scores)
    # padded (masked) pairs may index beyond the valid-node slice; clamp
    # like the device gathers do — their scores are forced to -inf below
    idx = np.clip(np.asarray(pair_inds), 0, max(len(obj_scores) - 1, 0))
    s0 = obj_scores[idx[:, 0]]
    s1 = obj_scores[idx[:, 1]]
    score = np.asarray(rel_dists)[:, 1:].max(axis=1) * s0 * s1
    score = np.where(np.asarray(pair_mask), score, -np.inf)
    return np.argsort(-score, kind="stable")


def filter_dets(boxes, obj_scores, obj_classes, pair_inds, rel_dists,
                pair_mask) -> Dict[str, np.ndarray]:
    """Build the numpy pred_entry consumed by the evaluator.

    Same output contract as the reference ``filter_dets`` (boxes, classes,
    obj scores, ranked pair inds, per-predicate rows), packaged as the dict
    the evaluator's ``add_image`` expects.
    """
    order = rank_pairs(obj_scores, pair_inds, rel_dists, pair_mask)
    n_valid = int(np.asarray(pair_mask).sum())
    order = order[:n_valid]
    return {
        "pred_boxes": np.asarray(boxes),
        "pred_classes": np.asarray(obj_classes),
        "obj_scores": np.asarray(obj_scores),
        "pred_rel_inds": np.asarray(pair_inds)[order],
        "rel_scores": np.asarray(rel_dists)[order],
    }
