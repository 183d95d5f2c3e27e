"""Frequency bias: log P(predicate | subj_class, obj_class) lookup.

Counterpart of ``sgg_tpu/models/frequency_bias.py`` (reference
``FrequencyBias``, ``lib/sparse_targets.py:7-48``, and the count-matrix
construction ``lib/get_dataset_counts.py``): an embedding table of
empirical log predicate distributions per (subject class, object class)
pair, initialized from training-set statistics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from sgg_torch.eval.sgg_eval import np_box_iou


def count_matrices(gt_boxes, gt_classes, relationships, num_classes: int,
                   num_predicates: int, must_overlap: bool = True):
    """FG triplet counts + BG overlapping-pair counts (host, numpy).

    Returns (fg (C, C, R) int64, bg (C, C) int64) —
    reference get_dataset_counts.py:10-44.
    """
    fg = np.zeros((num_classes, num_classes, num_predicates), np.int64)
    bg = np.zeros((num_classes, num_classes), np.int64)
    for boxes, classes, rels in zip(gt_boxes, gt_classes, relationships):
        for s, o, p in rels:
            fg[classes[s], classes[o], p] += 1
        for s, o in overlapping_pairs(boxes, must_overlap):
            bg[classes[s], classes[o]] += 1
    return fg, bg


def overlapping_pairs(boxes: np.ndarray, must_overlap: bool = False):
    """Candidate BG pairs: overlapping ordered pairs, falling back to all
    pairs when nothing overlaps (reference box_filter,
    get_dataset_counts.py:47-65)."""
    n = boxes.shape[0]
    off_diag = ~np.eye(n, dtype=bool)
    if must_overlap:
        overlaps = (np_box_iou(boxes.astype(float), boxes.astype(float)) > 0)
        overlaps &= off_diag
        pairs = np.column_stack(np.nonzero(overlaps))
        if pairs.size:
            return pairs
    return np.column_stack(np.nonzero(off_diag))


def log_predicate_distribution(fg: np.ndarray, bg: np.ndarray,
                               eps: float = 1e-3) -> np.ndarray:
    """(C, C, R) log distribution, bg counts+1 into predicate 0
    (reference sparse_targets.py:16-21)."""
    fg = fg.astype(np.float64).copy()
    fg[:, :, 0] = bg + 1
    return np.log(fg / fg.sum(2, keepdims=True) + eps).astype(np.float32)


class FrequencyBias(nn.Module):
    """Embedding over (subj_class * C + obj_class) -> predicate logits,
    kept in float32 whatever the model's compute type."""

    def __init__(self, num_classes: int, num_predicates: int,
                 init_table: Optional[np.ndarray] = None):
        super().__init__()
        C, R = num_classes, num_predicates
        self.num_classes = C
        table = (torch.zeros(C * C, R) if init_table is None else
                 torch.from_numpy(np.asarray(init_table, np.float32)
                                  .reshape(C * C, R).copy()))
        self.table = nn.Parameter(table)

    def forward(self, subj_cls: torch.Tensor,
                obj_cls: torch.Tensor) -> torch.Tensor:
        idx = subj_cls.long() * self.num_classes + obj_cls.long()
        return self.table.float()[idx]
