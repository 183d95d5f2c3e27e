"""Dataset core: the per-image scene-graph contract and split machinery.

The reference's loaders all produce the same per-image contract —
``(split_mask, gt_boxes, gt_classes, relationships)``
(``dataloaders/visual_genome.py:526-531``) — plus vocabulary
lists and triplet statistics. This module holds the shared, parser-agnostic
pieces: the ``SGGDataset`` container, triplet counting, zero-/k-shot relation
filtering, duplicate-relation handling, and ``build_eval_splits``, which assembles
train + the six evaluation splits (val/test x zero/10/100/all-shot,
``visual_genome.py:316-375``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from sgg_torch.eval.sgg_eval import np_box_iou

TrainingTriplets = Union[set, Dict[str, int], None]


def triplet_strings(gt_classes: np.ndarray, rels: np.ndarray) -> List[str]:
    """'{subj_cls}_{pred}_{obj_cls}' keys (visual_genome.py:196)."""
    return [f"{gt_classes[s]}_{p}_{gt_classes[o]}" for s, o, p in rels]


def shot_filter(rels: np.ndarray, gt_classes: np.ndarray,
                training_triplets: TrainingTriplets,
                n_shots: int = -1) -> np.ndarray:
    """Indices of rels kept under zero-/k-shot filtering.

    * ``training_triplets`` as a set: keep triplets NOT in it (zero-shot,
      visual_genome.py:620-624).
    * as a dict of counts with ``n_shots``: keep triplets whose train+val
      count is in [1, 10] (10-shot) or [11, 100] (100-shot)
      (visual_genome.py:614-618).
    """
    if not training_triplets:
        return np.arange(len(rels))
    keep = []
    for i, key in enumerate(triplet_strings(gt_classes, rels)):
        if isinstance(training_triplets, dict):
            assert n_shots > 0, n_shots
            c = training_triplets.get(key)
            if c is None:
                continue
            if (n_shots == 10 and 1 <= c <= 10) or \
                    (n_shots == 100 and 11 <= c <= 100):
                keep.append(i)
        elif key not in training_triplets:
            assert n_shots == -1, n_shots
            keep.append(i)
    return np.asarray(keep, dtype=int)


def filter_duplicate_rels(rels: np.ndarray,
                          rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """One predicate per (subj, obj) pair, randomly chosen among duplicates
    (reference ``filter_dups``, visual_genome.py:743-750)."""
    if rng is None:
        rng = np.random
    groups = defaultdict(list)
    for s, o, p in rels:
        groups[(s, o)].append(p)
    return np.asarray([(s, o, rng.choice(ps)) for (s, o), ps in
                       groups.items()], dtype=rels.dtype).reshape(-1, 3)


def non_overlap_filter(boxes: np.ndarray, rels: np.ndarray) -> np.ndarray:
    """Keep rels whose boxes overlap (train-only sgdet filter,
    visual_genome.py:643-653). Returns kept indices (may be empty)."""
    if len(rels) == 0:
        return np.arange(0)
    iou = np_box_iou(boxes.astype(float), boxes.astype(float))
    return np.nonzero(iou[rels[:, 0], rels[:, 1]] > 0.0)[0]


@dataclasses.dataclass
class SGGDataset:
    """Parsed scene-graph dataset split (host-side, numpy)."""

    name: str                     # stanford | gqa | vte
    mode: str                     # train | val | test
    filenames: List[str]
    images_dir: str
    gt_boxes: List[np.ndarray]    # [n_i, 4] x1y1x2y2
    gt_classes: List[np.ndarray]  # [n_i]
    relationships: List[np.ndarray]  # [m_i, 3] (subj, obj, predicate)
    ind_to_classes: List[str]
    ind_to_predicates: List[str]
    # 'box_scale': boxes stored at BOX_SCALE=1024 along the longest image
    # side (stanford h5); 'native': boxes in original image pixels (gqa/vte).
    box_coordinates: str = "box_scale"
    filter_duplicates: bool = True

    triplet_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    subj_pred_pairs: Dict[str, Dict[int, int]] = dataclasses.field(
        default_factory=dict)
    pred_obj_pairs: Dict[str, Dict[int, int]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        assert len(self.gt_boxes) == len(self.gt_classes) == \
            len(self.relationships)
        if self.filenames:
            assert len(self.filenames) == len(self.gt_boxes), (
                len(self.filenames), len(self.gt_boxes))
        self._count_triplets()

    def __len__(self):
        return len(self.gt_boxes)

    @property
    def num_classes(self):
        return len(self.ind_to_classes)

    @property
    def num_predicates(self):
        return len(self.ind_to_predicates)

    @property
    def is_train(self):
        return self.mode == "train"

    def _count_triplets(self):
        """triplet_counts + co-occurrence dicts for perturbations
        (visual_genome.py:183-227)."""
        self.triplet_counts.clear()
        for classes, rels in zip(self.gt_classes, self.relationships):
            for key in triplet_strings(classes, rels):
                self.triplet_counts[key] = self.triplet_counts.get(key, 0) + 1
        if self.is_train:
            self.subj_pred_pairs.clear()
            self.pred_obj_pairs.clear()
            for classes, rels in zip(self.gt_classes, self.relationships):
                for s, o, p in rels:
                    key = f"{classes[s]}_{p}_{classes[o]}"
                    c = self.triplet_counts[key]
                    self.subj_pred_pairs.setdefault(
                        f"{classes[s]}_{p}", {})[int(classes[o])] = c
                    self.pred_obj_pairs.setdefault(
                        f"{p}_{classes[o]}", {})[int(classes[s])] = c

    def triplet2str(self, triplet: str) -> str:
        s, p, o = triplet.split("_")
        return "_".join((self.ind_to_classes[int(s)],
                         self.ind_to_predicates[int(p)],
                         self.ind_to_classes[int(o)]))

    def describe(self, verbose: bool = True) -> Dict[str, float]:
        """Dataset statistics: objects, FG/BG edges, graph density
        (reference load-time print, visual_genome.py:242-249)."""
        n_obj = np.asarray([len(c) for c in self.gt_classes])
        # FG edges counted after duplicate-(subj,obj) collapse, matching
        # the reference's len(filter_dups(rels)) (visual_genome.py:189)
        n_fg = np.asarray([
            len({(int(s), int(o)) for s, o, _ in r}) if len(r) else 0
            for r in self.relationships])
        n_bg = n_obj * (n_obj - 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            density = np.where(n_bg > 0, 100.0 * n_fg / np.maximum(n_bg, 1),
                               0.0)
        stats = {
            "images": len(self),
            "objects_total": int(n_obj.sum()),
            "objects_mean": float(n_obj.mean()) if len(n_obj) else 0.0,
            "fg_edges_total": int(n_fg.sum()),
            "fg_edges_mean": float(n_fg.mean()) if len(n_fg) else 0.0,
            "bg_edges_total": int(n_bg.sum()),
            "density_mean": float(density.mean()) if len(density) else 0.0,
            "unique_triplets": len(self.triplet_counts),
        }
        if verbose:
            print(f"{stats['images']} images, "
                  f"{sum(self.triplet_counts.values())} triplets "
                  f"({stats['unique_triplets']} unique)")
            print(f"Stats: {stats['objects_total']} objects "
                  f"(mean {stats['objects_mean']:.1f}), "
                  f"{stats['fg_edges_total']} FG edges "
                  f"(mean {stats['fg_edges_mean']:.1f}), "
                  f"{stats['bg_edges_total']} BG edges, "
                  f"graph density {stats['density_mean']:.2f}%")
        return stats


def build_eval_splits(loader: Callable[..., SGGDataset],
                      with_10_100: bool = True) -> Dict[str, SGGDataset]:
    """Train + six eval splits with zero-/k-shot filtering.

    ``loader(mode, training_triplets=None, n_shots=-1)`` must return an
    ``SGGDataset``. Mirrors ``VG.splits`` (visual_genome.py:316-375):
    val_zs filters against train triplets; test_zs against train+val;
    test_10s/test_100s keep triplets with train+val count in [1,10]/[11,100].
    """
    train = loader("train")
    splits: Dict[str, SGGDataset] = {"train": train}
    splits["val_zs"] = loader("val",
                              training_triplets=set(train.triplet_counts))
    splits["val_alls"] = loader("val")
    train_val = set(train.triplet_counts) | \
        set(splits["val_alls"].triplet_counts)
    splits["test_zs"] = loader("test", training_triplets=train_val)
    if with_10_100:
        counts = dict(train.triplet_counts)
        for k, v in splits["val_alls"].triplet_counts.items():
            counts[k] = counts.get(k, 0) + v
        splits["test_10s"] = loader("test", training_triplets=counts,
                                    n_shots=10)
        splits["test_100s"] = loader("test", training_triplets=counts,
                                     n_shots=100)
    splits["test_alls"] = loader("test")
    return splits
