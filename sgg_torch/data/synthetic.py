"""Synthetic in-memory scene-graph dataset.

Counterpart of ``sgg_tpu/data/synthetic.py``, draw for draw: the same seed
gives the same boxes, classes and relations, so both packages evaluate the
same split. It honours the per-image contract of the VG loader
(``dataloaders/visual_genome.py:526-531``) and needs no download.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from sgg_torch.constants import IM_SCALE
from sgg_torch.data.graph_batch import GraphBatch, pack_ragged


@dataclasses.dataclass
class SyntheticSGGDataset:
    """Deterministic random scene graphs with plausible statistics.

    num_classes / num_predicates default to the VG-Stanford vocabulary sizes
    (151 object classes incl. background, 51 predicates incl. "no relation").
    """

    num_images: int = 64
    num_classes: int = 151
    num_predicates: int = 51
    min_objects: int = 2
    max_objects: int = 20
    max_rels: int = 30
    image_size: int = IM_SCALE
    with_images: bool = False
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.gt_boxes: List[np.ndarray] = []
        self.gt_classes: List[np.ndarray] = []
        self.relationships: List[np.ndarray] = []
        for _ in range(self.num_images):
            n = rng.randint(self.min_objects, self.max_objects + 1)
            xy = rng.rand(n, 2) * (self.image_size * 0.8)
            wh = rng.rand(n, 2) * (self.image_size * 0.4) + 8
            boxes = np.concatenate([xy, np.minimum(xy + wh, self.image_size)],
                                   axis=1).astype(np.float32)
            classes = rng.randint(1, self.num_classes, size=n).astype(np.int32)
            n_rel = min(rng.randint(1, self.max_rels + 1), n * (n - 1))
            pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
            sel = rng.choice(len(pairs), size=n_rel, replace=False)
            rels = np.asarray(
                [(pairs[s][0], pairs[s][1],
                  rng.randint(1, self.num_predicates)) for s in sel],
                dtype=np.int32).reshape(n_rel, 3)
            self.gt_boxes.append(boxes)
            self.gt_classes.append(classes)
            self.relationships.append(rels)

        self.ind_to_classes = ["__background__"] + [
            f"class_{i}" for i in range(1, self.num_classes)]
        self.ind_to_predicates = ["__no_relation__"] + [
            f"pred_{i}" for i in range(1, self.num_predicates)]

    def __len__(self) -> int:
        return self.num_images

    def image(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        return rng.rand(self.image_size, self.image_size, 3).astype(np.float32)

    def batch(self, indices, max_nodes: int, max_edges: int,
              with_images: Optional[bool] = None) -> GraphBatch:
        """Pack the given image indices into a padded host GraphBatch."""
        if with_images is None:
            with_images = self.with_images
        images = (np.stack([self.image(i) for i in indices])
                  if with_images else None)
        hw = float(self.image_size)
        return pack_ragged(
            [self.gt_boxes[i] for i in indices],
            [self.gt_classes[i] for i in indices],
            [self.relationships[i] for i in indices],
            max_nodes=max_nodes, max_edges=max_edges, images=images,
            im_hw=np.full((len(indices), 2), hw, np.float32))


def synthetic_splits(num_train: int = 64, num_eval: int = 16,
                     num_classes: int = 151, num_predicates: int = 51,
                     max_objects: int = 20, image_size: int = IM_SCALE,
                     seed: int = 0):
    """Reference-shaped splits from synthetic data: three disjoint synthetic
    sets feed ``build_eval_splits`` (zero-/10-/100-shot filtering against
    the train triplet counts). The datasets are file-less, so
    ``BatchLoader`` feeds the model constant canvases."""
    from sgg_torch.data.datasets import (SGGDataset, build_eval_splits,
                                         shot_filter)

    raws = {
        mode: SyntheticSGGDataset(
            num_images=n, num_classes=num_classes,
            num_predicates=num_predicates, max_objects=max_objects,
            image_size=image_size, seed=seed + off)
        for mode, n, off in (("train", num_train, 0),
                             ("val", num_eval, 1),
                             ("test", num_eval, 2))
    }

    def loader(mode, training_triplets=None, n_shots=-1):
        raw = raws[mode]
        rels = raw.relationships
        if training_triplets is not None:
            rels = [r[shot_filter(r, c, training_triplets, n_shots)]
                    for r, c in zip(rels, raw.gt_classes)]
        keep = [i for i, r in enumerate(rels) if len(r)]
        return SGGDataset(
            name="stanford", mode=mode, filenames=[], images_dir="",
            gt_boxes=[raw.gt_boxes[i] for i in keep],
            gt_classes=[raw.gt_classes[i] for i in keep],
            relationships=[rels[i] for i in keep],
            ind_to_classes=raw.ind_to_classes,
            ind_to_predicates=raw.ind_to_predicates,
            box_coordinates="native")

    return build_eval_splits(loader)
