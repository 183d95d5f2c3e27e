"""GQA scene-graph dataset parser.

The port's copy of ``sgg_tpu/data/gqa.py``, a rebuild of the reference's
``dataloaders/gqa.py`` + the GQA branch of
``visual_genome.py:102-160``: parses the GQA ``sceneGraphs`` JSON into the
per-image contract, builds the vocabulary from the union of train+val scene
graphs (1704 object classes incl. background in the full dataset), supports
excluding ``to the left of``/``to the right of`` predicates, and maps
modes as the reference does — val = the first ``num_val_im`` (5k) of the
train scene-graph image list, train = the remainder, test = GQA val (GQA
has no public test SGs; the reference's own comment says "last 5k" but
its code slices the FIRST 5k, visual_genome.py:106-109).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from sgg_torch.data.datasets import (SGGDataset, TrainingTriplets,
                                   build_eval_splits, shot_filter)


def load_info(train_sgs: dict, val_sgs: dict):
    """Vocabulary from the union of train+val SGs (gqa.py:208-240)."""
    obj_classes, rel_classes = set(), set()
    for sg in list(train_sgs.values()) + list(val_sgs.values()):
        for obj in sg["objects"].values():
            obj_classes.add(obj["name"])
            for rel in obj["relations"]:
                rel_classes.add(rel["name"])
    ind_to_classes = ["__background__"] + sorted(obj_classes)
    ind_to_predicates = ["__background__"] + sorted(rel_classes)
    classes_to_ind = {n: i for i, n in enumerate(ind_to_classes)}
    predicates_to_ind = {n: i for i, n in enumerate(ind_to_predicates)}
    return ind_to_classes, ind_to_predicates, classes_to_ind, predicates_to_ind


def parse_scene_graph(sg: dict, classes_to_ind: Dict[str, int],
                      predicates_to_ind: Dict[str, int],
                      exclude_predicates: Optional[set] = None):
    """One GQA SG -> (boxes x1y1x2y2, classes, rels) or None if unusable.

    Objects are visited in sorted-key order; objects with empty/negative
    boxes are skipped along with their relations (gqa.py:88-131).
    """
    objects = sg["objects"]
    oid_to_idx: Dict[str, int] = {}
    boxes, classes, raw_rels = [], [], []
    any_rels = False
    for oid in sorted(objects.keys()):
        obj = objects[oid]
        x, y, w, h = obj["x"], obj["y"], obj["w"], obj["h"]
        if x < 0 or y < 0 or w <= 0 or h <= 0:
            continue  # skip objects with empty/negative boxes
        oid_to_idx[oid] = len(classes)
        if obj["relations"]:
            any_rels = True
        classes.append(classes_to_ind[obj["name"]])
        boxes.append([x, y, x + w, y + h])
        for rel in obj["relations"]:
            raw_rels.append((oid, rel["object"], rel["name"]))
    if not boxes or not any_rels:
        return None
    rels = []
    for s_oid, o_oid, name in raw_rels:
        if s_oid not in oid_to_idx or o_oid not in oid_to_idx:
            continue
        p = predicates_to_ind[name]
        if exclude_predicates and p in exclude_predicates:
            continue
        rels.append((oid_to_idx[s_oid], oid_to_idx[o_oid], p))
    return (np.asarray(boxes, np.float32), np.asarray(classes, np.int64),
            np.asarray(rels, np.int32).reshape(-1, 3))


def load_graphs(all_sgs: dict, image_ids: List[str],
                classes_to_ind: Dict[str, int],
                predicates_to_ind: Dict[str, int], mode: str = "train",
                num_val_im: int = -1, min_graph_size: int = -1,
                max_graph_size: int = -1,
                training_triplets: TrainingTriplets = None,
                n_shots: int = -1, filter_empty_rels: bool = True,
                exclude_left_right: bool = False):
    """GQA SGs -> per-image contract (gqa.py:28-205)."""
    assert filter_empty_rels, "should filter images with empty rels"
    exclude = None
    if exclude_left_right:
        exclude = {predicates_to_ind[r]
                   for r in ("to the left of", "to the right of")
                   if r in predicates_to_ind}

    image_index = np.arange(len(image_ids))
    if num_val_im > 0:
        if mode == "val":
            image_index = image_index[:num_val_im]
        elif mode == "train":
            image_index = image_index[num_val_im:]
    split_mask = np.zeros(len(image_ids), bool)
    split_mask[image_index] = True

    boxes, gt_classes, relationships = [], [], []
    for i, imid in enumerate(image_ids):
        if not split_mask[i]:
            continue
        parsed = parse_scene_graph(all_sgs[imid], classes_to_ind,
                                   predicates_to_ind, exclude)
        if parsed is None:
            split_mask[i] = False
            continue
        boxes_i, classes_i, rels = parsed
        if min_graph_size > -1 and len(classes_i) <= min_graph_size:
            split_mask[i] = False
            continue
        if max_graph_size > -1 and len(classes_i) > max_graph_size:
            split_mask[i] = False
            continue
        if len(rels) == 0:
            split_mask[i] = False
            continue
        if training_triplets:
            keep = shot_filter(rels, classes_i, training_triplets, n_shots)
            rels = rels[keep] if len(keep) else np.zeros((0, 3), np.int32)
            if len(rels) == 0:
                split_mask[i] = False
                continue
        boxes.append(boxes_i)
        gt_classes.append(classes_i)
        relationships.append(rels)
    return split_mask, boxes, gt_classes, relationships


class _GQAFiles:
    """Caches the big sceneGraphs JSONs across split loads
    (reference VG.train_sgs/val_sgs class attrs, visual_genome.py:135-141)."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        base = os.path.join(data_dir, "GQA")
        with open(os.path.join(base, "sceneGraphs",
                               "train_sceneGraphs.json")) as f:
            self.train_sgs = json.load(f)
        with open(os.path.join(base, "sceneGraphs",
                               "val_sceneGraphs.json")) as f:
            self.val_sgs = json.load(f)
        self.vocab = load_info(self.train_sgs, self.val_sgs)

    def image_ids(self, f_mode: str) -> List[str]:
        """Images with balanced-split QA pairs, cached to
        ``{mode}_images.json`` (visual_genome.py:110-130)."""
        base = os.path.join(self.data_dir, "GQA")
        cache = os.path.join(base, f"{f_mode}_images.json")
        if os.path.isfile(cache):
            with open(cache) as f:
                ids = json.load(f)
        else:
            with open(os.path.join(
                    base, f"{f_mode}_balanced_questions.json")) as f:
                qs = json.load(f)
            ids = list({v["imageId"] for v in qs.values()})
            with open(cache, "w") as f:
                json.dump(ids, f)
        return sorted(ids)


def load_split(files: _GQAFiles, mode: str, num_val_im: int = 5000,
               min_graph_size: int = -1, max_graph_size: int = -1,
               training_triplets: TrainingTriplets = None, n_shots: int = -1,
               exclude_left_right: bool = False) -> SGGDataset:
    # mode mapping: val uses the last 5k train SGs; test uses GQA val
    # (visual_genome.py:106-109)
    f_mode = {"train": "train", "val": "train", "test": "val"}[mode]
    image_ids = files.image_ids(f_mode)
    sgs = files.train_sgs if f_mode == "train" else files.val_sgs
    _, _, classes_to_ind, predicates_to_ind = files.vocab
    is_train = mode == "train"
    split_mask, boxes, classes, rels = load_graphs(
        sgs, image_ids, classes_to_ind, predicates_to_ind, mode=mode,
        num_val_im=num_val_im,
        min_graph_size=min_graph_size if is_train else -1,
        max_graph_size=max_graph_size if is_train else -1,
        training_triplets=training_triplets, n_shots=n_shots,
        exclude_left_right=exclude_left_right)
    filenames = [f"{image_ids[i]}.jpg" for i in np.nonzero(split_mask)[0]]
    return SGGDataset(
        name="gqa", mode=mode, filenames=filenames,
        images_dir=os.path.join(files.data_dir, "VG", "VG_100K"),
        gt_boxes=boxes, gt_classes=classes, relationships=rels,
        ind_to_classes=files.vocab[0], ind_to_predicates=files.vocab[1],
        box_coordinates="native", filter_duplicates=is_train)


def splits(data_dir: str, **kwargs) -> Dict[str, SGGDataset]:
    """Train + eval splits (no 10/100-shot for GQA, visual_genome.py:352).

    Like the VG builder, zero-shot filtering uses the UNFILTERED train
    triplet statistics when graph-size filters alter the train set
    (reference train_orig, visual_genome.py:324-333) — otherwise triplets
    seen only in filtered-out training images would wrongly count as
    zero-shot."""
    files = _GQAFiles(data_dir)
    filtered = (kwargs.get("min_graph_size", -1) > -1
                or kwargs.get("max_graph_size", -1) > -1)
    orig_counts = None
    if filtered:
        orig = load_split(files, "train",
                          **{**kwargs, "min_graph_size": -1,
                             "max_graph_size": -1})
        orig_counts = orig.triplet_counts

    def loader(mode, training_triplets=None, n_shots=-1):
        ds = load_split(files, mode, training_triplets=training_triplets,
                        n_shots=n_shots, **kwargs)
        if mode == "train" and orig_counts is not None:
            ds.triplet_counts = dict(orig_counts)
        return ds

    return build_eval_splits(loader, with_10_100=False)
