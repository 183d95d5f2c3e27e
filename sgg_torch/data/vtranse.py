"""VTransE split of Visual Genome.

The port's copy of ``sgg_tpu/data/vtranse.py``, a rebuild of the
reference's ``dataloaders/vtranse.py``: parses
``vg1_2_meta.h5`` (per-image ``sub_boxes``/``obj_boxes``/``rlp_labels``
under ``gt/{train,test}/``), dedups subject/object boxes into a node list,
shifts predicate ids by +1 for the background class, and caches the parsed
graphs to a pickle next to the h5. Val = first ``num_val_im`` train images;
images with < 2 objects are dropped. ``h5py`` is imported where the h5
file is read, so that the module imports on a machine without it.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from sgg_torch.data.datasets import (SGGDataset, TrainingTriplets,
                                   build_eval_splits, shot_filter)

CORRUPTED_IMS = ("1592.jpg", "1722.jpg", "4616.jpg", "4617.jpg")


def parse_vte_h5(graphs_file: str, file_mode: str):
    """Parse (and cache) one h5 mode group -> ({img: graph}, classes, preds).

    Graph dedup semantics follow vtranse.py:40-57: node list = unique rows of
    concat(sub_boxes, obj_boxes); classes follow the same unique order;
    rels reference deduped node indices with predicate+1.
    """
    cache = graphs_file.replace(".h5", f"_{file_mode}.pkl")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)

    import h5py

    data: Dict[str, dict] = {}
    with h5py.File(graphs_file, "r") as h5:
        group = h5[f"gt/{file_mode}/"]
        for img_key in group.keys():
            d = group[img_key]
            sub_box = d["sub_boxes"][:]
            obj_box = d["obj_boxes"][:]
            rlp = d["rlp_labels"][:]  # (n, 3): subj_cls, predicate, obj_cls
            all_boxes = np.concatenate([sub_box, obj_box], axis=0)
            uniq, first_idx, inverse = np.unique(
                all_boxes, axis=0, return_index=True, return_inverse=True)
            classes = np.concatenate([rlp[:, 0], rlp[:, 2]])[first_idx]
            n = len(inverse) // 2
            rels = np.column_stack(
                [inverse[:n], inverse[n:], rlp[:, 1] + 1]).astype(np.int32)
            data[img_key] = {"boxes": uniq.astype(np.float32),
                             "gt_classes": classes, "rels": rels}
        predicates = ["__background__"] + \
            list(h5["meta/pre/name2idx"].keys())
        classes_list = list(h5["meta/cls/name2idx"].keys())
        # the reference swaps positions 0/1 because its h5 lists background
        # second (vtranse.py:62-64); generalize to "move background to 0"
        bg = classes_list.index("__background__")
        classes_list[0], classes_list[bg] = classes_list[bg], classes_list[0]

    parsed = (data, classes_list, predicates)
    try:
        with open(cache, "wb") as f:
            pickle.dump(parsed, f)
    except OSError:
        pass
    return parsed


def load_split(graphs_file: str, images_dir: str, mode: str,
               num_im: int = -1, num_val_im: int = 5000,
               min_graph_size: int = -1, max_graph_size: int = -1,
               training_triplets: TrainingTriplets = None,
               n_shots: int = -1) -> SGGDataset:
    assert mode in ("train", "val", "test"), mode
    file_mode = "test" if mode == "test" else "train"
    data, ind_to_classes, ind_to_predicates = parse_vte_h5(graphs_file,
                                                           file_mode)
    img_list = sorted(data.keys())

    image_index = np.arange(len(img_list))
    if num_im > -1:
        image_index = image_index[:num_im]
    if num_val_im > 0:
        if mode == "val":
            image_index = image_index[:num_val_im]
        elif mode == "train":
            image_index = image_index[num_val_im:]
    split_mask = np.zeros(len(img_list), bool)
    split_mask[image_index] = True

    is_train = mode == "train"
    filenames, boxes, gt_classes, relationships = [], [], [], []
    for i in image_index:
        basename = f"{img_list[i]}.jpg"
        if basename in CORRUPTED_IMS:
            split_mask[i] = False
            continue
        g = data[img_list[i]]
        boxes_i, classes_i, rels = g["boxes"], g["gt_classes"], g["rels"]
        if is_train and min_graph_size > -1 and \
                len(classes_i) <= min_graph_size:
            split_mask[i] = False
            continue
        if is_train and max_graph_size > -1 and \
                len(classes_i) > max_graph_size:
            split_mask[i] = False
            continue
        if len(classes_i) < 2:  # one object cannot have non-self rels
            split_mask[i] = False
            continue
        if training_triplets:
            keep = shot_filter(rels, classes_i, training_triplets, n_shots)
            rels = rels[keep] if len(keep) else np.zeros((0, 3), np.int32)
        if len(rels) == 0:
            split_mask[i] = False
            continue
        filenames.append(basename)
        boxes.append(boxes_i)
        gt_classes.append(classes_i)
        relationships.append(rels)

    return SGGDataset(
        name="vte", mode=mode, filenames=filenames, images_dir=images_dir,
        gt_boxes=boxes, gt_classes=gt_classes, relationships=relationships,
        ind_to_classes=ind_to_classes, ind_to_predicates=ind_to_predicates,
        box_coordinates="native", filter_duplicates=is_train)


def splits(data_dir: str, **kwargs) -> Dict[str, SGGDataset]:
    """Zero-shot filtering uses UNFILTERED train statistics when
    graph-size filters alter the train set (reference train_orig,
    visual_genome.py:324-333) — see gqa.splits."""
    graphs_file = os.path.join(data_dir, "VG", "vtranse", "vg1_2_meta.h5")
    images_dir = os.path.join(data_dir, "VG", "VG_100K")
    filtered = (kwargs.get("min_graph_size", -1) > -1
                or kwargs.get("max_graph_size", -1) > -1)
    orig_counts = None
    if filtered:
        orig = load_split(graphs_file, images_dir, "train",
                          **{**kwargs, "min_graph_size": -1,
                             "max_graph_size": -1})
        orig_counts = orig.triplet_counts

    def loader(mode, training_triplets=None, n_shots=-1):
        ds = load_split(graphs_file, images_dir, mode,
                        training_triplets=training_triplets,
                        n_shots=n_shots, **kwargs)
        if mode == "train" and orig_counts is not None:
            ds.triplet_counts = dict(orig_counts)
        return ds

    return build_eval_splits(loader, with_10_100=False)
