"""VG-SGG (Stanford-filtered Visual Genome) dataset parser.

The port's copy of ``sgg_tpu/data/visual_genome.py``, a rebuild of the
reference h5 loader
(``dataloaders/visual_genome.py:516-690``): parses
``VG-SGG.h5`` (split, img_to_first/last_box/rel, labels, boxes_1024 in
center format, relationships, predicates) and ``VG-SGG-dicts.json`` /
``image_data.json``; applies graph-size filters, zero-/k-shot triplet
filtering, the non-overlap filter, and builds the train/val/test splits
(val = first ``num_val_im`` train-split images, ``visual_genome.py:548-555``).
``h5py`` is imported where the h5 file is read, so that the module imports
on a machine without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from sgg_torch.constants import BOX_SCALE
from sgg_torch.data.datasets import (SGGDataset, TrainingTriplets,
                                   build_eval_splits, non_overlap_filter,
                                   shot_filter)

CORRUPTED_IMS = ("1592.jpg", "1722.jpg", "4616.jpg", "4617.jpg")
# Expected split sizes for integrity checks (visual_genome.py:347-372,502).
EXPECTED = {"filenames": 108073, "test_zs": 4519, "test_10s": 9602,
            "test_100s": 16528, "test_alls": 26446}


def load_info(dict_file: str):
    """Class/predicate vocabularies (visual_genome.py:662-677)."""
    with open(dict_file) as f:
        info = json.load(f)
    info["label_to_idx"]["__background__"] = 0
    info["predicate_to_idx"]["__background__"] = 0
    ind_to_classes = sorted(info["label_to_idx"],
                            key=lambda k: info["label_to_idx"][k])
    ind_to_predicates = sorted(info["predicate_to_idx"],
                               key=lambda k: info["predicate_to_idx"][k])
    return ind_to_classes, ind_to_predicates


def load_image_filenames(image_file: str, image_dir: str, check: bool = True):
    """Good image basenames, 4 corrupted excluded (visual_genome.py:491-513).

    With ``check`` (real-data runs) filenames are existence-filtered
    against ``image_dir`` like the reference, so a missing/partial VG_100K
    download fails fast at the expected-count check instead of mid-epoch
    in the decode pipeline; fixtures (check=False) skip the disk probe.
    """
    import os
    with open(image_file) as f:
        im_data = json.load(f)
    fns = []
    for img in im_data:
        basename = f"{img['image_id']}.jpg"
        if basename in CORRUPTED_IMS:
            continue
        if check and not os.path.exists(os.path.join(image_dir, basename)):
            continue
        fns.append(basename)
    if check:
        if len(fns) != EXPECTED["filenames"]:
            raise ValueError(f"{len(fns)} VG images in {image_dir}, not "
                             f"{EXPECTED['filenames']}")
    return fns


def load_graphs(graphs_file: str, mode: str = "train", num_im: int = -1,
                num_val_im: int = 0, filter_empty_rels: bool = True,
                min_graph_size: int = -1, max_graph_size: int = -1,
                filter_non_overlap: bool = False,
                training_triplets: TrainingTriplets = None,
                n_shots: int = -1):
    """Parse VG-SGG.h5 into the per-image contract.

    Returns (split_mask over all images, boxes, gt_classes, relationships) —
    boxes are x1y1x2y2 at BOX_SCALE (decoded from center format,
    visual_genome.py:565-567).
    """
    import h5py

    assert mode in ("train", "val", "test"), mode
    with h5py.File(graphs_file, "r") as h5:
        data_split = h5["split"][:]
        split = 2 if mode == "test" else 0
        split_mask = data_split == split
        split_mask &= h5["img_to_first_box"][:] >= 0
        if filter_empty_rels:
            split_mask &= h5["img_to_first_rel"][:] >= 0

        image_index = np.nonzero(split_mask)[0]
        if num_im > -1:
            image_index = image_index[:num_im]
        if num_val_im > 0:
            if mode == "val":
                image_index = image_index[:num_val_im]
            elif mode == "train":
                image_index = image_index[num_val_im:]
        split_mask = np.zeros_like(data_split, dtype=bool)
        split_mask[image_index] = True

        all_labels = h5["labels"][:, 0]
        all_boxes = h5[f"boxes_{BOX_SCALE}"][:]
        if not (np.all(all_boxes[:, :2] >= 0) and
                np.all(all_boxes[:, 2:] > 0)):
            raise ValueError(f"{graphs_file}: negative box centres or "
                             f"empty boxes")
        # center -> corner (visual_genome.py:565-567). Arithmetic happens
        # in the STORED dtype: the real VG-SGG.h5 stores int boxes, and the
        # reference's in-place assignment truncates xc - w/2 back to int —
        # x1 is floor(xc - w/2) for odd widths. Keeping the stored dtype
        # through the conversion reproduces that bit-for-bit
        # (tests/test_datasets_reference_parity.py holds the JAX copy).
        all_boxes[:, :2] = all_boxes[:, :2] - all_boxes[:, 2:] / 2
        all_boxes[:, 2:] = all_boxes[:, :2] + all_boxes[:, 2:]
        all_boxes = all_boxes.astype(np.float32)

        first_box = h5["img_to_first_box"][split_mask]
        last_box = h5["img_to_last_box"][split_mask]
        first_rel = h5["img_to_first_rel"][split_mask]
        last_rel = h5["img_to_last_rel"][split_mask]
        all_rels = h5["relationships"][:]
        all_preds = h5["predicates"][:, 0]

    boxes, gt_classes, relationships = [], [], []
    for i in range(len(image_index)):
        boxes_i = all_boxes[first_box[i]:last_box[i] + 1]
        classes_i = all_labels[first_box[i]:last_box[i] + 1]

        if min_graph_size > -1 and len(classes_i) <= min_graph_size:
            split_mask[image_index[i]] = False
            continue
        if max_graph_size > -1 and len(classes_i) > max_graph_size:
            split_mask[image_index[i]] = False
            continue

        if first_rel[i] >= 0:
            preds = all_preds[first_rel[i]:last_rel[i] + 1]
            pair = all_rels[first_rel[i]:last_rel[i] + 1] - first_box[i]
            if not (np.all(pair >= 0) and np.all(pair < boxes_i.shape[0])):
                raise ValueError(f"{graphs_file}: image {image_index[i]} "
                                 f"relates boxes of another image")
            rels = np.column_stack([pair, preds]).astype(np.int32)
        else:
            assert not filter_empty_rels
            rels = np.zeros((0, 3), np.int32)

        if training_triplets:
            keep = shot_filter(rels, classes_i, training_triplets, n_shots)
            rels = rels[keep] if len(keep) else np.zeros((0, 3), np.int32)
            if filter_empty_rels and len(rels) == 0:
                split_mask[image_index[i]] = False
                continue

        if filter_non_overlap:
            assert mode == "train"
            inc = non_overlap_filter(boxes_i, rels)
            if inc.size == 0:
                split_mask[image_index[i]] = False
                continue
            rels = rels[inc]

        boxes.append(boxes_i)
        gt_classes.append(classes_i)
        relationships.append(rels)

    return split_mask, boxes, gt_classes, relationships


def load_split(data_dir: str, mode: str, num_im: int = -1,
               num_val_im: int = 5000, filter_empty_rels: bool = True,
               filter_duplicate_rels: bool = True,
               filter_non_overlap: bool = True, min_graph_size: int = -1,
               max_graph_size: int = -1,
               training_triplets: TrainingTriplets = None,
               n_shots: int = -1, check_sizes: bool = True) -> SGGDataset:
    """One VG split as an SGGDataset (reference VG.__init__ stanford path)."""
    base = os.path.join(data_dir, "VG", "stanford_filtered")
    images_dir = os.path.join(data_dir, "VG", "VG_100K")
    is_train = mode == "train"
    split_mask, boxes, classes, rels = load_graphs(
        os.path.join(base, "VG-SGG.h5"), mode, num_im=num_im,
        num_val_im=num_val_im, filter_empty_rels=filter_empty_rels,
        min_graph_size=min_graph_size if is_train else -1,
        max_graph_size=max_graph_size if is_train else -1,
        filter_non_overlap=filter_non_overlap and is_train,
        training_triplets=training_triplets, n_shots=n_shots)
    filenames = load_image_filenames(
        os.path.join(base, "image_data.json"), images_dir, check=check_sizes)
    if len(split_mask) != len(filenames):
        raise ValueError(f"VG-SGG.h5 has {len(split_mask)} images, "
                         f"image_data.json {len(filenames)}")
    filenames = [filenames[i] for i in np.nonzero(split_mask)[0]]
    ind_to_classes, ind_to_predicates = load_info(
        os.path.join(base, "VG-SGG-dicts.json"))
    return SGGDataset(
        name="stanford", mode=mode, filenames=filenames,
        images_dir=images_dir, gt_boxes=boxes, gt_classes=classes,
        relationships=rels, ind_to_classes=ind_to_classes,
        ind_to_predicates=ind_to_predicates, box_coordinates="box_scale",
        filter_duplicates=filter_duplicate_rels and is_train)


def splits(data_dir: str, check_sizes: bool = True,
           **kwargs) -> Dict[str, SGGDataset]:
    """Train + six eval splits (reference VG.splits, visual_genome.py:316-375).

    When graph-size or overlap filters alter the train set, zero-shot
    filtering still uses the unfiltered train statistics
    (visual_genome.py:324-333).
    """
    filtered = (kwargs.get("min_graph_size", -1) > -1
                or kwargs.get("max_graph_size", -1) > -1
                or kwargs.get("filter_non_overlap", True))
    orig_counts: Optional[Dict[str, int]] = None
    if filtered:
        orig = load_split(data_dir, "train", check_sizes=check_sizes,
                          **{**kwargs, "min_graph_size": -1,
                             "max_graph_size": -1,
                             "filter_non_overlap": False})
        orig_counts = orig.triplet_counts

    def loader(mode, training_triplets=None, n_shots=-1):
        ds = load_split(data_dir, mode, training_triplets=training_triplets,
                        n_shots=n_shots, check_sizes=check_sizes, **kwargs)
        if mode == "train" and orig_counts is not None:
            ds.triplet_counts = dict(orig_counts)
        return ds

    # build_eval_splits consumes train.triplet_counts for the zs/k-shot
    # filters; substituting the unfiltered counts reproduces the reference's
    # train_orig behavior.
    out = build_eval_splits(loader, with_10_100=True)
    if check_sizes:
        for k in ("test_zs", "test_10s", "test_100s", "test_alls"):
            if len(out[k]) != EXPECTED[k]:
                raise ValueError(f"{k} has {len(out[k])} images, not "
                                 f"{EXPECTED[k]}")
    return out
