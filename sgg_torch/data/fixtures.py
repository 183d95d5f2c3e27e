"""Miniature schema-exact on-disk dataset fixtures (VG / GQA / VTE).

The port's copy of ``sgg_tpu/data/fixtures.py``: from one seed both write
the same files. ``h5py`` and PIL are imported by the writers that use them.

Dress-rehearsal data for the full CLI: real JPEG files plus the exact
on-disk layout the real datasets ship with, shrunk to fixture scale so
``main.py`` / ``pretrain_detector.py`` can run end-to-end without the 60 GB
download. Schemas rebuilt from the reference parsers:

- VG stanford: ``VG/stanford_filtered/{VG-SGG.h5, VG-SGG-dicts.json,
  image_data.json}`` + ``VG/VG_100K/*.jpg``
  (``dataloaders/visual_genome.py:491-690``).
- GQA: ``GQA/sceneGraphs/{train,val}_sceneGraphs.json`` +
  ``GQA/{train,val}_balanced_questions.json``
  (``dataloaders/gqa.py:28-205``, image-id lists per
  ``visual_genome.py:110-130``).
- VTE: ``VG/vtranse/vg1_2_meta.h5`` with ``gt/{train,test}/<img>/
  {sub_boxes,obj_boxes,rlp_labels}`` and ``meta/{cls,pre}/name2idx``
  (``dataloaders/vtranse.py:25-80`` — note the reference
  asserts ``__background__`` is the SECOND class key; the fixture
  reproduces that layout).

Triplet pools are planted so the zero-/10-/100-shot eval splits are all
non-empty at any fixture size: "head" triplets appear ~40× across the
train+val images (100-shot band, stable under any val carve because the
k-shot filter counts train+val, ``datasets.build_eval_splits``), "mid"
triplets ~6× (10-shot band), "zs" triplets only in test images, and
"val-zs" triplets only in the first two train-split images (the val carve).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sgg_torch.constants import BOX_SCALE

__all__ = ["write_vg_fixture", "write_gqa_fixture", "write_vte_fixture",
           "write_all_fixtures"]


# ---------------------------------------------------------------------------
# shared helpers


def _class_color(cls: int) -> Tuple[int, int, int]:
    """Deterministic, well-separated RGB per class (golden-ratio hues)."""
    import colorsys
    hue = (cls * 0.61803398875) % 1.0
    val = 0.95 if cls % 2 else 0.65
    r, g, b = colorsys.hsv_to_rgb(hue, 0.9, val)
    return int(255 * r), int(255 * g), int(255 * b)


def _write_jpeg(path: str, rng: np.random.RandomState, w: int, h: int,
                boxes_px=None, classes=None):
    """A real JPEG with smooth random background content — and, when GT
    ``boxes_px``/``classes`` are given, a class-coded shape rendered at
    each box (color deterministic in the class id; ellipse for odd
    classes, rectangle for even; black border).

    The rendering makes DETECTION learnable on fixtures: with pure noise
    images the pixel content carries zero information about the
    annotations, so a pretrained detector can never localize objects in
    unseen test images and the sgdet R@K chain is structurally pinned at
    its 0.0 fixed point end-to-end (round-4 finding). Larger boxes draw
    first so smaller overlapping objects stay visible on top.
    """
    from PIL import Image, ImageDraw
    small = rng.randint(0, 255, (12, 12, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if boxes_px is not None and len(boxes_px):
        draw = ImageDraw.Draw(img)
        order = sorted(range(len(boxes_px)),
                       key=lambda i: -((boxes_px[i][2] - boxes_px[i][0])
                                       * (boxes_px[i][3] - boxes_px[i][1])))
        for i in order:
            x1, y1, x2, y2 = [float(v) for v in boxes_px[i]]
            cls = int(classes[i])
            color = _class_color(cls)
            if cls % 2:
                draw.ellipse([x1, y1, x2, y2], fill=color,
                             outline=(0, 0, 0), width=2)
            else:
                draw.rectangle([x1, y1, x2, y2], fill=color,
                               outline=(0, 0, 0), width=2)
    img.save(path, format="JPEG", quality=80)


def _image_sizes(rng: np.random.RandomState, n: int,
                 lo: int = 240, hi: int = 520) -> List[Tuple[int, int]]:
    return [(int(rng.randint(lo, hi)), int(rng.randint(lo, hi)))
            for _ in range(n)]


def _triplet_pools(rng: np.random.RandomState, n_classes: int, n_preds: int):
    """Disjoint (subj_cls, pred, obj_cls) pools for shot-band planting."""
    pools: Dict[str, List[Tuple[int, int, int]]] = {}
    used = set()

    def draw(k):
        out = []
        while len(out) < k:
            t = (int(rng.randint(1, n_classes)), int(rng.randint(1, n_preds)),
                 int(rng.randint(1, n_classes)))
            if t not in used:
                used.add(t)
                out.append(t)
        return out

    pools["head"] = draw(2)    # planted ~40x -> 100-shot band [11, 100]
    pools["mid"] = draw(3)     # planted ~6x  -> 10-shot band [1, 10]
    pools["zs"] = draw(3)      # test images only -> zero-shot
    pools["val_zs"] = draw(2)  # first 2 train-split images only
    return pools


class _GraphBuilder:
    """Accumulates (class, box) nodes + (s, o, pred) rels for one image.

    Boxes live in an ``extent_w x extent_h`` coordinate frame; endpoints of
    a planted triplet reuse an existing node of the same class with prob
    0.5 so node degrees vary. Boxes are large (25-55% of the extent) so
    most pairs overlap — keeps sgdet's non-overlap train filter and
    IoU-based assignment non-vacuous.
    """

    def __init__(self, rng, extent_w: float, extent_h: float):
        self.rng = rng
        self.ew, self.eh = extent_w, extent_h
        self.classes: List[int] = []
        self.boxes: List[List[float]] = []   # x1 y1 x2 y2
        self.rels: List[Tuple[int, int, int]] = []

    def _new_node(self, cls: int) -> int:
        rng = self.rng
        bw = rng.uniform(0.25, 0.55) * self.ew
        bh = rng.uniform(0.25, 0.55) * self.eh
        x1 = rng.uniform(0, self.ew - bw)
        y1 = rng.uniform(0, self.eh - bh)
        self.classes.append(int(cls))
        self.boxes.append([x1, y1, x1 + bw, y1 + bh])
        return len(self.classes) - 1

    def _node_for(self, cls: int, avoid: int = -1) -> int:
        cand = [i for i, c in enumerate(self.classes)
                if c == cls and i != avoid]
        if cand and self.rng.rand() < 0.5:
            return int(cand[self.rng.randint(len(cand))])
        return self._new_node(cls)

    def add_triplet(self, t: Tuple[int, int, int]):
        s_cls, pred, o_cls = t
        s = self._node_for(s_cls)
        o = self._node_for(o_cls, avoid=s)
        self.rels.append((s, o, pred))


def _plan_images(rng, n_train: int, n_test: int, pools,
                 n_classes: int, n_preds: int):
    """Per-image triplet lists implementing the shot-band plan."""
    plans = [[] for _ in range(n_train + n_test)]
    train_ids = list(range(n_train))
    test_ids = list(range(n_train, n_train + n_test))

    def spread(triplet, image_ids, k):
        for i in range(k):
            plans[image_ids[(i * 7 + hash(triplet)) % len(image_ids)]] \
                .append(triplet)

    for t in pools["head"]:
        spread(t, train_ids, min(40, 4 * n_train))   # 100-shot band
        spread(t, test_ids, 3)
    for t in pools["mid"]:
        spread(t, train_ids, min(6, n_train))        # 10-shot band
        spread(t, test_ids, 2)
    for t in pools["zs"]:
        spread(t, test_ids, 2)                       # never in train
    for t in pools["val_zs"]:
        spread(t, train_ids[:2], 1)                  # val carve only
    # random tail triplets for density (count ~1 each)
    for img in range(n_train + n_test):
        for _ in range(rng.randint(1, 3)):
            plans[img].append((int(rng.randint(1, n_classes)),
                               int(rng.randint(1, n_preds)),
                               int(rng.randint(1, n_classes))))
        rng.shuffle(plans[img])
    return plans


# ---------------------------------------------------------------------------
# VG stanford


def write_vg_fixture(data_dir: str, n_train: int = 90, n_test: int = 30,
                     n_classes: int = 30, n_preds: int = 12, seed: int = 0):
    """VG-SGG.h5 + dicts + image_data.json + real JPEGs under ``data_dir``.

    Boxes are stored center-format int32 at BOX_SCALE like the real h5
    (the int-truncation center->corner behavior is exercised).
    """
    import h5py

    rng = np.random.RandomState(seed)
    base = os.path.join(data_dir, "VG", "stanford_filtered")
    images_dir = os.path.join(data_dir, "VG", "VG_100K")
    os.makedirs(base, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)

    n = n_train + n_test
    sizes = _image_sizes(rng, n)
    pools = _triplet_pools(rng, n_classes, n_preds)
    plans = _plan_images(rng, n_train, n_test, pools, n_classes, n_preds)

    boxes_ctr, labels, rels_flat, preds_flat = [], [], [], []
    first_box, last_box, first_rel, last_rel, split = [], [], [], [], []
    image_data = []
    for i in range(n):
        w, h = sizes[i]
        image_data.append({"image_id": i + 1, "width": w, "height": h,
                           "url": f"https://fixture/{i + 1}.jpg",
                           "coco_id": None, "flickr_id": None})
        scale = BOX_SCALE / max(w, h)
        g = _GraphBuilder(rng, w * scale, h * scale)
        for t in plans[i]:
            g.add_triplet(t)
        # render the GT objects into the JPEG (class-coded shapes) so
        # detection is learnable — boxes back in the w x h pixel frame
        _write_jpeg(os.path.join(images_dir, f"{i + 1}.jpg"), rng, w, h,
                    boxes_px=[[v / scale for v in b] for b in g.boxes],
                    classes=g.classes)
        fb = len(labels)
        for cls, (x1, y1, x2, y2) in zip(g.classes, g.boxes):
            # center-format ints; keep cx - w/2 >= 0 after truncation
            bw = max(int(x2 - x1), 2)
            bh = max(int(y2 - y1), 2)
            cx = max(int((x1 + x2) / 2), (bw + 1) // 2)
            cy = max(int((y1 + y2) / 2), (bh + 1) // 2)
            boxes_ctr.append([cx, cy, bw, bh])
            labels.append(cls)
        fr = len(preds_flat)
        for s, o, p in g.rels:
            rels_flat.append([fb + s, fb + o])
            preds_flat.append(p)
        first_box.append(fb)
        last_box.append(len(labels) - 1)
        first_rel.append(fr)
        last_rel.append(len(preds_flat) - 1)
        split.append(0 if i < n_train else 2)

    with h5py.File(os.path.join(base, "VG-SGG.h5"), "w") as f:
        f.create_dataset("split", data=np.asarray(split, np.int32))
        f.create_dataset("img_to_first_box",
                         data=np.asarray(first_box, np.int32))
        f.create_dataset("img_to_last_box",
                         data=np.asarray(last_box, np.int32))
        f.create_dataset("img_to_first_rel",
                         data=np.asarray(first_rel, np.int32))
        f.create_dataset("img_to_last_rel",
                         data=np.asarray(last_rel, np.int32))
        f.create_dataset("labels", data=np.asarray(labels, np.int64)[:, None])
        f.create_dataset(f"boxes_{BOX_SCALE}",
                         data=np.asarray(boxes_ctr, np.int32))
        f.create_dataset("relationships",
                         data=np.asarray(rels_flat, np.int32))
        f.create_dataset("predicates",
                         data=np.asarray(preds_flat, np.int64)[:, None])

    label_to_idx = {f"class{i:02d}": i for i in range(1, n_classes)}
    predicate_to_idx = {f"pred{i:02d}": i for i in range(1, n_preds)}
    dicts = {"label_to_idx": label_to_idx,
             "idx_to_label": {str(v): k for k, v in label_to_idx.items()},
             "predicate_to_idx": predicate_to_idx,
             "idx_to_predicate": {str(v): k
                                  for k, v in predicate_to_idx.items()},
             "attribute_to_idx": {}, "idx_to_attribute": {},
             "object_count": {k: 100 for k in label_to_idx},
             "predicate_count": {k: 100 for k in predicate_to_idx}}
    with open(os.path.join(base, "VG-SGG-dicts.json"), "w") as f:
        json.dump(dicts, f)
    with open(os.path.join(base, "image_data.json"), "w") as f:
        json.dump(image_data, f)
    return data_dir


# ---------------------------------------------------------------------------
# GQA


def write_gqa_fixture(data_dir: str, n_train: int = 40, n_val: int = 15,
                      n_classes: int = 25, n_preds: int = 10, seed: int = 1,
                      image_sizes: Optional[Tuple[int, int]] = None):
    """GQA sceneGraphs + balanced_questions + JPEGs under ``data_dir``.

    ``image_sizes``: the ``[lo, hi)`` range of the JPEGs' widths and
    heights in pixels; None keeps the default 240-520 (and the same
    bytes). Sizes above the canvas make the pipeline's resize shrink, as
    it does for real GQA photos.

    Image ids start at 300000 so a VG fixture can share ``VG/VG_100K``.
    Predicates include ``to the left of`` / ``to the right of`` so
    ``-exclude_left_right`` is exercised. GQA's eval builder uses
    zero-shot only (``with_10_100=False``), so only head/zs pools matter.
    """
    rng = np.random.RandomState(seed)
    base = os.path.join(data_dir, "GQA")
    sg_dir = os.path.join(base, "sceneGraphs")
    images_dir = os.path.join(data_dir, "VG", "VG_100K")
    os.makedirs(sg_dir, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)

    class_names = [f"gobj{i:02d}" for i in range(n_classes - 1)]
    pred_names = [f"gpred{i:02d}" for i in range(n_preds - 3)] + \
        ["to the left of", "to the right of"]
    pools = _triplet_pools(rng, len(class_names) + 1, len(pred_names) + 1)
    plans = _plan_images(rng, n_train, n_val, pools,
                         len(class_names) + 1, len(pred_names) + 1)

    sizes = _image_sizes(rng, n_train + n_val, *(image_sizes or ()))

    def build_sg(i):
        w, h = sizes[i]
        g = _GraphBuilder(rng, float(w), float(h))
        for t in plans[i]:
            g.add_triplet(t)
        # a couple of left/right rels per image so exclude_left_right bites
        if len(g.classes) >= 2:
            g.rels.append((0, 1, len(pred_names) - 1))
            g.rels.append((1, 0, len(pred_names)))
        objects = {}
        rel_lists: Dict[int, list] = {j: [] for j in range(len(g.classes))}
        for s, o, p in g.rels:
            rel_lists[s].append({"object": f"o{o}",
                                 "name": pred_names[p - 1]})
        for j, (cls, (x1, y1, x2, y2)) in enumerate(
                zip(g.classes, g.boxes)):
            objects[f"o{j}"] = {
                "name": class_names[cls - 1],
                "x": int(x1), "y": int(y1),
                "w": max(int(x2 - x1), 2), "h": max(int(y2 - y1), 2),
                "attributes": [], "relations": rel_lists[j]}
        return {"width": w, "height": h, "objects": objects}

    train_sgs, val_sgs = {}, {}
    train_qs, val_qs = {}, {}
    for i in range(n_train + n_val):
        imid = str(300000 + i)
        w, h = sizes[i]
        sg = build_sg(i)
        objs = list(sg["objects"].values())
        _write_jpeg(os.path.join(images_dir, f"{imid}.jpg"), rng, w, h,
                    boxes_px=[[o["x"], o["y"], o["x"] + o["w"],
                               o["y"] + o["h"]] for o in objs],
                    classes=[class_names.index(o["name"]) + 1
                             for o in objs])
        if i < n_train:
            train_sgs[imid] = sg
            train_qs[f"q{i}"] = {"imageId": imid,
                                 "question": "what is this?"}
        else:
            val_sgs[imid] = sg
            val_qs[f"q{i}"] = {"imageId": imid, "question": "what is this?"}

    with open(os.path.join(sg_dir, "train_sceneGraphs.json"), "w") as f:
        json.dump(train_sgs, f)
    with open(os.path.join(sg_dir, "val_sceneGraphs.json"), "w") as f:
        json.dump(val_sgs, f)
    with open(os.path.join(base, "train_balanced_questions.json"), "w") as f:
        json.dump(train_qs, f)
    with open(os.path.join(base, "val_balanced_questions.json"), "w") as f:
        json.dump(val_qs, f)
    return data_dir


# ---------------------------------------------------------------------------
# VTE


def write_vte_fixture(data_dir: str, n_train: int = 30, n_test: int = 12,
                      n_classes: int = 20, n_preds: int = 8, seed: int = 2):
    """vg1_2_meta.h5 + JPEGs under ``data_dir``.

    Image ids start at 600000. Class key layout reproduces the real h5:
    ``__background__`` is the SECOND class key alphabetically (the
    reference swaps keys 0/1 and asserts, vtranse.py:62-64) — one class
    name starts with an uppercase letter to sort before ``__background__``.
    """
    import h5py

    rng = np.random.RandomState(seed)
    vte_dir = os.path.join(data_dir, "VG", "vtranse")
    images_dir = os.path.join(data_dir, "VG", "VG_100K")
    os.makedirs(vte_dir, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)

    # final class list after the reference's 0/1 swap:
    # ['__background__', 'Avobj00', 'vobj01', ...]
    class_names = ["Avobj00"] + [f"vobj{i:02d}" for i in range(1, n_classes)]
    final_classes = ["__background__"] + class_names
    pred_names = [f"vpred{i:02d}" for i in range(n_preds)]

    pools = _triplet_pools(rng, len(final_classes), len(pred_names) + 1)
    plans = _plan_images(rng, n_train, n_test, pools,
                         len(final_classes), len(pred_names) + 1)
    sizes = _image_sizes(rng, n_train + n_test)

    path = os.path.join(vte_dir, "vg1_2_meta.h5")
    with h5py.File(path, "w") as f:
        for i in range(n_train + n_test):
            imid = str(600000 + i)
            w, h = sizes[i]
            g = _GraphBuilder(rng, float(w), float(h))
            for t in plans[i]:
                g.add_triplet(t)
            _write_jpeg(os.path.join(images_dir, f"{imid}.jpg"), rng, w, h,
                        boxes_px=g.boxes, classes=g.classes)
            if len(g.rels) == 0 or len(g.classes) < 2:
                continue
            boxes = np.asarray(g.boxes, np.float32)
            sub_boxes = np.stack([boxes[s] for s, _, _ in g.rels])
            obj_boxes = np.stack([boxes[o] for _, o, _ in g.rels])
            # rlp_labels: subj_cls, predicate (0-based, +1 applied by the
            # parser), obj_cls — class ids index the post-swap list
            rlp = np.asarray([[g.classes[s], p - 1, g.classes[o]]
                              for s, o, p in g.rels], np.int64)
            grp = "train" if i < n_train else "test"
            d = f.create_group(f"gt/{grp}/{imid}")
            d.create_dataset("sub_boxes", data=sub_boxes)
            d.create_dataset("obj_boxes", data=obj_boxes)
            d.create_dataset("rlp_labels", data=rlp)
        # meta groups: key order is alphabetical in HDF5; '__background__'
        # sorts after 'Avobj00' and before 'vobj*'
        cls_grp = f.create_group("meta/cls/name2idx")
        for idx, name in enumerate(["__background__"] + class_names):
            cls_grp.create_dataset(name, data=np.int64(idx))
        pre_grp = f.create_group("meta/pre/name2idx")
        for idx, name in enumerate(pred_names):
            pre_grp.create_dataset(name, data=np.int64(idx))
    return data_dir


def write_all_fixtures(data_dir: str, **kw):
    write_vg_fixture(data_dir)
    write_gqa_fixture(data_dir)
    write_vte_fixture(data_dir)
    return data_dir
