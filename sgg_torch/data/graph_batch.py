"""Fixed-shape padded scene-graph batches (host numpy, moved to torch).

Counterpart of ``sgg_tpu/data/graph_batch.py``: a batch is ``(B, N, ...)``
nodes and ``(B, E, ...)`` edges with validity masks, replacing the
reference's ragged ``Blob`` container (``dataloaders/blob.py``). The host
side builds numpy arrays; ``GraphBatch.to`` makes torch tensors on a device
(pinned memory and ``non_blocking`` copies for CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class GraphBatch:
    """One padded batch of scene graphs.

    Attributes (numpy on the host; torch tensors after ``to``):
      images: (B, H, W, 3) float images, or None.
      im_hw: (B, 2) float (height, width) of the valid image content.
      boxes: (B, N, 4) float32 ``[x1, y1, x2, y2]`` in image pixels.
      classes: (B, N) object classes (0 = background/padding).
      node_mask: (B, N) bool validity.
      rels: (B, E, 3) ``(subj_local, obj_local, predicate)``.
      rel_mask: (B, E) bool validity.
      im_scale_org: optional (B,) model-frame -> original-pixel factor.
      fmaps: optional (B, h, w, C) trunk feature maps from the frozen-trunk
        feature cache (``data/feature_cache.py``); batches that carry them
        have no images and the trunk does not run.
    """

    images: Optional[np.ndarray]
    im_hw: np.ndarray
    boxes: np.ndarray
    classes: np.ndarray
    node_mask: np.ndarray
    rels: np.ndarray
    rel_mask: np.ndarray
    im_scale_org: Optional[np.ndarray] = None
    fmaps: Optional[torch.Tensor] = None

    @property
    def batch_size(self) -> int:
        return self.boxes.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.boxes.shape[1]

    @property
    def max_edges(self) -> int:
        return self.rels.shape[1]

    def to(self, device) -> "GraphBatch":
        """Torch tensors on ``device``; index arrays become int64 (what
        ``torch.gather`` takes). Fields already on a device are moved
        as they are."""
        device = torch.device(device)
        cuda = device.type == "cuda"

        def place(x, dtype=None):
            if x is None:
                return None
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x))
            if dtype is not None:
                t = t.to(dtype)
            if cuda and t.device.type == "cpu":
                return t.pin_memory().to(device, non_blocking=True)
            return t.to(device)

        return GraphBatch(
            images=place(self.images),
            im_hw=place(self.im_hw),
            boxes=place(self.boxes, torch.float32),
            classes=place(self.classes, torch.int64),
            node_mask=place(self.node_mask, torch.bool),
            rels=place(self.rels, torch.int64),
            rel_mask=place(self.rel_mask, torch.bool),
            im_scale_org=place(self.im_scale_org),
            fmaps=place(self.fmaps))


def pack_graph_batch(boxes, classes, node_offsets, rels, rel_offsets,
                     n_max: int, e_max: int):
    """Pack ragged per-image graphs into padded buffers (numpy).

    The numpy path of ``sgg_tpu/native/__init__.py:pack_graph_batch``.
    Returns (boxes (B,N,4) f32, classes (B,N) i32, node_mask (B,N) u8,
    rels (B,E,3) i32, rel_mask (B,E) u8, dropped_rel_count).
    """
    B = len(node_offsets) - 1
    boxes = np.ascontiguousarray(boxes, dtype=np.float32).reshape(-1, 4)
    classes = np.ascontiguousarray(classes, dtype=np.int32)
    rels = np.ascontiguousarray(rels, dtype=np.int32).reshape(-1, 3)
    out_boxes = np.zeros((B, n_max, 4), dtype=np.float32)
    out_classes = np.zeros((B, n_max), dtype=np.int32)
    out_node_mask = np.zeros((B, n_max), dtype=np.uint8)
    out_rels = np.zeros((B, e_max, 3), dtype=np.int32)
    out_rel_mask = np.zeros((B, e_max), dtype=np.uint8)
    dropped = 0
    for b in range(B):
        ns, ne = node_offsets[b], node_offsets[b + 1]
        n = min(ne - ns, n_max)
        out_boxes[b, :n] = boxes[ns:ns + n]
        out_classes[b, :n] = classes[ns:ns + n]
        out_node_mask[b, :n] = 1
        w = 0
        for r in range(rel_offsets[b], rel_offsets[b + 1]):
            s, o, p = rels[r]
            if s >= n or o >= n or s < 0 or o < 0 or w >= e_max:
                dropped += 1
                continue
            out_rels[b, w] = (s, o, p)
            out_rel_mask[b, w] = 1
            w += 1
    return (out_boxes, out_classes, out_node_mask, out_rels, out_rel_mask,
            dropped)


def pack_ragged(per_image_boxes, per_image_classes, per_image_rels,
                max_nodes: int, max_edges: int,
                images: Optional[np.ndarray] = None,
                im_hw: Optional[np.ndarray] = None,
                im_scale_org: Optional[np.ndarray] = None) -> GraphBatch:
    """Pack a list of ragged per-image graphs into a host GraphBatch
    (``sgg_tpu/data/graph_batch.py:pack_ragged``)."""
    B = len(per_image_boxes)
    node_offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(b) for b in per_image_boxes], out=node_offsets[1:])
    rel_offsets = np.zeros(B + 1, dtype=np.int64)
    np.cumsum([len(r) for r in per_image_rels], out=rel_offsets[1:])

    boxes = (np.concatenate(per_image_boxes, axis=0)
             if node_offsets[-1] else np.zeros((0, 4), np.float32))
    classes = (np.concatenate(per_image_classes, axis=0)
               if node_offsets[-1] else np.zeros((0,), np.int32))
    rels = (np.concatenate(per_image_rels, axis=0)
            if rel_offsets[-1] else np.zeros((0, 3), np.int32))

    pb, pc, pnm, pr, prm, _ = pack_graph_batch(
        boxes, classes, node_offsets, rels, rel_offsets, max_nodes, max_edges)

    if im_hw is None:
        if images is not None:
            im_hw = np.tile(np.asarray(images.shape[1:3], np.float32), (B, 1))
        else:
            im_hw = np.ones((B, 2), np.float32)
    return GraphBatch(
        images=images,
        im_hw=np.asarray(im_hw, np.float32),
        boxes=pb,
        classes=pc,
        node_mask=pnm.astype(bool),
        rels=pr,
        rel_mask=prm.astype(bool),
        im_scale_org=(None if im_scale_org is None
                      else np.asarray(im_scale_org, np.float32)),
    )
