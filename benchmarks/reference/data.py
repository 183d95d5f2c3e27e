"""The training loader, written out again: the epoch's order, each
example's flip and duplicate filtering, the uint8 canvas (decode, triangle
resize, flip, mean padding) and the padded batch; and the test loader's
example: no flip, a float32 canvas normalised on the host and padded
with zeros.

The rules are those of the reference framework's VG loader as the port
states them: the order is ``RandomState(seed + epoch)``'s shuffle, an
example draws its flip and then its duplicate filter from a stream keyed
on (seed, epoch, index), the canvas is the image resized so that its long
side spans the canvas, padded with the ImageNet mean rounded to uint8.
The resize is a separable triangle filter, each output pixel the weighted
mean of the input pixels under a tent as wide as the scale, summed in
float32 and rounded half up.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

MEAN_U8 = (np.asarray([0.485, 0.456, 0.406], np.float32) * 255).astype(
    np.uint8)


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The entries of an epoch in the order a shuffling loader takes them."""
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def batch_indices(n: int, batch: int, seed: int, epoch: int, step: int):
    """The entries of batch ``step`` of an epoch (last partial batch
    dropped)."""
    return epoch_order(n, seed, epoch)[step * batch:(step + 1) * batch]


def example_stream(seed: int, epoch: int, idx: int):
    ss = np.random.SeedSequence([seed, epoch, int(idx)])
    return np.random.RandomState(ss.generate_state(4))


def content_size(h: int, w: int, canvas: int):
    s = canvas / max(h, w)
    return (min(int(round(h * s)), canvas), min(int(round(w * s)), canvas),
            s)


def one_predicate_per_pair(rels: np.ndarray, rng) -> np.ndarray:
    """One predicate per (subject, object) pair, drawn among its
    duplicates, pairs in their first order."""
    groups = defaultdict(list)
    for s, o, p in rels:
        groups[(s, o)].append(p)
    return np.asarray([(s, o, rng.choice(ps)) for (s, o), ps in
                       groups.items()], dtype=rels.dtype).reshape(-1, 3)


def tent_weights(n_in: int, n_out: int):
    """(taps, n_out) input index and float32 weight of each output pixel."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    center = (np.arange(n_out) + 0.5) * scale
    lo = np.maximum(np.floor(center - support), 0).astype(np.int64)
    hi = np.minimum(np.ceil(center + support), n_in).astype(np.int64)
    taps = int((hi - lo).max())
    idx = lo + np.arange(taps)[:, None]
    t = 1.0 - np.abs((idx + 0.5 - center) / support)
    w = np.where((idx < hi) & (t > 0.0), t, 0.0)
    total = w.sum(0)
    w32 = w.astype(np.float32)
    w32 = np.where(total > 0.0, w32 / total.astype(np.float32), w32)
    return np.minimum(idx, n_in - 1), w32


def resize_u8(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """(ch, cw, 3) uint8: ``img`` through the separable triangle filter."""
    xi, xw = tent_weights(img.shape[1], cw)
    yi, yw = tent_weights(img.shape[0], ch)
    src = img.astype(np.float32)
    tmp = np.zeros((img.shape[0], cw, 3), np.float32)
    for k in range(len(xi)):
        tmp += xw[k][None, :, None] * src[:, xi[k]]
    acc = np.zeros((ch, cw, 3), np.float32)
    for k in range(len(yi)):
        acc += yw[k][:, None, None] * tmp[yi[k]]
    return np.clip(np.floor(acc + np.float32(0.5)), 0, 255).astype(np.uint8)


def canvas_u8(img: np.ndarray, canvas: int, ch: int, cw: int,
              flip: bool) -> np.ndarray:
    """(canvas, canvas, 3) uint8: ``img`` resized to (ch, cw), flipped if
    asked, at the top left of a canvas of the mean colour."""
    out = np.empty((canvas, canvas, 3), np.uint8)
    out[:] = MEAN_U8
    res = resize_u8(img, ch, cw)
    out[:ch, :cw] = res[:, ::-1] if flip else res
    return out


def canvas_f32(img: np.ndarray, canvas: int, ch: int, cw: int
               ) -> np.ndarray:
    """(canvas, canvas, 3) float32, the test loader's canvas: ``img``
    resized to (ch, cw), scaled to [0, 1] and normalised by the ImageNet
    mean and deviation, at the top left of a canvas of zeros (the mean)."""
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    out = np.zeros((canvas, canvas, 3), np.float32)
    out[:ch, :cw] = (resize_u8(img, ch, cw).astype(np.float32) / 255.0
                     - mean) / std
    return out


def decode(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def example(path: str, boxes: np.ndarray, rels: np.ndarray, canvas: int,
            rng):
    """(canvas, boxes in canvas pixels, relations, (ch, cw)) of a training
    example whose boxes are in the file's pixels."""
    img = decode(path)
    h, w = img.shape[:2]
    ch, cw, s = content_size(h, w, canvas)
    b = boxes.astype(np.float32).copy()
    b *= s
    b[:, 0::2] = b[:, 0::2].clip(0, cw)
    b[:, 1::2] = b[:, 1::2].clip(0, ch)
    flip = rng.rand() > 0.5
    if flip:
        x1, x2 = cw - b[:, 2].copy(), cw - b[:, 0].copy()
        b[:, 0], b[:, 2] = x1, x2
    if len(rels):
        rels = one_predicate_per_pair(rels, rng)
    return canvas_u8(img, canvas, ch, cw, flip), b, rels, (ch, cw)


def batch(paths: Sequence[str], boxes: List[np.ndarray],
          classes: List[np.ndarray], rels: List[np.ndarray],
          indices: Sequence[int], seed: int, epoch: int, canvas: int,
          max_nodes: int, max_edges: int, workers: int = 8) -> dict:
    """The padded batch of ``indices`` as numpy arrays."""
    def one(i):
        return example(paths[i], boxes[i], rels[i], canvas,
                       example_stream(seed, epoch, i))

    with ThreadPoolExecutor(max_workers=workers) as pool:
        ex = list(pool.map(one, indices))
    B = len(indices)
    out = {"images": np.stack([e[0] for e in ex]),
           "im_hw": np.asarray([e[3] for e in ex], np.float32),
           "boxes": np.zeros((B, max_nodes, 4), np.float32),
           "classes": np.zeros((B, max_nodes), np.int64),
           "node_mask": np.zeros((B, max_nodes), bool),
           "rels": np.zeros((B, max_edges, 3), np.int64),
           "rel_mask": np.zeros((B, max_edges), bool)}
    for b, (i, e) in enumerate(zip(indices, ex)):
        n = min(len(classes[i]), max_nodes)
        out["boxes"][b, :n] = e[1][:n]
        out["classes"][b, :n] = classes[i][:n]
        out["node_mask"][b, :n] = True
        keep = [r for r in e[2] if 0 <= r[0] < n and 0 <= r[1] < n]
        keep = keep[:max_edges]
        if keep:
            out["rels"][b, :len(keep)] = np.asarray(keep)
            out["rel_mask"][b, :len(keep)] = True
    return out


def test_example(path: str, boxes: np.ndarray, canvas: int):
    """(float32 canvas, boxes in canvas pixels) of a test example whose
    boxes are in the file's pixels: no flip, no draw."""
    img = decode(path)
    h, w = img.shape[:2]
    ch, cw, s = content_size(h, w, canvas)
    b = boxes.astype(np.float32).copy()
    b *= s
    b[:, 0::2] = b[:, 0::2].clip(0, cw)
    b[:, 1::2] = b[:, 1::2].clip(0, ch)
    return canvas_f32(img, canvas, ch, cw), b
