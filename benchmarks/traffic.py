"""The one generator of the benchmark's traffic: a pool of JPEG files and
the scene-graph annotations of a training split that cycles through it.

A traffic mix is a JSON file of parameters, ``benchmarks/workloads/
<traffic>.json``; everything it makes follows from ``--seed``. Every seed
gets the same set of sizes in another order: the image sides are evenly
spaced over the mix's range, and the objects and relations of each image
repeat one block drawn by quantiles from long-tailed laws with the
source's means (``graph_sizes``), so a seed changes which image holds
what, not how much work there is.

An image is smooth content (a coarse random grid, upsampled) with texture
(a finer one) and grain, so that a file weighs what a photo of its size
weighs, not what noise weighs; the pixels are drawn on the card, the
files encoded on the host. The files go to a directory under ``TMPDIR``,
which the run deletes at its end.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
WORKLOADS = ROOT / "workloads"


def load_mix(name: str) -> dict:
    """The parameters of traffic mix ``name``."""
    with open(WORKLOADS / f"{name}.json") as f:
        return json.load(f)


def seed_stream(seed: int, *tags: int) -> np.random.RandomState:
    """A numpy stream keyed on the run's seed (any size) and ``tags``."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *tags]
    return np.random.RandomState(
        np.random.SeedSequence(words).generate_state(4))


@dataclasses.dataclass
class Split:
    """A training split's annotations in the pool's image pixels."""

    files: List[str]                 # the pool's file names
    sizes: List[Tuple[int, int]]     # (height, width) of each file
    entry_file: np.ndarray           # the file index of each entry
    gt_boxes: List[np.ndarray]       # (n, 4) float32 x1 y1 x2 y2
    gt_classes: List[np.ndarray]     # (n,) int32, 1..C-1
    relationships: List[np.ndarray]  # (m, 3) int32 (subj, obj, predicate)

    def __len__(self) -> int:
        return len(self.gt_boxes)


def pool_sizes(mix: dict, seed: int) -> List[Tuple[int, int]]:
    """(height, width) of each pool file: long sides evenly spaced over the
    mix's range, each aspect of ``aspects`` in turn, in the seed's order."""
    n = mix["pool_files"]
    lo, hi = mix["long_side"]
    longs = np.linspace(lo, hi, n).round().astype(int)
    aspects = mix["aspects"]
    sizes = []
    for i, long in enumerate(longs):
        a, b = aspects[i % len(aspects)]   # width : height
        if a >= b:
            sizes.append((int(round(long * b / a)), int(long)))
        else:
            sizes.append((int(long), int(round(long * a / b))))
    order = seed_stream(seed, 1).permutation(n)
    return [sizes[i] for i in order]


def render_image(h: int, w: int, gen, device):
    """(h, w, 3) uint8 on ``device``: smooth colour fields (a 6-cell grid,
    bicubic), texture (a 48-cell grid) and grain, drawn from ``gen``."""
    import torch
    import torch.nn.functional as F

    def field(cells: int, amp: float):
        gh = max(2, int(round(cells * h / max(h, w))))
        gw = max(2, int(round(cells * w / max(h, w))))
        grid = torch.rand((1, 3, gh, gw), generator=gen, device=device)
        return F.interpolate(grid, size=(h, w), mode="bicubic",
                             align_corners=False) * amp

    img = field(6, 200.0) + field(48, 50.0)
    img = img + torch.randn((1, 1, h, w), generator=gen, device=device) * 4
    return img.clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)


def write_pool(mix: dict, seed: int, directory: str, workers: int = 8,
               device="cpu") -> Tuple[List[str], List[Tuple[int, int]]]:
    """Write the pool's JPEGs into ``directory``; (names, sizes). The
    pixels are drawn on ``device`` from one generator seeded by the run's
    seed, the files encoded on ``workers`` threads."""
    import torch
    from PIL import Image
    sizes = pool_sizes(mix, seed)
    names = [f"{i:04d}.jpg" for i in range(len(sizes))]
    os.makedirs(directory, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(
        (seed * 0x2545F4914F6CDD1D + 7) % (2 ** 63))

    def encode(i, img):
        Image.fromarray(img).save(os.path.join(directory, names[i]),
                                  quality=mix["jpeg_quality"])

    with ThreadPoolExecutor(max_workers=workers) as pool:
        done = [pool.submit(encode, i, render_image(h, w, gen, device)
                            .cpu().numpy())
                for i, (h, w) in enumerate(sizes)]
        for f in done:
            f.result()
    return names, sizes


def num_entries(mix: dict, batch_size: int, seconds: float) -> int:
    """Entries in the split: enough at ``images_per_s_cap`` for the set-up's
    steps and the window, so that no epoch ends inside it."""
    images = mix["images_per_s_cap"] * (seconds + mix["epoch_margin_s"])
    return int(np.ceil(images / batch_size)) * batch_size


def nb_quantile(mean: float, shape: float, kmax: int, u: np.ndarray
                ) -> np.ndarray:
    """The negative binomial law of ``mean`` and ``shape`` (variance mean +
    mean**2 / shape), cut at ``kmax`` and renormalised, at quantiles
    ``u``."""
    if mean <= 0 or kmax <= 0:
        return np.zeros(np.shape(u), np.int64)
    q = mean / (shape + mean)
    k = np.arange(kmax, dtype=np.float64)
    pmf = np.concatenate([[1.0], np.cumprod((k + shape) / (k + 1) * q)])
    cdf = np.cumsum(pmf)
    return np.minimum(np.searchsorted(cdf / cdf[-1], u, side="right"), kmax)


def _solve(target: float, block_mean) -> float:
    """The law's parameter whose block has the mean ``target`` (the block's
    mean rises with it)."""
    lo, hi = 0.0, 4.0 * target + 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if block_mean(mid) < target else (lo, mid)
    return (lo + hi) / 2


def graph_sizes(mix: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(objects, relations) of each image of the mix's block, the same for
    every seed. Objects: ``min`` plus a negative binomial of shape
    ``dispersion``, cut at ``max``, at the block's evenly spaced
    quantiles, its mean the published one. Relations: 1 plus a negative
    binomial whose mean grows with the image's objects (proportion solved
    for the published mean), cut at n(n-1), at quantiles of a golden-ratio
    sequence (spread evenly, independent of the objects' order). The
    block is given in a fixed order that mixes small and large images."""
    obj, rel = mix["objects"], mix["relations"]
    K = mix["block"]
    u = (np.arange(K) + 0.5) / K
    v = (np.arange(1, K + 1) * 0.6180339887498949) % 1.0
    lo, hi = obj["min"], obj["max"]

    def objects(mean):
        return lo + nb_quantile(mean, obj["dispersion"], hi - lo, u)

    n = objects(_solve(obj["mean"] - lo, lambda p: objects(p).mean() - lo))
    kinds = np.unique(n)

    def relations(per_object):
        m = np.ones(K, np.int64)
        for c in kinds:
            at = n == c
            m[at] += nb_quantile(per_object * c - 1, rel["dispersion"],
                                 c * (c - 1) - 1, v[at])
        return m

    m = relations(_solve(rel["mean"], lambda p: relations(p).mean()))
    # a fixed stride through the block, so that a part of it holds small
    # and large images alike
    stride = int(K * 0.618)
    while math.gcd(stride, K) != 1:
        stride += 1
    at = np.arange(K) * stride % K
    return n[at], m[at]


def zipf(count: int, exponent: float) -> np.ndarray:
    """Frequencies of ranks 1..count falling as rank**-exponent."""
    p = np.arange(1, count + 1, dtype=np.float64) ** -exponent
    return p / p.sum()


def grouped_order(n_entries: int, group: int, rng) -> np.ndarray:
    """An order of the repeated block in which every seed gets the same
    groups of ``group`` consecutive entries (a test loader's batches):
    one arrangement of the block into groups, the same for every seed,
    whose groups the seed puts in another order, each group's entries in
    another order too. So a seed changes which batch comes when, never
    which sizes share a batch."""
    if n_entries % group:
        raise ValueError(f"{n_entries} entries are not groups of {group}")
    groups = seed_stream(0, 4).permutation(n_entries).reshape(-1, group)
    groups = groups[rng.permutation(len(groups))]
    inside = np.argsort(rng.rand(*groups.shape), axis=1)
    return np.take_along_axis(groups, inside, 1).reshape(-1)


def annotations(mix: dict, seed: int, sizes: List[Tuple[int, int]],
                n_entries: int, num_classes: int,
                num_predicates: int, group: int = 0,
                stream: int = 3) -> Split:
    """The split: entry ``i`` shows pool file ``entry_file[i]`` with its own
    boxes, classes and relations. The per-image counts are the block of
    ``graph_sizes`` repeated, in the seed's order (with ``group``, in
    ``grouped_order``); classes and predicates are drawn from Zipf laws
    over their indices (index 1 the most frequent); the relations of an
    image are distinct ordered pairs of distinct objects. ``stream`` keys
    the draws, so that two splits of one seed differ. Drawn in bulk: a
    split of tens of thousands of entries takes a fraction of a second."""
    rng = seed_stream(seed, stream)
    block_n, block_m = graph_sizes(mix)
    order = (grouped_order(n_entries, group, rng) if group
             else rng.permutation(n_entries))
    counts = np.resize(block_n, n_entries)[order]
    n_rels = np.resize(block_m, n_entries)[order]
    entry_file = np.arange(n_entries) % len(sizes)
    hw = np.asarray(sizes, np.float64)[entry_file]           # (n_entries, 2)
    obj_hw = np.repeat(hw, counts, axis=0)                   # (T, 2)
    total = int(counts.sum())
    frac_lo, frac_hi = mix["box_side_frac"]
    frac = np.exp(rng.uniform(np.log(frac_lo), np.log(frac_hi), (total, 2)))
    bw = np.maximum(frac[:, 0] * obj_hw[:, 1], mix["box_min_px"])
    bh = np.maximum(frac[:, 1] * obj_hw[:, 0], mix["box_min_px"])
    x1 = rng.rand(total) * (obj_hw[:, 1] - bw)
    y1 = rng.rand(total) * (obj_hw[:, 0] - bh)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
    classes = 1 + rng.choice(num_classes - 1, total,
                             p=zipf(num_classes - 1, mix["class_zipf"]))
    classes = classes.astype(np.int32)
    n_pairs = counts * (counts - 1)
    # each image's pairs: the first distinct ones of 4 m draws, or, where
    # those hold too few, a draw without replacement
    draw_starts = np.concatenate([[0], np.cumsum(4 * n_rels)])
    draws = (rng.rand(int(draw_starts[-1]))
             * np.repeat(n_pairs, 4 * n_rels)).astype(np.int64)
    preds = 1 + rng.choice(num_predicates - 1, int(n_rels.sum()),
                           p=zipf(num_predicates - 1, mix["predicate_zipf"]))
    starts = np.concatenate([[0], np.cumsum(counts)])
    rel_starts = np.concatenate([[0], np.cumsum(n_rels)])
    boxes_l, classes_l, rels_l = [], [], []
    for i in range(n_entries):
        n, m = int(counts[i]), int(n_rels[i])
        row = draws[draw_starts[i]:draw_starts[i + 1]]
        flat, first = np.unique(row, return_index=True)
        if len(flat) >= m:
            flat = row[np.sort(first)[:m]]
        else:
            flat = rng.choice(n * (n - 1), m, replace=False)
        subj = flat // (n - 1)
        obj = flat % (n - 1)
        obj = obj + (obj >= subj)            # skip the diagonal
        rels_l.append(np.stack([subj, obj,
                                preds[rel_starts[i]:rel_starts[i + 1]]], 1)
                      .astype(np.int32))
        boxes_l.append(boxes[starts[i]:starts[i + 1]])
        classes_l.append(classes[starts[i]:starts[i + 1]])
    return Split(files=[], sizes=sizes, entry_file=entry_file,
                 gt_boxes=boxes_l, gt_classes=classes_l,
                 relationships=rels_l)


def vocabulary(num_classes: int, num_predicates: int):
    """Class and predicate names (index 0 is the background)."""
    return (["__background__"] + [f"object{i:03d}"
                                  for i in range(1, num_classes)],
            ["__background__"] + [f"predicate{i:02d}"
                                  for i in range(1, num_predicates)])
