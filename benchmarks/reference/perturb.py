"""The GAN cell's host inputs, written out again: the classes' embeddings
(a unit Gaussian seeded by each word's SHA-256 where no GloVe file is
present, averaged over a name's words, normalised), the dataset's
(subject, predicate) -> object and (predicate, object) -> subject counts,
and the GraphN perturbation of a batch (Knyazev et al., ICCV 2021): per
image, round(L n) nodes drawn with probability proportional to their
degree, each given a class that co-occurs with its relations in the
dataset (inversely to frequency), then one of that class's top-k
semantic neighbours. Each image draws from a stream seeded by the CRC-32
of its padded int32 classes and float32 boxes, mixed with the epoch and
the run's seed.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import Dict, List, Sequence

import numpy as np


def word_vector(word: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4],
                          "little")
    v = np.random.RandomState(seed).randn(dim).astype(np.float32)
    return v / np.linalg.norm(v)


def class_embeddings(names: Sequence[str], dim: int = 200) -> np.ndarray:
    out = np.zeros((len(names), dim), np.float32)
    for i, name in enumerate(names):
        words = name.lower().split(" ")
        out[i] = np.mean([word_vector(w, dim) for w in (words or [name])],
                         axis=0)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.where(norm > 0, norm, 1.0)


def pair_counts(classes: List[np.ndarray], rels: List[np.ndarray]):
    """({"s_p": {o: count of (s, p, o)}}, {"p_o": {s: count}})."""
    triplets: Dict[str, int] = {}
    for c, r in zip(classes, rels):
        for s, o, p in r:
            key = f"{c[s]}_{p}_{c[o]}"
            triplets[key] = triplets.get(key, 0) + 1
    sp, po = {}, {}
    for c, r in zip(classes, rels):
        for s, o, p in r:
            n = triplets[f"{c[s]}_{p}_{c[o]}"]
            sp.setdefault(f"{c[s]}_{p}", {})[int(c[o])] = n
            po.setdefault(f"{p}_{c[o]}", {})[int(c[s])] = n
    return sp, po


class GraphN:
    def __init__(self, embed: np.ndarray, sp, po, L: float, topk: int,
                 alpha: int):
        sim = embed @ embed.T
        sim[0, :] = -np.inf
        sim[:, 0] = -np.inf
        np.fill_diagonal(sim, -np.inf)
        self.sim, self.sp, self.po = sim, sp, po
        self.L, self.topk, self.alpha = L, topk, alpha

    def batch(self, classes, boxes, rels, node_mask, rel_mask, epoch: int,
              seed: int) -> np.ndarray:
        c32 = np.ascontiguousarray(classes, np.int32)
        b32 = np.ascontiguousarray(boxes, np.float32)
        out = np.asarray(classes).copy()
        for b in range(out.shape[0]):
            n = int(node_mask[b].sum())
            if n == 0:
                continue
            s = (zlib.crc32(c32[b].tobytes() + b32[b].tobytes())
                 ^ (epoch * 0x9E3779B1) ^ (seed * 0x85EBCA6B)) & 0xFFFFFFFF
            rng = np.random.RandomState(s)
            valid = rels[b][rel_mask[b]]
            fg = valid[valid[:, 2] > 0]
            out[b, :n] = self.image(out[b, :n].copy(), fg, rng)
        return out

    def image(self, classes, rels, rng):
        n = len(classes)
        degree = np.zeros(n, np.float64)
        for s, o, _ in rels:
            degree[s] += 1
            degree[o] += 1
        probs = np.clip(degree, 1e-2, None)
        probs = probs / probs.sum()
        k = min(max(1, int(round(self.L * n))), n)
        for ind in rng.choice(np.arange(n), size=k, replace=False, p=probs):
            attached = rels[(rels[:, 0] == ind) | (rels[:, 1] == ind)]
            classes[ind] = self.node(classes, attached, ind, rng)
        return classes

    def node(self, classes, rels, ind, rng) -> int:
        cls = int(classes[ind])
        cands_by = {}
        for s, o, p in rels:
            key, table = ((f"{p}_{classes[o]}", self.po) if ind == s
                          else (f"{classes[s]}_{p}", self.sp))
            for other, freq in table.get(key, {}).items():
                if other != cls:
                    cands_by.setdefault(int(other), []).append(freq)
        need = max(1, min(len(rels), 2))
        cands, means = [], []
        for other, freqs in cands_by.items():
            freqs = np.asarray(freqs)
            if len(freqs) >= need and freqs.min() >= self.alpha:
                cands.append(other)
                means.append(freqs.mean())
        new = cls
        if cands:
            p = 1.0 / np.asarray(means, np.float64)
            new = int(rng.choice(cands, p=p / p.sum()))
        if self.topk > 0:
            sim = self.sim[new].copy()
            sim[new] = np.inf
            sim[cls] = -np.inf
            new = int(rng.choice(np.argsort(sim)[-(self.topk + 1):]))
        return new
