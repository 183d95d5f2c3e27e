"""Scene-graph perturbations for compositional augmentation (host side).

The port's copy of ``sgg_tpu/augment/perturb.py`` (numpy only; reference
``augment/sg_perturb.py``), ``SceneGraphPerturb``:
per image, sample ``round(L * n_nodes)`` nodes with probability proportional
to node degree^smoothing (or uniformly), then replace each sampled node's
class by one of three strategies:

* ``rand`` — any class except background and the current one;
* ``neigh`` — one of the top-k embedding-cosine neighbors;
* ``graphn`` — candidate classes that co-occur in enough dataset contexts
  (``>= max(1, min(n_rels, 2))`` matching relations, each with dataset
  frequency ``>= alpha``), sampled with probability inversely proportional to
  mean frequency, then optionally re-sampled among top-k semantic neighbors.

This runs on the host over padded numpy batches before the copy to the
device (the reference likewise runs it in Python per step,
``main.py:131``): it is data-dependent control flow over a few dozen
nodes an image.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def pairwise_similarity(embed: np.ndarray) -> np.ndarray:
    """Cosine-ish similarity with background/self excluded
    (reference sg_perturb.py:182-187)."""
    sim = embed @ embed.T
    sim[0, :] = -np.inf
    sim[:, 0] = -np.inf
    np.fill_diagonal(sim, -np.inf)
    return sim


class SceneGraphPerturb:
    """method in {rand, neigh, graphn}."""

    def __init__(self, method: str, embed_objs: np.ndarray,
                 subj_pred_pairs: Dict[str, Dict[int, int]],
                 pred_obj_pairs: Dict[str, Dict[int, int]],
                 L: float = 0.2, topk: int = 5, alpha: int = 2,
                 uniform: bool = False, degree_smoothing: float = 1.0,
                 seed: Optional[int] = None):
        assert method in ("rand", "neigh", "graphn"), method
        self.method = method
        self.sim = pairwise_similarity(embed_objs)
        self.subj_pred_pairs = subj_pred_pairs
        self.pred_obj_pairs = pred_obj_pairs
        self.L = L
        self.topk = topk
        self.alpha = alpha
        self.uniform = uniform
        self.degree_smoothing = degree_smoothing
        self.n_classes = self.sim.shape[0]
        self.rng = np.random.RandomState(seed)
        if method == "neigh":
            assert topk > 0, topk

    # ------------------------------------------------------------------
    def perturb_batch(self, classes: np.ndarray, rels: np.ndarray,
                      node_mask: np.ndarray, rel_mask: np.ndarray,
                      seeds=None) -> np.ndarray:
        """Perturb a padded batch. classes (B,N); rels (B,E,3) with
        predicate>0 = FG. Returns new (B,N) classes.

        ``seeds``: optional per-image ints; when given, image ``b`` draws
        from its own ``RandomState(seeds[b])`` instead of the shared
        sequential stream — making the perturbation of an image
        independent of batch composition and process sharding (the
        multi-host GAN path derives these from image content, see
        Trainer._gan_host_inputs in train/trainer.py)."""
        out = classes.copy()
        shared_rng = self.rng
        try:
            for b in range(classes.shape[0]):
                n = int(node_mask[b].sum())
                if n == 0 or self.L <= 0:
                    continue
                if seeds is not None:
                    self.rng = np.random.RandomState(seeds[b])
                valid_rels = rels[b][rel_mask[b]]
                fg = valid_rels[valid_rels[:, 2] > 0]
                out[b, :n] = self._perturb_image(out[b, :n].copy(), fg)
        finally:
            self.rng = shared_rng
        return out

    def _perturb_image(self, classes: np.ndarray,
                       rels: np.ndarray) -> np.ndarray:
        n = len(classes)
        node_inds = self._sample_nodes(n, rels)
        for ind in node_inds:
            attached = rels[(rels[:, 0] == ind) | (rels[:, 1] == ind)]
            classes[ind] = self._perturb_object(classes, attached, ind)
        return classes

    def _sample_nodes(self, n: int, rels: np.ndarray) -> np.ndarray:
        """Degree-weighted node sampling (sg_perturb.py:148-178)."""
        if self.uniform:
            probs = np.ones(n, np.float64)
        else:
            degrees = np.zeros(n, np.float64)
            for s, o, _ in rels:
                degrees[s] += 1
                degrees[o] += 1
            probs = np.clip(degrees ** self.degree_smoothing, 1e-2, None)
        probs = probs / probs.sum()
        k = max(1, int(round(self.L * n)))
        k = min(k, n)
        return self.rng.choice(np.arange(n), size=k, replace=False, p=probs)

    def _perturb_object(self, classes: np.ndarray, rels: np.ndarray,
                        ind: int) -> int:
        cls = int(classes[ind])
        if self.method == "rand":
            cands = [c for c in range(1, self.n_classes) if c != cls]
            return int(self.rng.choice(cands))

        if self.method == "neigh":
            cands = np.argsort(self.sim[cls])[-self.topk:]
            return int(self.rng.choice(cands))

        # graphn (sg_perturb.py:79-137)
        all_cands: Dict[int, list] = {}
        for s, o, p in rels:
            if ind == s:
                # "what else is <predicate> <object>?"
                key = f"{p}_{classes[o]}"
                pairs = self.pred_obj_pairs
            else:
                key = f"{classes[s]}_{p}"
                pairs = self.subj_pred_pairs
            if key in pairs:
                for obj, freq in pairs[key].items():
                    if obj != cls:
                        all_cands.setdefault(int(obj), []).append(freq)

        cands, probs = [], []
        need = max(1, min(len(rels), 2))
        for obj, freqs in all_cands.items():
            freqs = np.asarray(freqs)
            if len(freqs) >= need and freqs.min() >= self.alpha:
                cands.append(obj)
                probs.append(freqs.mean())
        if not cands:
            cls_new = cls
        else:
            probs = 1.0 / np.asarray(probs, np.float64)
            probs /= probs.sum()
            cls_new = int(self.rng.choice(cands, p=probs))

        if self.topk > 0:
            # re-sample among top-k semantic neighbors of cls_new
            # (including cls_new, excluding cls; sg_perturb.py:127-137)
            sim = self.sim[cls_new].copy()
            sim[cls_new] = np.inf
            sim[cls] = -np.inf
            cands = np.argsort(sim)[-(self.topk + 1):]
            cls_new = int(self.rng.choice(cands))
        return cls_new
