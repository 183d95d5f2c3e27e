"""Per-class visual feature bank for GAN conditioning (``-vis_cond``).

Counterpart of ``sgg_tpu/augment/feature_bank.py`` (reference
``extract_features.py:50-76`` and ``augment/gan.py:192-199``): the writer
appends per-class RoIAligned node features to ``features.hdf5``; the bank
keeps bounded per-class reservoirs in RAM, read once, and samples one
fixed-shape ``(B, N, p, p, C)`` array a step with a vectorized numpy
gather. Its draws repeat the JAX package's exactly: both come from one
``numpy.random.RandomState(seed)`` in the same order.

``h5py`` is imported where a file is opened, so the module imports on a
machine without it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np


class FeatureBankWriter:
    """Appends per-class features to an hdf5 bank (reference
    extract_features.py:50-76)."""

    def __init__(self, path: str, feature_shape: Sequence[int]):
        import h5py
        self.f = h5py.File(path, "a")
        self.feature_shape = tuple(feature_shape)

    def append(self, class_name: str, features: np.ndarray):
        """features: (n, *feature_shape)."""
        features = np.asarray(features, np.float32).reshape(
            -1, int(np.prod(self.feature_shape)))
        if class_name not in self.f:
            self.f.create_dataset(
                class_name, data=features, maxshape=(None, features.shape[1]),
                chunks=True)
        else:
            d = self.f[class_name]
            d.resize(d.shape[0] + features.shape[0], axis=0)
            d[-features.shape[0]:] = features

    def close(self):
        self.f.close()


class FeatureBank:
    """Samples per-class conditioning features for padded batches."""

    def __init__(self, path: str, class_names: Sequence[str],
                 pool_sz: int = 7, n_ch: int = 512,
                 max_per_class: int = 64, seed: int = 0):
        import h5py
        with h5py.File(path, "r") as f:
            self._fill(f, class_names, pool_sz, n_ch, max_per_class, seed)

    @classmethod
    def _from_pools(cls, pools: Mapping[str, np.ndarray],
                    class_names: Sequence[str], pool_sz: int = 7,
                    n_ch: int = 512, max_per_class: int = 64,
                    seed: int = 0) -> "FeatureBank":
        """The bank that a file holding ``pools`` (class name -> (n, p*p*C)
        rows, as the writer stores them) gives, with the same draws, for a
        machine without ``h5py``."""
        bank = cls.__new__(cls)
        bank._fill(pools, class_names, pool_sz, n_ch, max_per_class, seed)
        return bank

    def _fill(self, datasets, class_names, pool_sz, n_ch, max_per_class,
              seed) -> None:
        """The reservoirs: for each class in class order that ``datasets``
        holds, ``take`` sorted rows drawn without replacement."""
        self.pool_sz = pool_sz
        self.n_ch = n_ch
        self.rng = np.random.RandomState(seed)
        self.reservoir: Dict[int, np.ndarray] = {}
        dim = pool_sz * pool_sz * n_ch
        for cls_idx, name in enumerate(class_names):
            if name not in datasets:
                continue
            d = datasets[name]
            take = min(len(d), max_per_class)
            idx = np.sort(self.rng.choice(len(d), take, replace=False))
            self.reservoir[cls_idx] = np.asarray(d[idx], np.float32).reshape(
                take, dim)

    def sample(self, classes: np.ndarray,
               node_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """classes (B, N) -> (B, N, p, p, n_ch) random real features of the
        same classes; zeros for classes absent from the bank and for
        padding. One gather a class present in the batch."""
        B, N = classes.shape
        classes = np.asarray(classes)
        dim = self.pool_sz * self.pool_sz * self.n_ch
        out = np.zeros((B, N, dim), np.float32)
        valid = (np.asarray(node_mask, bool) if node_mask is not None
                 else np.ones((B, N), bool))
        for c in np.unique(classes[valid]):
            rows = self.reservoir.get(int(c))
            if rows is None:
                continue
            sel = valid & (classes == c)
            n = int(sel.sum())
            out[sel] = rows[self.rng.randint(len(rows), size=n)]
        return out.reshape(B, N, self.pool_sz, self.pool_sz, self.n_ch)
