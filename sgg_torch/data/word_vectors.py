"""GloVe word vectors for class names.

The port's copy of ``sgg_tpu/data/word_vectors.py`` (numpy only; reference
``lib/word_vectors.py``): loads ``glove.6B.{dim}d``
from ``{data_dir}/glove`` (plain-text or cached ``.npy``), maps class names
to vectors with multi-word averaging and a longest-word fallback, and caches
the parsed vocabulary.

Zero-egress note: the reference downloads GloVe on demand; here, when no
GloVe files are present, we fall back to deterministic pseudo-embeddings
(unit-norm gaussian seeded by a stable hash of each word) so every component
that consumes embeddings (perturbations, GAN ``init_embed``) stays functional
and reproducible — semantic neighborhoods are then arbitrary but stable,
which is sufficient for tests; drop real GloVe files in to restore semantic
behavior.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _hash_vector(word: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
    v = np.random.RandomState(seed).randn(dim).astype(np.float32)
    return v / np.linalg.norm(v)


def load_word_vectors(wv_dir: str, wv_type: str = "glove.6B",
                      dim: int = 200) -> Optional[Dict[str, np.ndarray]]:
    """Parse ``{wv_dir}/glove/{wv_type}.{dim}d.txt`` (with .npy/.vocab
    cache); None if absent (reference load_word_vectors,
    word_vectors.py:58-150)."""
    base = os.path.join(wv_dir or ".", "glove", f"{wv_type}.{dim}d")
    npy, vocab_f, txt = base + ".npy", base + ".vocab", base + ".txt"
    if os.path.exists(npy) and os.path.exists(vocab_f):
        vectors = np.load(npy)
        with open(vocab_f) as f:
            vocab = f.read().splitlines()
        return dict(zip(vocab, vectors))
    if not os.path.exists(txt):
        return None
    vocab, rows = [], []
    with open(txt, "rb") as f:
        for line in f:
            parts = line.rstrip().split(b" ")
            vocab.append(parts[0].decode("utf-8", errors="replace"))
            rows.append(np.asarray(parts[1:], dtype=np.float32))
    vectors = np.stack(rows)
    try:
        np.save(npy, vectors)
        with open(vocab_f, "w") as f:
            f.write("\n".join(vocab))
    except OSError:
        pass
    return dict(zip(vocab, vectors))


def obj_edge_vectors(names: Sequence[str], wv_dir: str = "",
                     wv_dim: int = 200, avg_words: bool = True,
                     word_vectors: Optional[Dict[str, np.ndarray]] = None
                     ) -> Tuple[np.ndarray, Optional[dict]]:
    """Class-name embedding matrix (reference obj_edge_vectors,
    word_vectors.py:16-55): multi-word names average their word vectors
    (or use the longest word when ``avg_words`` is off / words are missing).
    """
    if word_vectors is None:
        word_vectors = load_word_vectors(wv_dir, dim=wv_dim)
    out = np.zeros((len(names), wv_dim), np.float32)
    for i, name in enumerate(names):
        token = name.lower()
        # reference lookup order (word_vectors.py:26-51): the WHOLE token
        # first (hyphenated names like 't-shirt' can be single GloVe
        # entries), then word-averaging, then the longest word
        words = token.split(" ")
        vecs: List[np.ndarray] = []
        if word_vectors is not None:
            if token in word_vectors:
                vecs = [word_vectors[token]]
            elif avg_words and len(words) > 1:
                vecs = [word_vectors[w] for w in words if w in word_vectors]
            if not vecs:
                for w in sorted(words, key=len, reverse=True):
                    if w in word_vectors:
                        vecs = [word_vectors[w]]
                        break
        if not vecs:
            # deterministic fallback (zero-egress environments / OOV names)
            vecs = [_hash_vector(w, wv_dim) for w in (words or [name])]
        out[i] = np.mean(vecs, axis=0)
    return out, word_vectors


def normalized_class_embeddings(names: Sequence[str], wv_dir: str = "",
                                wv_dim: int = 200) -> np.ndarray:
    """Unit-norm embeddings (reference gan.py:144)."""
    emb, _ = obj_edge_vectors(names, wv_dir=wv_dir, wv_dim=wv_dim)
    norm = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.where(norm > 0, norm, 1.0)
