"""The port's copies of the GAN's host-side helpers against ``sgg_tpu``'s:
the word vectors (``data/word_vectors.py``: the hashed fall-back vectors, a
GloVe text file, class-name embeddings) and the scene-graph perturbations
(``augment/perturb.py``: ``rand``, ``neigh``, ``graphn``, with and without
per-image seeds), all equal bit for bit; and the trainer's content seeds
(``Trainer._gan_host_inputs``) equal to the JAX trainer's on the same host
batch."""

import types

import numpy as np
import pytest

from sgg_tpu.augment import perturb as jperturb
from sgg_tpu.data import word_vectors as jwv
from sgg_tpu.data.synthetic import SyntheticSGGDataset as JSynth
from sgg_tpu.train.trainer import Trainer as JTrainer
from sgg_torch.augment import perturb
from sgg_torch.data import word_vectors as wv
from sgg_torch.data.synthetic import SyntheticSGGDataset, synthetic_splits
from sgg_torch.train.trainer import Trainer

NAMES = ["__background__", "man", "t-shirt", "traffic light", "tree",
         "wheel", "surfboard", "dog", "street sign"]


def test_hash_vectors_and_embeddings_equal():
    for word in ("man", "t-shirt", "surfboard", "x"):
        np.testing.assert_array_equal(wv._hash_vector(word, 200),
                                      jwv._hash_vector(word, 200))
    np.testing.assert_array_equal(
        wv.normalized_class_embeddings(NAMES, wv_dir="no_such_dir"),
        jwv.normalized_class_embeddings(NAMES, wv_dir="no_such_dir"))


def test_glove_file_lookup_equal(tmp_path):
    """A tiny GloVe text file: the whole token first, then word averaging,
    then the longest word, then the hashed fall-back, as both read it (the
    parsed vocabulary cached as .npy/.vocab on the first read)."""
    rng = np.random.RandomState(0)
    words = ["man", "t-shirt", "traffic", "light", "tree", "sign"]
    (tmp_path / "glove").mkdir()
    with open(tmp_path / "glove" / "glove.6B.8d.txt", "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{x:.6f}" for x in rng.randn(8))
                    + "\n")
    want, _ = jwv.obj_edge_vectors(NAMES, wv_dir=str(tmp_path), wv_dim=8)
    got, vocab = wv.obj_edge_vectors(NAMES, wv_dir=str(tmp_path), wv_dim=8)
    np.testing.assert_array_equal(got, want)
    assert set(vocab) == set(words)
    assert (tmp_path / "glove" / "glove.6B.8d.npy").exists()
    got, _ = wv.obj_edge_vectors(NAMES, wv_dir=str(tmp_path), wv_dim=8)
    np.testing.assert_array_equal(got, want)  # from the cache


def _pairs(ds):
    return ds.subj_pred_pairs, ds.pred_obj_pairs


@pytest.fixture(scope="module")
def data():
    """A synthetic train split (its pair statistics) and a padded host
    batch of 6 images."""
    split = synthetic_splits(num_train=64, num_eval=4, num_classes=9,
                             num_predicates=6, max_objects=8,
                             image_size=64)["train"]
    batch = SyntheticSGGDataset(num_images=6, num_classes=9,
                                num_predicates=6, max_objects=8,
                                image_size=64, seed=1).batch(
        list(range(6)), max_nodes=10, max_edges=24)
    return split, batch


@pytest.mark.parametrize("seeded", [False, True], ids=["shared", "seeded"])
@pytest.mark.parametrize("method", ["rand", "neigh", "graphn"])
def test_perturbations_equal(data, method, seeded):
    split, batch = data
    emb = wv.normalized_class_embeddings([f"c{i}" for i in range(9)])
    kw = dict(L=0.5, topk=3, alpha=1, seed=5)
    ours = perturb.SceneGraphPerturb(method, emb, *_pairs(split), **kw)
    theirs = jperturb.SceneGraphPerturb(method, emb, *_pairs(split), **kw)
    np.testing.assert_array_equal(perturb.pairwise_similarity(emb),
                                  jperturb.pairwise_similarity(emb))
    args = (np.asarray(batch.classes), np.asarray(batch.rels),
            np.asarray(batch.node_mask), np.asarray(batch.rel_mask))
    seeds = list(range(100, 106)) if seeded else None
    changed = 0
    for _ in range(3):  # the shared stream moves on from call to call
        got = ours.perturb_batch(*args, seeds=seeds)
        want = theirs.perturb_batch(*args, seeds=seeds)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == args[0].dtype
        changed += int((got != args[0]).sum())
    np.testing.assert_array_equal(got[~args[2]], args[0][~args[2]])
    assert changed > 0


def test_trainer_content_seeds_equal(data):
    """The perturbation seeds of ``_gan_host_inputs`` (crc32 of each image's
    int32 classes and float32 boxes, mixed with epoch and seed) and the
    perturbed classes, against the JAX trainer's method on the same host
    batch (JAX's synthetic batch holds the same arrays)."""
    split, _ = data
    kw = dict(num_images=6, num_classes=9, num_predicates=6, max_objects=8,
              image_size=64, seed=1)
    tb = SyntheticSGGDataset(**kw).batch(list(range(6)), max_nodes=10,
                                         max_edges=24)
    jb = JSynth(**kw).batch(list(range(6)), max_nodes=10, max_edges=24)
    emb = wv.normalized_class_embeddings([f"c{i}" for i in range(9)])
    for epoch in (0, 3):
        seen = {}
        out = {}
        for name, cls, mod, b in (("port", Trainer, perturb, tb),
                                  ("jax", JTrainer, jperturb, jb)):
            real = mod.SceneGraphPerturb("graphn", emb, *_pairs(split),
                                         L=0.5, topk=3, alpha=1, seed=7)

            def record(*a, seeds=None, _real=real, _name=name):
                seen[_name] = list(seeds)
                return _real.perturb_batch(*a, seeds=seeds)

            stub = types.SimpleNamespace(
                perturber=types.SimpleNamespace(perturb_batch=record),
                feature_bank=None, config=types.SimpleNamespace(seed=111))
            res = cls._gan_host_inputs(stub, b, epoch)
            out[name] = res.fake_classes if name == "port" else res[1]
        assert seen["port"] == seen["jax"] and len(set(seen["port"])) == 6
        np.testing.assert_array_equal(out["port"], out["jax"])
