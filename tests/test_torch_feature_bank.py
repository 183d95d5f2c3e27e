"""The GAN's feature bank in the port (``sgg_torch.augment.feature_bank``,
``sgg_torch.extract_features``) against the JAX package's on the CPU:

* the writer's hdf5 file equals ``sgg_tpu``'s dataset by dataset (names,
  shapes, maxshape, dtype, bits);
* ``FeatureBank``'s reservoirs and three successive ``sample`` calls equal
  ``sgg_tpu``'s bit for bit (classes over and under ``max_per_class``,
  classes absent from the file, padding), and a bank filled from pools held
  in memory (``_from_pools``, the draw without the file) equals both;
* ``extract_features`` at ``with_images=False``, from the trunk and from
  the frozen-trunk feature cache, against the root ``extract_features.py``
  on the same f32 weights: the same datasets and per-class counts, the
  pools within ``POOL_RTOL`` (the trunk path) or ``CACHE_RTOL`` (the cache
  path) of their largest magnitude;
* the node pools do not depend on the sampled edges;
* ``python -m sgg_torch.extract_features`` in-process writes a bank that
  ``sgg_tpu``'s ``FeatureBank`` reads into the port's reservoirs, and
  without ``h5py`` raises an ``ImportError`` naming it before any model is
  built.

Tolerances. The trunk path runs VGG16 in float32 on both sides: measured
2.6e-6 of the pools' largest magnitude, held at ``POOL_RTOL`` 1e-5 (the
1e-5 of the other f32 parity tests). The cache path stores each trunk map
in bfloat16 first; the two packages' f32 maps differ in their last bits,
and an element within that of a bfloat16 rounding boundary rounds to a
neighbour (one ulp, 2^-8 of its size): measured 2.5e-3, held at
``CACHE_RTOL`` 1e-2."""

import functools
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sgg_torch.constants
import sgg_torch.data.synthetic
from extract_features import extract_features as jextract_features
from sgg_tpu.augment.feature_bank import FeatureBank as JBank
from sgg_tpu.augment.feature_bank import FeatureBankWriter as JWriter
from sgg_tpu.config import Config as JConfig
from sgg_tpu.data import SyntheticSGGDataset as JSynth
from sgg_tpu.data.datasets import SGGDataset as JDataset
from sgg_tpu.models.relhead import RelModelIMP as JModel
from sgg_tpu.train.trainer import Trainer as JTrainer
from sgg_torch import extract_features as ef
from sgg_torch.augment.feature_bank import FeatureBank, FeatureBankWriter
from sgg_torch.config import Config
from sgg_torch.convert import variables_from_jax
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train import trainer as trainer_mod
from sgg_torch.train.trainer import Trainer
from test_torch_resnet_fpn import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

POOL_RTOL, CACHE_RTOL = 1e-5, 1e-2
NAMES = ["__background__", "man", "dog", "tree", "hat", "car"]
P, CH = 2, 3  # the bank tests' pool size and channels


def _read(path):
    with h5py.File(path, "r") as f:
        return {k: (f[k].shape, f[k].maxshape, f[k].dtype, np.asarray(f[k]))
                for k in f}


def _bank_file(path, writer_cls):
    """'man' 9 rows (over max_per_class 4), 'dog' 2, 'hat' 5 in two appends;
    'tree' and 'car' absent."""
    rng = np.random.RandomState(0)
    w = writer_cls(str(path), (P, P, CH))
    for name, n in (("man", 6), ("dog", 2), ("hat", 3), ("man", 3),
                    ("hat", 2)):
        w.append(name, rng.randn(n, P, P, CH).astype(np.float32))
    w.close()
    return str(path)


def test_writer_file_matches_jax(tmp_path):
    want = _read(_bank_file(tmp_path / "jax.hdf5", JWriter))
    got = _read(_bank_file(tmp_path / "port.hdf5", FeatureBankWriter))
    assert list(got) == list(want) == ["dog", "hat", "man"]
    for k, (shape, maxshape, dtype, data) in want.items():
        assert got[k][:3] == (shape, maxshape, dtype), k
        np.testing.assert_array_equal(got[k][3], data)


def _batches():
    """Three (classes, node_mask) batches: every class, classes absent
    from the bank ('tree', 'car'), padding."""
    rng = np.random.RandomState(1)
    out = []
    for _ in range(3):
        classes = rng.randint(0, len(NAMES), (3, 7))
        mask = rng.rand(3, 7) < 0.8
        out.append((classes, mask))
    out.append((np.full((2, 4), 3), None))  # only an absent class, no mask
    return out


def test_bank_reservoirs_and_samples_match_jax(tmp_path):
    path = _bank_file(tmp_path / "bank.hdf5", JWriter)
    kw = dict(pool_sz=P, n_ch=CH, max_per_class=4, seed=5)
    want = JBank(path, NAMES, **kw)
    got = FeatureBank(path, NAMES, **kw)
    with h5py.File(path, "r") as f:
        pools = {k: np.asarray(f[k]) for k in f}
    mem = FeatureBank._from_pools(pools, NAMES, **kw)
    for bank in (got, mem):
        assert sorted(bank.reservoir) == sorted(want.reservoir) == [1, 2, 4]
        for c, rows in want.reservoir.items():
            assert bank.reservoir[c].shape == rows.shape == (
                min(4, len(pools[NAMES[c]])), P * P * CH)
            np.testing.assert_array_equal(bank.reservoir[c], rows)
    for classes, mask in _batches():
        w = want.sample(classes, mask)
        assert w.shape == classes.shape + (P, P, CH) and w.dtype == np.float32
        for bank in (got, mem):
            s = bank.sample(classes, mask)
            assert s.dtype == w.dtype
            np.testing.assert_array_equal(s, w)
        valid = np.ones(classes.shape, bool) if mask is None else mask
        absent = ~valid | ~np.isin(classes, [1, 2, 4])
        assert not w[absent].any() and w[~absent].all()


# ---------------------------------------------------------------------------
def _splits(pkg_synth, pkg_dataset, n_train=2):
    s = pkg_synth(num_images=n_train, num_classes=9, num_predicates=5,
                  max_objects=5, image_size=300, seed=0)
    return {"train": pkg_dataset(
        name="stanford", mode="train", filenames=[], images_dir="",
        gt_boxes=s.gt_boxes, gt_classes=s.gt_classes,
        relationships=s.relationships, ind_to_classes=s.ind_to_classes,
        ind_to_predicates=s.ind_to_predicates, box_coordinates="native")}


CFG = dict(batch_size=2, max_nodes=8, max_edges=12, mode="sgcls",
           num_epochs=1, val_size=0, notest=True, compute_dtype="float32")


def _jax_banks(tmp):
    """The root ``extract_features.py`` from images and from the cache, on
    one f32 JAX trainer; and its variables."""
    jm = JModel(num_classes=9, num_predicates=5, mode="sgcls", hidden_dim=16,
                obj_dim=32, dtype=jnp.float32)
    jt = JTrainer(JConfig(**CFG), _splits(JSynth, JDataset), model=jm,
                  with_images=False)
    images = _read(jextract_features(jt, f"{tmp}/jax_img", batch_size=2,
                                     num_workers=1))
    jt.config = jt.config.replace(feature_cache=f"{tmp}/jax_fc")
    cached = _read(jextract_features(jt, f"{tmp}/jax_cached", batch_size=2,
                                     num_workers=1))
    return images, cached, variables_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.variables))


@pytest.fixture(scope="module")
def jax_banks(tmp_path_factory):
    return _jax_banks(str(tmp_path_factory.mktemp("jax")))


def _port_trainer(state, **kw):
    tm = RelModelIMP(num_classes=9, num_predicates=5, hidden_dim=16,
                     obj_dim=32)
    tm.load_state_dict(state, strict=True)
    cfg = Config(device="cpu", **{**CFG, **kw})
    return Trainer(cfg, _splits(SyntheticSGGDataset, SGGDataset), model=tm,
                   with_images=False)


@pytest.mark.parametrize("source", ["images", "feature_cache"])
def test_extract_features_matches_jax(jax_banks, tmp_path, source):
    want_images, want_cached, state = jax_banks
    kw = {} if source == "images" else dict(
        feature_cache=str(tmp_path / "fc"))
    t = _port_trainer(state, **kw)
    got = _read(ef.extract_features(t, str(tmp_path / "bank"), batch_size=2,
                                    num_workers=1))
    want = want_images if source == "images" else want_cached
    assert list(got) == list(want)
    n_objs = sum(len(c) for c in t.train_data.gt_classes)
    assert sum(v[0][0] for v in got.values()) == n_objs
    tol = POOL_RTOL if source == "images" else CACHE_RTOL
    scale = max(np.abs(v[3]).max() for v in want.values())
    for k, (shape, maxshape, dtype, data) in want.items():
        assert got[k][:3] == (shape, maxshape, dtype), k
        assert np.abs(got[k][3] - data).max() <= tol * scale, k


def test_node_pools_do_not_depend_on_edges(jax_banks, monkeypatch):
    t = _port_trainer(jax_banks[2])
    batch = next(iter(trainer_mod.BatchLoader(
        t.train_data, batch_size=2, max_nodes=8, max_edges=12,
        shuffle=False, with_images=False)))
    step = ef.make_pools_step(t.model, "cpu")
    a = step(batch)
    seen = []
    real = ef.sample_edges

    def other_edges(generator, *args, **kw):
        out = real(torch.Generator().manual_seed(123), *args, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(ef, "sample_edges", other_edges)
    b = step(batch)
    first = real(torch.Generator().manual_seed(0), *(
        torch.as_tensor(np.asarray(x)) for x in (batch.rels, batch.rel_mask,
                                                 batch.node_mask)),
        max_out=batch.max_edges)[0]
    assert not torch.equal(seen[0], first)  # other edges, the same pools
    assert a.dtype == torch.float32 and a.shape[2:] == (7, 7, 512)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
IMG = 128


@pytest.fixture
def tiny_cli(monkeypatch):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)
    monkeypatch.setattr(trainer_mod, "build_model", lambda config, td, *,
                        device="cuda", seed=0: init_weights(RelModelIMP(
                            num_classes=td.num_classes,
                            num_predicates=td.num_predicates,
                            mode=config.mode, hidden_dim=16, obj_dim=32),
                            seed).to(device).eval())
    monkeypatch.setattr(sgg_torch.data.synthetic, "synthetic_splits",
                        functools.partial(
                            sgg_torch.data.synthetic.synthetic_splits,
                            num_train=6, num_classes=9, num_predicates=5,
                            max_objects=5, image_size=IMG))


ARGV = ["-m", "sgcls", "-split", "synthetic", "-device", "cpu",
        "-max_nodes", "8", "-max_edges", "12", "-val_size", "4"]


def test_cli_writes_the_bank_that_jax_reads(tiny_cli, tmp_path):
    run = str(tmp_path / "run")
    path = ef.main(ARGV + ["-save_dir", run])
    splits = sgg_torch.data.synthetic.synthetic_splits()
    names = splits["train"].ind_to_classes
    counts = {k: v[0][0] for k, v in _read(path).items()}
    want = {}
    for c in np.concatenate(splits["train"].gt_classes):
        want[names[c]] = want.get(names[c], 0) + 1
    assert counts == want
    kw = dict(pool_sz=7, n_ch=512, seed=3)
    jbank, tbank = JBank(path, names, **kw), FeatureBank(path, names, **kw)
    assert sorted(jbank.reservoir) == sorted(tbank.reservoir)
    for c in jbank.reservoir:
        np.testing.assert_array_equal(tbank.reservoir[c], jbank.reservoir[c])
        assert np.isfinite(tbank.reservoir[c]).all()


def test_cli_without_h5py_fails_before_any_work(tiny_cli, tmp_path,
                                                monkeypatch):
    def no_trainer(*a, **kw):
        raise AssertionError("a Trainer was built")

    monkeypatch.setattr(trainer_mod, "Trainer", no_trainer)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py fails
    with pytest.raises(ImportError, match="h5py"):
        ef.main(ARGV + ["-save_dir", str(tmp_path / "run")])
    with pytest.raises(ImportError, match="h5py"):
        ef.extract_features(object(), str(tmp_path / "run"))
