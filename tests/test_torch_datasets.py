"""The port's dataset parsers and fixture writers against the JAX
package's (``sgg_torch.data.{visual_genome,gqa,vtranse,fixtures}`` against
``sgg_tpu.data``'s):

* from one seed both writers write the same files: h5 datasets and
  attributes, JSON and JPEG bytes;
* each package parses its own tree into the same train split and six eval
  splits (zero-, 10- and 100-shot, all), field by field, with the
  non-overlap filter, ``exclude_left_right`` and min/max graph sizes.

(That the parsers import ``h5py`` only when they read a file is held by
``tests/test_torch_imports.py``.)"""

import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest

from sgg_tpu.data import fixtures as jfix
from sgg_tpu.data import gqa as jgqa
from sgg_tpu.data import visual_genome as jvg
from sgg_tpu.data import vtranse as jvte
from sgg_torch.data import fixtures as tfix
from sgg_torch.data import gqa as tgqa
from sgg_torch.data import visual_genome as tvg
from sgg_torch.data import vtranse as tvte

SIZES = {"vg": dict(n_train=14, n_test=8), "gqa": dict(n_train=12, n_val=6),
         "vte": dict(n_train=10, n_test=6)}
WRITERS = {"vg": "write_vg_fixture", "gqa": "write_gqa_fixture",
           "vte": "write_vte_fixture"}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree a package, each dataset written by that package's writer
    from its default seed."""
    out = {}
    for pkg, mod in (("jax", jfix), ("torch", tfix)):
        root = tmp_path_factory.mktemp(pkg)
        for ds, kw in SIZES.items():
            getattr(mod, WRITERS[ds])(str(root), **kw)
        out[pkg] = root
    return out


def _h5_items(path):
    import h5py
    items = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                items[name] = (obj[()], obj.dtype)
            items[name + "@attrs"] = dict(obj.attrs)
        f.visititems(visit)
    return items


def test_writers_write_the_same_files(trees):
    j, t = trees["jax"], trees["torch"]
    files = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(t) for p in t.rglob("*")
                           if p.is_file())
    kinds = {p.suffix for p in files}
    assert kinds == {".h5", ".json", ".jpg"}
    for rel in files:
        if rel.suffix == ".h5":
            a, b = _h5_items(j / rel), _h5_items(t / rel)
            assert list(a) == list(b), rel
            for k in a:
                if k.endswith("@attrs"):
                    assert a[k] == b[k], (rel, k)
                else:
                    assert a[k][1] == b[k][1], (rel, k)
                    np.testing.assert_array_equal(a[k][0], b[k][0])
        else:  # JSON and JPEG bytes
            assert (j / rel).read_bytes() == (t / rel).read_bytes(), rel


def _assert_same_dataset(a, b, root_a, root_b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "images_dir":
            assert os.path.relpath(x, root_a) == os.path.relpath(y, root_b)
        elif f.name in ("gt_boxes", "gt_classes", "relationships"):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                assert u.dtype == v.dtype, f.name
                np.testing.assert_array_equal(u, v, err_msg=f.name)
        else:
            assert x == y, f.name


CASES = {
    "vg": [{}, {"filter_non_overlap": False},
           {"min_graph_size": 2, "max_graph_size": 9,
            "filter_non_overlap": False}],
    "gqa": [{}, {"exclude_left_right": True},
            {"min_graph_size": 8, "max_graph_size": 16,
             "exclude_left_right": True}],
    "vte": [{}, {"min_graph_size": 12, "max_graph_size": 16}],
}


def _splits(mod, root, ds, kw):
    kw = dict(kw, num_val_im=2)
    if ds == "vg":
        return mod.splits(str(root), check_sizes=False, **kw)
    return mod.splits(str(root), **kw)


@pytest.mark.parametrize("ds,kw", [(ds, kw) for ds, cases in CASES.items()
                                   for kw in cases],
                         ids=lambda x: x if isinstance(x, str) else
                         "-".join(f"{k}={v}" for k, v in x.items()) or
                         "default")
def test_parsers_match_jax_field_by_field(trees, ds, kw):
    jmod, tmod = {"vg": (jvg, tvg), "gqa": (jgqa, tgqa),
                  "vte": (jvte, tvte)}[ds]
    want = _splits(jmod, trees["jax"], ds, kw)
    got = _splits(tmod, trees["torch"], ds, kw)
    assert list(got) == list(want)
    for name in want:
        _assert_same_dataset(got[name], want[name], trees["torch"],
                             trees["jax"])
    names = {"train", "val_zs", "val_alls", "test_zs", "test_alls"}
    if ds == "vg":
        names |= {"test_10s", "test_100s"}
    assert set(got) == names
    assert all(len(got[n]) for n in ("train", "val_alls", "test_zs",
                                      "test_alls"))


def test_vte_parse_cache_is_the_ports_own(trees):
    """The VTE parser caches its parse beside the h5; the port's tree held
    its own cache, written by the port's parser."""
    vte_dir = pathlib.Path(trees["torch"]) / "VG" / "vtranse"
    _splits(tvte, trees["torch"], "vte", {})
    assert sorted(p.name for p in vte_dir.glob("*.pkl")) == [
        "vg1_2_meta_test.pkl", "vg1_2_meta_train.pkl"]


def test_gqa_vocabulary_and_left_right(trees):
    files = tgqa._GQAFiles(str(trees["torch"]))
    classes, preds, _, p2i = files.vocab
    assert classes[0] == preds[0] == "__background__"
    left = p2i["to the left of"]
    sp = tgqa.splits(str(trees["torch"]), num_val_im=2,
                     exclude_left_right=True)
    for rels in sp["train"].relationships:
        assert left not in rels[:, 2]
    with open(os.path.join(trees["torch"], "GQA",
                           "train_images.json")) as f:
        assert len(json.load(f)) == SIZES["gqa"]["n_train"]
