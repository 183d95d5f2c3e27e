"""The port's examples (``sgg_torch/examples/``) on the CPU, in process:
``perturbations_demo`` prints what ``examples/perturbations_demo.py``
prints (the same split, seeds and perturbers); ``gan_feature_quality``
gives a finite FID and PRDC in [0, 1] (density may pass 1);
``zero_shot_visualization`` draws its PNGs; ``feature_cache_training``
trains from its cache with finite losses. Without their packages
(networkx/matplotlib, h5py: the card's machine) the last two raise an
``ImportError`` naming them before any work."""

import contextlib
import importlib.util
import io
import math
import os
import sys

import pytest

from sgg_torch import constants
from sgg_torch.examples import (feature_cache_training, gan_feature_quality,
                                perturbations_demo, zero_shot_visualization)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread: the suite runs several files at once, each
    on a worker, and full thread pools would oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stdout_of(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a)
    return out, buf.getvalue()


def test_perturbations_demo_prints_the_jax_triplets():
    spec = importlib.util.spec_from_file_location(
        "jax_perturbations_demo",
        os.path.join(REPO, "examples", "perturbations_demo.py"))
    jax = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax)
    _, want = stdout_of(jax.main)
    _, got = stdout_of(perturbations_demo.main, [])
    assert got == want
    assert got.count("===") == 6 and "  ->  " in got


def test_gan_feature_quality():
    res, out = stdout_of(gan_feature_quality.main, ["-device", "cpu"])
    assert math.isfinite(res["fid"]) and res["fid"] >= 0
    for k in ("precision", "recall", "coverage"):
        assert 0.0 <= res[k] <= 1.0, (k, res[k])
    assert math.isfinite(res["density"]) and res["density"] >= 0
    assert out.startswith("FID (untrained G, 16-d)")


def test_zero_shot_visualization(tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "IM_SCALE", 64)
    written, out = stdout_of(zero_shot_visualization.main, [
        str(tmp_path / "nodata"), str(tmp_path / "viz"), "--n-images", "2",
        "-device", "cpu"])
    assert len(written) == 4 and all(os.path.getsize(p) > 0
                                     for p in written)
    assert "using the synthetic dataset" in out


def test_feature_cache_training():
    losses, out = stdout_of(feature_cache_training.main, ["-device", "cpu"])
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert "extracted 8 images x 2 orientations" in out


@pytest.mark.parametrize("example,packages", [
    (zero_shot_visualization, ("networkx", "matplotlib")),
    (feature_cache_training, ("h5py",))])
def test_missing_packages_named_before_work(example, packages, monkeypatch,
                                            tmp_path):
    from sgg_torch.models.relhead import RelModelIMP
    built = []
    init = RelModelIMP.__init__
    monkeypatch.setattr(RelModelIMP, "__init__", lambda self, *a, **k: (
        built.append(a), init(self, *a, **k))[1])
    for name in packages:  # importing a None entry raises ImportError
        monkeypatch.setitem(sys.modules, name, None)
    argv = ["-device", "cpu"]
    if example is zero_shot_visualization:
        argv = [str(tmp_path / "nodata"), str(tmp_path / "o")] + argv
    with pytest.raises(ImportError) as e:
        example.main(argv)
    assert all(p in str(e.value) for p in packages), str(e.value)
    assert not built
