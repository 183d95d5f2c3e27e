"""The port's frozen-trunk feature cache (``sgg_torch.data.feature_cache``)
on a VG fixture tree at 64 px, on the CPU:

* ``extract_trunk_cache`` stores, for every image and both orientations,
  the trunk's bfloat16 output bit for bit, and ``cached_batch`` carries it;
* a train step on cached batches gives the losses of the step on images;
* a cache file written by ``sgg_tpu``'s ``FeatureCache`` reads back to the
  same bits through the port's, and the other way round;
* one changed trunk weight or BatchNorm statistic changes the fingerprint,
  and the trainer refuses the stale cache and extracts again;
* ``-feature_cache`` through the command line, in sgcls and in sgdet (the
  trunk of the frozen detector)."""

import copy
import functools
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import sgg_torch.constants
from sgg_tpu.data.feature_cache import FeatureCache as JCache
from sgg_torch import main as cli
from sgg_torch.config import config_from_args
from sgg_torch.data import fixtures
from sgg_torch.data import visual_genome as tvg
from sgg_torch.data.feature_cache import (FeatureCache, cached_batch,
                                          extract_trunk_cache,
                                          params_fingerprint)
from sgg_torch.data.pipeline import BatchLoader, prepare_example
from sgg_torch.data.pipeline import load_source_image
from sgg_torch.models import detector as detector_mod
from sgg_torch.models.backbone import VGG16Trunk
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.models.resnet import ResNet50FPN, set_compute_dtype
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train import trainer as trainer_mod
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from test_torch_resnet_fpn import one_thread  # noqa: F401
from test_torch_train_step import RTOL, rel_err

S = 64
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    fixtures.write_vg_fixture(root, n_train=8, n_test=4)
    return root


@pytest.fixture(scope="module")
def train(tree):
    return tvg.load_split(tree, "train", num_val_im=2, check_sizes=False)


def _model():
    model = init_weights(RelModelIMP(num_classes=30, num_predicates=12,
                                     hidden_dim=16, obj_dim=32), 0)
    return model.to_compute_dtype(torch.bfloat16).eval()


def _bits(x):
    return x.contiguous().view(torch.int16).numpy()


def _trunk_fn(trunk):
    return torch.inference_mode()(lambda x: trunk(torch.from_numpy(x)))


def test_extract_stores_the_trunk_output(train, tmp_path):
    trunk = init_weights(VGG16Trunk(), 1)
    set_compute_dtype(trunk, torch.bfloat16, store=True)
    cache = extract_trunk_cache(str(tmp_path / "c.h5"), train,
                                _trunk_fn(trunk), batch_size=3, im_scale=S,
                                fingerprint="fp", progress=False)
    assert cache.n_orient == 2 and cache.num_images == len(train)
    assert cache.complete() and cache.fingerprint == "fp"
    for i in range(len(train)):
        img = load_source_image(train, i, "uint8")
        assert cache.orig_hw(i) == img.shape[:2]
        for flip in (False, True):
            canvas = prepare_example(
                img, train.gt_boxes[i], np.zeros((0, 3), np.int32),
                train.box_coordinates, False, np.random.RandomState(0),
                im_scale=S, uint8=True, force_flip=flip)[0]
            with torch.inference_mode():
                want = trunk(torch.from_numpy(canvas[None]))[0]
            got = cache.read(i, flip)
            assert got.dtype == want.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(got), _bits(want))


def test_cached_batch_carries_the_trunk_maps(train):
    trunk = init_weights(VGG16Trunk(), 2)
    batch = next(iter(BatchLoader(train, batch_size=2, max_nodes=32,
                                  max_edges=64, im_scale=S,
                                  image_format="uint8"))).to("cpu")
    got = cached_batch(trunk, batch)
    assert got.images is None and batch.images is not None
    with torch.inference_mode():
        want = trunk(batch.images)
    assert torch.equal(got.fmaps, want)
    assert torch.equal(got.boxes, batch.boxes)


def test_cached_train_step_matches_the_image_step(train, tmp_path):
    model = _model()
    cache = extract_trunk_cache(str(tmp_path / "c.h5"), train,
                                _trunk_fn(model.trunk), im_scale=S,
                                progress=False)
    config = config_from_args(["-device", "cpu", "-b", "3", "-max_nodes",
                               "32", "-max_edges", "64", "-clip", "5"])
    kw = dict(batch_size=3, max_nodes=32, max_edges=64, im_scale=S, seed=3,
              image_format="uint8", num_workers=1)
    image_batches = list(BatchLoader(train, **kw))
    cached_batches = list(BatchLoader(train, feature_cache=cache, **kw))
    losses = []
    for batches in (image_batches, cached_batches):
        m = copy.deepcopy(model)
        step = make_train_step(m, config, Optimizer(config, m, 2))
        g = torch.Generator().manual_seed(0)
        losses.append([step(b, g) for b in batches])
    assert cached_batches[0].images is None
    assert image_batches[0].fmaps is None
    for want, got in zip(*losses):
        for k in want:
            assert rel_err(got[k].numpy(), want[k].numpy()) <= RTOL, k


def test_caches_cross_between_the_packages(tmp_path):
    rng = np.random.RandomState(0)
    maps = rng.randn(3, 2, 4, 5, 6).astype(np.float32)
    jpath, tpath = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    jc = JCache.create(jpath, 3, (4, 5), 6, im_scale=S, stride=16,
                       n_orient=2, fingerprint="abc")
    tc = FeatureCache.create(tpath, 3, (4, 5), 6, im_scale=S, stride=16,
                             n_orient=2, fingerprint="abc")
    for i in range(3):
        jc.write(i, maps[i], (40 + i, 50))
        tc.write(i, torch.from_numpy(maps[i]), (40 + i, 50))
    jc.close()
    tc.close()
    for path in (jpath, tpath):  # each file through the other package
        t, j = FeatureCache(path), JCache(path)
        assert (t.im_scale, t.stride, t.n_orient, t.fingerprint) == (
            j.im_scale, j.stride, j.n_orient, j.fingerprint)
        for i in range(3):
            assert t.orig_hw(i) == j.orig_hw(i)
            for flip in (False, True):
                want = j.read(i, flip).view(np.uint16)
                np.testing.assert_array_equal(
                    _bits(t.read(i, flip)).view(np.uint16), want)
                np.testing.assert_array_equal(
                    want, maps[i, int(flip)].astype(ml_dtypes.bfloat16)
                    .view(np.uint16))


def test_fingerprint_follows_weights_and_batchnorm_statistics():
    vgg = init_weights(VGG16Trunk(), 0)
    fp = params_fingerprint(vgg.state_dict())
    assert params_fingerprint(copy.deepcopy(vgg).state_dict()) == fp
    with torch.no_grad():
        vgg.conv[7].weight[3, 2, 1, 0] += 1e-3
    assert params_fingerprint(vgg.state_dict()) != fp
    fpn = ResNet50FPN()
    fp = params_fingerprint(fpn.state_dict())
    fpn.body.layer3_2.bn2.running_var[5] += 1e-3
    assert params_fingerprint(fpn.state_dict()) != fp


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", S)
    monkeypatch.setenv("SGG_CHECK_SIZES", "0")

    def build(config, train_data, *, device="cuda", seed=0):
        model = init_weights(RelModelIMP(
            num_classes=train_data.num_classes,
            num_predicates=train_data.num_predicates, mode=config.mode,
            hidden_dim=16, obj_dim=32), seed)
        return model.to_compute_dtype(torch.bfloat16).to(device).eval()

    monkeypatch.setattr(trainer_mod, "build_model", build)
    vgg = functools.partial(detector_mod.FasterRCNNVGG, obj_dim=32,
                            rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32,
                            detections_per_img=8)
    monkeypatch.setattr(detector_mod, "FasterRCNNVGG", vgg)
    return vgg


def test_trainer_refuses_a_stale_cache(tree, tmp_path, tiny, capsys):
    config = config_from_args(["-device", "cpu", "-feature_cache",
                               str(tmp_path / "fc"), "-b", "3"])
    splits = cli.load_splits(config_from_args(
        ["-split", "stanford", "-data", tree, "-val_size", "2"]))
    trainer = trainer_mod.Trainer(config, splits)
    cache = trainer._feature_cache_for("train", splits["train"])
    fp = cache.fingerprint
    assert fp == params_fingerprint(trainer.model.trunk.state_dict())
    assert trainer._feature_cache_for("train", splits["train"]) is cache
    assert trainer._feature_cache_for("test_alls", splits["test_alls"]
                                      ).n_orient == 1
    cache.close()
    trainer._feature_caches.clear()
    with torch.no_grad():
        trainer.model.trunk.conv[12].bias[0] += 1.0
    capsys.readouterr()
    fresh = trainer._feature_cache_for("train", splits["train"])
    assert "stale" in capsys.readouterr().out
    assert fresh.fingerprint != fp
    assert fresh.fingerprint == params_fingerprint(
        trainer.model.trunk.state_dict())


@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_cli_with_feature_cache(tree, tmp_path, tiny, mode):
    args = []
    if mode == "sgdet":
        det = detector_mod.init_detector_weights(tiny(30), 0)
        with torch.no_grad():  # scores above the 0.01 retry floor
            det.cls_score.weight.mul_(24.0)
        ckpt.save_detector(str(tmp_path / "det"), det)
        args = ["-ckpt", str(tmp_path / "det")]
    run, fc = str(tmp_path / "run"), str(tmp_path / "fc")
    cli.main(["-m", mode, "-split", "stanford", "-data", tree, "-device",
              "cpu", "-nepoch", "1", "-b", "3", "-val_size", "2", "-p", "1",
              "-nwork", "1", "-save_dir", run, "-feature_cache", fc, *args])
    with open(os.path.join(run, "test_results.json")) as f:
        res = json.load(f)
    assert f"{mode}/test_alls_R@100_GC" in res
    assert all(v == v for v in res.values())
    files = sorted(os.listdir(fc))
    assert "trunk_train.h5" in files and "trunk_test_alls.h5" in files
