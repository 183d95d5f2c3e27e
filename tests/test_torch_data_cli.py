"""The port's command lines on fixture trees (``sgg_torch.data.fixtures``,
``SGG_CHECK_SIZES=0``) on the CPU, tiny heads on 64 px canvases (the
VGG16 and ResNet50 bodies keep their widths):

* ``python -m sgg_torch.main -split stanford`` (VGG16), ``-split gqa
  -exclude_left_right`` and ``-split vte`` (``-backbone resnet50``) train an
  epoch on decoded images and write ``test_results.json``;
* ``python -m sgg_torch.pretrain_detector vg <tree> <dir>`` trains the FPN
  detector on the VG tree and writes a payload that loads strictly;
* ``-split stanford`` without ``h5py`` raises ``ImportError`` naming it
  before anything is read."""

import builtins
import functools
import json
import os

import pytest

import sgg_torch.constants
from sgg_torch import main as cli
from sgg_torch import pretrain_detector as tpre
from sgg_torch.data import fixtures
from sgg_torch.models import detector as detector_mod
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train import trainer as trainer_mod
from test_torch_resnet_fpn import one_thread  # noqa: F401

IMG = 64
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    fixtures.write_vg_fixture(root, n_train=8, n_test=4)
    fixtures.write_gqa_fixture(root, n_train=8, n_val=4)
    fixtures.write_vte_fixture(root, n_train=8, n_test=4)
    return root


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)
    monkeypatch.setenv("SGG_CHECK_SIZES", "0")

    def build(config, train_data, *, device="cuda", seed=0):
        return init_weights(RelModelIMP(
            num_classes=train_data.num_classes,
            num_predicates=train_data.num_predicates, mode=config.mode,
            hidden_dim=16, obj_dim=32, backbone=config.backbone),
            seed).to(device).eval()

    monkeypatch.setattr(trainer_mod, "build_model", build)
    # the post-NMS slots hold the pretraining batch's 64 GT boxes
    fpn = functools.partial(detector_mod.FasterRCNNFPN, obj_dim=32,
                            rpn_pre_nms_top_n=96, rpn_post_nms_top_n=80,
                            detections_per_img=8)
    monkeypatch.setattr(detector_mod, "FasterRCNNFPN", fpn)
    return fpn


def _run(tree, tmp_path, *args):
    run = str(tmp_path / "run")
    cli.main(["-data", tree, "-device", "cpu", "-dtype", "float32",
              "-nepoch", "1", "-b", "4", "-val_size", "2", "-p", "1",
              "-nwork", "1", "-save_dir", run, *args])
    with open(os.path.join(run, "test_results.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("args", [
    ("-m", "sgcls", "-split", "stanford"),
    ("-m", "sgcls", "-split", "gqa", "-backbone", "resnet50",
     "-exclude_left_right"),
    ("-m", "predcls", "-split", "vte", "-backbone", "resnet50"),
], ids=["stanford", "gqa", "vte"])
def test_cli_trains_on_a_fixture_tree(tree, tmp_path, tiny, args):
    res = _run(tree, tmp_path, *args)
    mode = args[1]
    assert f"{mode}/test_alls_R@100_GC" in res
    if args[3] == "stanford":  # the 10- and 100-shot splits evaluated
        assert f"{mode}/test_10s_R@100_GC" in res
    assert all(v == v and 0 <= v <= 301.001 for v in res.values())


def test_pretrain_cli_on_the_vg_tree(tree, tmp_path, tiny):
    out = str(tmp_path / "det")
    det, state = tpre.main(["vg", tree, out, "1", "2", "2", "-device",
                            "cpu"])
    assert state.step == 3  # 8 train images, 2 kept for val, batch 2
    payload, epoch = ckpt.load_detector(out)
    assert epoch == 0
    ckpt.load_detector_state(tiny(det.num_classes), payload)  # strict


def test_missing_h5py_is_named_before_any_work(tree, monkeypatch):
    real = builtins.__import__
    parsed = []

    def no_h5py(name, *a, **kw):
        if name.split(".")[0] == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    monkeypatch.setattr(trainer_mod, "Trainer",
                        lambda *a, **kw: parsed.append(a))
    with pytest.raises(ImportError, match="h5py"):
        cli.main(["-split", "stanford", "-data", tree, "-device", "cpu"])
    assert parsed == []
