"""The ResNet50-FPN paths of the port's command lines on the CPU, tiny heads
on 64 px canvases (the ResNet50 body keeps its widths):

* ``python -m sgg_torch.main -m sgcls -backbone resnet50`` trains an epoch
  and writes ``test_results.json``; so does ``-edge_model raw_boxes`` on
  the VGG16 model;
* ``python -m sgg_torch.pretrain_detector synthetic - <dir>`` trains the
  FPN detector (its default) and writes a payload that loads strictly;
* ``python -m sgg_torch.main -m sgdet -backbone resnet50 -ckpt <dir>``
  trains the relation head on the frozen FPN detector's stride-64 map and
  evaluates (``-nepoch 0`` alone: ``tests/test_torch_sgdet.py``)."""

import functools
import json
import os

import pytest
import torch

import sgg_torch.constants
from sgg_torch import main as cli
from sgg_torch import pretrain_detector as tpre
from sgg_torch.models import detector as detector_mod
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train import trainer as trainer_mod
from test_torch_resnet_fpn import one_thread  # noqa: F401

IMG = 64
pytestmark = pytest.mark.usefixtures("one_thread")
# the post-NMS slots hold the pretraining batch's 64 GT boxes
DET_KW = dict(obj_dim=32, rpn_pre_nms_top_n=96, rpn_post_nms_top_n=80,
              detections_per_img=8)


@pytest.fixture
def tiny(monkeypatch):
    """64 px canvases, tiny relation heads of the config's backbone and
    edge model, a tiny-headed FPN detector."""
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)

    def build(config, train_data, *, device="cuda", seed=0):
        model = init_weights(RelModelIMP(
            num_classes=train_data.num_classes,
            num_predicates=train_data.num_predicates, mode=config.mode,
            hidden_dim=16, obj_dim=32, backbone=config.backbone,
            edge_model=config.edge_model), seed)
        return model.to(device).eval()

    monkeypatch.setattr(trainer_mod, "build_model", build)
    fpn = functools.partial(detector_mod.FasterRCNNFPN, **DET_KW)
    monkeypatch.setattr(detector_mod, "FasterRCNNFPN", fpn)
    return fpn


def _results(run):
    with open(os.path.join(run, "test_results.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("backbone,edge_model", [("resnet50", "motifs"),
                                                 ("vgg16", "raw_boxes")])
def test_cli_trains_sgcls(tmp_path, tiny, backbone, edge_model):
    run = str(tmp_path / "run")
    results = cli.main(["-m", "sgcls", "-loss", "dnorm", "-split",
                        "synthetic", "-device", "cpu", "-dtype", "float32",
                        "-nepoch", "1", "-b", "8", "-val_size", "4", "-p",
                        "4", "-nwork", "1", "-max_nodes", "24",
                        "-max_edges", "64", "-backbone", backbone,
                        "-edge_model", edge_model, "-save_dir", run])
    written = _results(run)
    assert "sgcls/test_alls_R@100_GC" in written
    assert "predcls/test_alls_R@100_GC" in written
    assert all(v == v and 0 <= v <= 301.001 for v in written.values())
    assert ckpt.latest_epoch(run) == 0
    payload, _ = ckpt.restore_payload(run)
    keys = set(payload["params"])
    assert ("trunk.body.layer4_2.conv3.weight" in keys) == (
        backbone == "resnet50")


def test_pretrain_cli_trains_the_fpn_detector(tmp_path, tiny):
    out = str(tmp_path / "det")
    det, state = tpre.main(["synthetic", "-", out, "1", "16", "-device",
                            "cpu"])
    assert isinstance(det.backbone, detector_mod.ResNet50FPN)
    assert det.box_head.compute_dtype == torch.bfloat16
    assert state.step == 4  # 64 synthetic images, batch 16
    payload, epoch = ckpt.load_detector(out)
    assert epoch == 0
    ckpt.load_detector_state(tiny(151), payload)  # strict


def test_cli_sgdet_trains_on_the_fpn_detector(tmp_path, tiny):
    fpn = detector_mod.init_detector_weights(tiny(151), 0)
    with torch.no_grad():  # scores above the 0.01 retry floor
        fpn.cls_score.weight.mul_(24.0)
    det_dir = str(tmp_path / "det")
    ckpt.save_detector(det_dir, fpn)
    run = str(tmp_path / "run")
    results = cli.main(["-m", "sgdet", "-backbone", "resnet50", "-ckpt",
                        det_dir, "-split", "synthetic", "-device", "cpu",
                        "-dtype", "float32", "-nepoch", "1", "-b", "8",
                        "-val_size", "4", "-p", "4", "-nwork", "1",
                        "-save_dir", run])
    written = _results(run)
    assert "sgdet/test_alls_R@100_NOGC" in written
    assert all(v == v for v in written.values())
    payload, _ = ckpt.restore_payload(run)
    assert not any(k.startswith(("trunk", "backbone"))
                   for k in payload["params"])
    assert payload["params"]["roi_fmap.fc6.weight"].shape[1] == 7 * 7 * 256
    assert results
