"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' refusal to take the plain version for a CUDA tensor, and a tiny
eval step on the card against the CPU.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs on a machine that has only PyTorch::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sgg_torch.ops import roi_align as troi
from sgg_torch.ops import vgg_stem

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _roi_case(kind, seed=0):
    rng = np.random.RandomState(seed)
    B, H, W, C = 2, 9, 11, 200  # C: two channel tiles, the last one ragged
    fmap = rng.randn(B, H, W, C).astype(np.float32)
    R = 70 if kind == "ragged" else 9
    boxes = rng.rand(B, R, 4).astype(np.float32) * 140
    boxes[..., 2:] += boxes[..., :2] + 10
    if kind == "degenerate":
        boxes[:, :3] = 0.0
        boxes[:, 3] = [50.0, 60.0, 40.0, 20.0]
        boxes[:, 4] = [30.0, 30.0, 30.0, 30.0]
    if kind == "outside":
        boxes[:, 0] = [-40.0, -30.0, 20.0, 25.0]
        boxes[:, 1] = [150.0, 120.0, 260.0, 300.0]
        boxes[:, 2] = [-300.0, -300.0, -100.0, -90.0]
        boxes[:, 3] = [-16.0, -16.0, 0.0, 0.0]
    return fmap, boxes


@pytest.mark.parametrize("kind", ["random", "ragged", "degenerate",
                                  "outside"])
def test_roi_align_kernel_matches_plain(kind, dev):
    fmap, boxes = (torch.from_numpy(a).to(dev) for a in _roi_case(kind))
    want = troi.roi_align_reference(fmap, boxes, spatial_scale=1 / 16.0)
    before = troi.KERNEL.launches
    got = troi.roi_align(fmap, boxes, spatial_scale=1 / 16.0)
    torch.cuda.synchronize()
    assert troi.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    got16 = troi.roi_align(fmap.bfloat16(), boxes, spatial_scale=1 / 16.0)
    err = (got16.float() - want).abs().max() / want.abs().max()
    assert float(err) <= 2e-2


@pytest.mark.parametrize("hw", [(32, 24), (37, 29), (5, 70)])
def test_vgg_conv1_kernel_matches_plain(hw, dev):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, *hw, 3).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(3, 3, 3, 64) * 0.2).astype(
        np.float32)).to(dev)
    b = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)).to(dev)
    want = vgg_stem.vgg_conv1_reference(x, w, b)
    before = vgg_stem.KERNEL.launches
    got = vgg_stem.vgg_conv1(x, w, b)
    torch.cuda.synchronize()
    assert vgg_stem.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    got16 = vgg_stem.vgg_conv1(x.bfloat16(), w, b)
    err = (got16.float() - want).abs().max() / want.abs().max()
    assert float(err) <= 2e-2


def test_wrappers_never_take_plain_version(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(troi, "roi_align_reference", refuse)
    monkeypatch.setattr(vgg_stem, "vgg_conv1_reference", refuse)
    n_roi, n_stem = troi.KERNEL.launches, vgg_stem.KERNEL.launches
    troi.roi_align(torch.randn(1, 5, 5, 8, device=dev),
                   torch.tensor([[[0.0, 0.0, 40.0, 50.0]]], device=dev),
                   spatial_scale=1 / 16.0)
    vgg_stem.vgg_conv1(torch.randn(1, 9, 7, 3, device=dev),
                       torch.randn(3, 3, 3, 64, device=dev),
                       torch.randn(64, device=dev))
    torch.cuda.synchronize()
    assert troi.KERNEL.launches == n_roi + 1
    assert vgg_stem.KERNEL.launches == n_stem + 1
    with pytest.raises(ValueError):  # mixed devices are refused
        troi.roi_align(torch.randn(1, 5, 5, 8, device=dev),
                       torch.zeros(1, 1, 4), spatial_scale=1 / 16.0)
    with pytest.raises(TypeError):
        vgg_stem.vgg_conv1(torch.randn(1, 9, 7, 3, device=dev).half(),
                           torch.randn(3, 3, 3, 64, device=dev),
                           torch.randn(64, device=dev))


def test_tiny_eval_step_card_matches_cpu(dev):
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.step import make_eval_step

    cpu = init_weights(RelModelIMP(num_classes=9, num_predicates=6,
                                   hidden_dim=16, obj_dim=32), 0).eval()
    card = RelModelIMP(num_classes=9, num_predicates=6, hidden_dim=16,
                       obj_dim=32)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev).eval()
    batch = SyntheticSGGDataset(num_images=2, num_classes=9,
                                num_predicates=6, max_objects=6,
                                image_size=64, with_images=True,
                                seed=3).batch([0, 1], max_nodes=8,
                                              max_edges=12)
    k_roi, k_stem = troi.KERNEL.launches, vgg_stem.KERNEL.launches
    got = make_eval_step(card, mode="sgcls", max_pairs=32, device=dev)(batch)
    torch.cuda.synchronize()
    assert troi.KERNEL.launches == k_roi + 2
    assert vgg_stem.KERNEL.launches == k_stem + 1
    want = make_eval_step(cpu, mode="sgcls", max_pairs=32,
                          device="cpu")(batch)
    for k in ("obj_logits", "rel_dists"):
        torch.testing.assert_close(got[k].cpu(), want[k], atol=1e-4,
                                   rtol=0)
    assert torch.equal(got["obj_preds"].cpu(), want["obj_preds"])
