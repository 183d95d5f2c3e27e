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


def _roi_case(kind, C=200, seed=0):
    rng = np.random.RandomState(seed)
    B, H, W = 2, 9, 11
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
    if kind == "wholemap":  # every bin has its full 4 x 4 distinct taps
        boxes[:, 0] = [0.0, 0.0, W * 16.0, H * 16.0]
        boxes[:, 1] = [-20.0, -20.0, W * 16.0 + 30.0, H * 16.0 + 30.0]
    return fmap, boxes


def _offset_view(t, k):
    """A contiguous copy of ``t`` whose storage starts ``k`` elements past
    an aligned address."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


# C = 200: 8 channels a thread (25 groups); 6: pairs; 203: single channels.
# "unaligned" shifts the map 2 elements off its 16-byte alignment, which
# takes the pair route at C = 200 too.
@pytest.mark.parametrize("C", [200, 203, 6])
@pytest.mark.parametrize("kind", ["random", "ragged", "degenerate",
                                  "outside", "wholemap", "unaligned"])
def test_roi_align_kernel_matches_plain(kind, C, dev):
    fmap, boxes = (torch.from_numpy(a).to(dev) for a in _roi_case(kind, C))
    shift = 2 if kind == "unaligned" else 0
    want = troi.roi_align_reference(fmap, boxes, spatial_scale=1 / 16.0)
    before = troi.KERNEL.launches
    got = troi.roi_align(_offset_view(fmap, shift), boxes,
                         spatial_scale=1 / 16.0)
    torch.cuda.synchronize()
    assert troi.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    got16 = troi.roi_align(_offset_view(fmap.bfloat16(), shift), boxes,
                           spatial_scale=1 / 16.0)
    err = (got16.float() - want).abs().max() / want.abs().max()
    assert float(err) <= 2e-2


# The plain version is the yardstick of the kernel on the card, and on the
# CPU it is what the CPU tests hold against the JAX package: the two must
# agree, or the kernel is judged by a reference of its own.
@pytest.mark.parametrize("kind", ["random", "degenerate", "outside",
                                  "wholemap"])
def test_roi_align_plain_on_card_matches_cpu(kind, dev):
    fmap, boxes = (torch.from_numpy(a) for a in _roi_case(kind, 200))
    _, y1, _, roi_h = troi._box_frames(boxes, 1 / 16.0)
    torch.testing.assert_close(
        troi._interp_weights(y1.to(dev), roi_h.to(dev), 9, 7, 2).cpu(),
        troi._interp_weights(y1, roi_h, 9, 7, 2), atol=1e-6, rtol=0)
    want = troi.roi_align_reference(fmap, boxes, spatial_scale=1 / 16.0)
    got = troi.roi_align_reference(fmap.to(dev), boxes.to(dev),
                                   spatial_scale=1 / 16.0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)


# ratio 2 walks a bin's taps by their count (at most 4 an axis); ratio 1
# shares that route, ratio 3 takes the kernel's plain double loop
@pytest.mark.parametrize("pooled,ratio", [(7, 1), (7, 3), (5, 3), (3, 4)])
def test_roi_align_kernel_other_ratios(pooled, ratio, dev):
    fmap, boxes = (torch.from_numpy(a).to(dev)
                   for a in _roi_case("outside", 200))
    kw = dict(spatial_scale=1 / 16.0, pooled=pooled, ratio=ratio)
    want = troi.roi_align_reference(fmap, boxes, **kw)
    got = troi.roi_align(fmap, boxes, **kw)
    torch.cuda.synchronize()
    assert got.shape == (2, 9, pooled, pooled, 200)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    got16 = troi.roi_align(fmap.bfloat16(), boxes, **kw)
    err = (got16.float() - want).abs().max() / want.abs().max()
    assert float(err) <= 2e-2


def _conv_case(hw, dev):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, *hw, 3).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(3, 3, 3, 64) * 0.2).astype(
        np.float32)).to(dev)
    b = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)).to(dev)
    return x, w, b


# (200, 330): more tiles than the bf16 route's persistent grid has blocks
HWS = [(32, 24), (37, 29), (5, 70), (200, 330)]


@pytest.mark.parametrize("hw", HWS)
def test_vgg_conv1_kernel_matches_plain(hw, dev):
    x, w, b = _conv_case(hw, dev)
    want = vgg_stem.vgg_conv1_reference(x, w, b)
    before = vgg_stem.KERNEL.launches
    got = vgg_stem.vgg_conv1(x, w, b)
    torch.cuda.synchronize()
    assert vgg_stem.KERNEL.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    got16 = vgg_stem.vgg_conv1(x.bfloat16(), w, b)
    err = (got16.float() - want).abs().max() / want.abs().max()
    assert float(err) <= 2e-2


@pytest.mark.parametrize("hw", HWS)
def test_vgg_conv1_bf16_rounds_weights_and_sums_in_f32(hw, dev):
    """The bf16 route's rounding contract: x and w rounded to bf16, exact
    products summed in f32, f32 bias, one rounding of the result. Held
    against the plain version in f32 on the rounded inputs, within one
    bf16 ulp of the largest magnitude."""
    x, w, b = _conv_case(hw, dev)
    x16 = x.bfloat16()
    want = vgg_stem.vgg_conv1_reference(x16.float(), w.bfloat16().float(), b)
    got = vgg_stem.vgg_conv1(x16, w, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got.float() - want).abs().max()) <= ulp


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


def test_wrappers_refuse_inputs_that_need_a_gradient(dev):
    fmap = torch.randn(1, 5, 5, 8, device=dev, requires_grad=True)
    boxes = torch.tensor([[[0.0, 0.0, 40.0, 50.0]]], device=dev)
    with pytest.raises(RuntimeError, match="GAN slice, ROADMAP Queue B"):
        troi.roi_align(fmap, boxes, spatial_scale=1 / 16.0)
    x = torch.randn(1, 9, 7, 3, device=dev)
    w = torch.randn(3, 3, 3, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        vgg_stem.vgg_conv1(x, w, torch.randn(64, device=dev))
    with torch.no_grad():  # nothing to refuse without grad mode
        troi.roi_align(fmap, boxes, spatial_scale=1 / 16.0)
        vgg_stem.vgg_conv1(x, w, torch.randn(64, device=dev))


def _tiny_train(device, dtype=torch.float32, seed=0):
    from sgg_torch.config import Config
    from sgg_torch.models.backbone import Dropout
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.state import Optimizer
    from sgg_torch.train.step import make_train_step

    model = init_weights(RelModelIMP(num_classes=9, num_predicates=6,
                                     hidden_dim=16, obj_dim=32), seed)
    model = model.to_compute_dtype(dtype).to(device)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    cfg = Config(device=str(device), mode="sgcls", loss="dnorm",
                 batch_size=2, max_nodes=8, max_edges=12,
                 compute_dtype="bfloat16" if dtype == torch.bfloat16
                 else "float32")
    opt = Optimizer(cfg, model)
    return model, make_train_step(model, cfg, opt)


def _train_batch():
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    return SyntheticSGGDataset(num_images=2, num_classes=9, num_predicates=6,
                               max_objects=6, image_size=64,
                               with_images=True, seed=3).batch(
        [0, 1], max_nodes=8, max_edges=12)


def test_tiny_train_step_card_matches_cpu(dev):
    """One f32 train step (dropout off) on the card and on the CPU, from
    the same weights on the same sampled edges."""
    from sgg_torch.train.assign import sample_edges

    cpu, cpu_step = _tiny_train("cpu")
    card, card_step = _tiny_train(dev)
    card.load_state_dict(cpu.state_dict())
    batch = _train_batch()
    edges = sample_edges(torch.Generator().manual_seed(0),
                         *(torch.from_numpy(a) for a in (
                             batch.rels, batch.rel_mask, batch.node_mask)),
                         max_out=12)
    got = card_step(batch, None, edges=edges)
    want = cpu_step(batch, None, edges=edges)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], atol=0,
                                   rtol=1e-4)
    theirs = cpu.state_dict()
    for k, v in card.state_dict().items():
        torch.testing.assert_close(v.cpu(), theirs[k], atol=1e-6, rtol=1e-5)


def test_bf16_train_step_launches_the_bf16_routes(dev):
    model, step = _tiny_train(dev, torch.bfloat16)
    troi.KERNEL.reset_counts()
    vgg_stem.KERNEL.reset_counts()
    metrics = step(_train_batch(), torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).item() for v in metrics.values())
    assert dict(troi.KERNEL.routes) == {"bf16": 2}
    assert dict(vgg_stem.KERNEL.routes) == {"bf16": 1}


def test_train_step_does_not_wait_for_the_card(dev):
    """No host sync inside a train step: losses stay on the device."""
    model, step = _tiny_train(dev, torch.bfloat16)
    batch = _train_batch().to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    step(batch, gen)  # first call: cuBLAS/cuDNN set-up may synchronize
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(v).item() for v in metrics.values())
