"""The port's CUDA kernels on the card: each forward and backward kernel
against its plain version, the wrappers' refusal to take a plain version
for a CUDA tensor (autograd included), and tiny eval, train and detector
pretraining steps on the card against the CPU.

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
    R = 70 if kind in ("ragged", "crowded") else 9
    boxes = rng.rand(B, R, 4).astype(np.float32) * 140
    boxes[..., 2:] += boxes[..., :2] + 10
    if kind == "crowded":  # jittered around one point: one tile's list
        centre = 88.0 + rng.uniform(-4, 4, (B, R, 2))
        half = rng.uniform(2, 6, (B, R, 2))
        boxes = np.concatenate([centre - half, centre + half],
                               -1).astype(np.float32)
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
    if kind == "on_grid":  # even samples on integer map coordinates, where
        # the high tap weighs 0 and the box gradient still needs it
        boxes[:, 0] = [12.0, 12.0, 124.0, 124.0]
        boxes[:, 1] = [28.0, 12.0, 140.0, 124.0]
        boxes[:, 2] = [12.0, 28.0, 124.0, 140.0]
        boxes[:, 3] = [44.0, 44.0, 156.0, 156.0]
        boxes[:, 4, 0::2] = [12.0, 124.0]
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
    """Only the stem's images are refused a gradient (no kernel computes
    it); the map, the boxes, the weights and the bias take theirs from the
    backward kernels."""
    fmap = torch.randn(1, 5, 5, 8, device=dev, requires_grad=True)
    boxes = torch.tensor([[[0.0, 0.0, 40.0, 50.0]]], device=dev,
                         requires_grad=True)
    troi.roi_align(fmap, boxes, spatial_scale=1 / 16.0).sum().backward()
    assert fmap.grad is not None and boxes.grad is not None
    x = torch.randn(1, 9, 7, 3, device=dev, requires_grad=True)
    w = torch.randn(3, 3, 3, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no CUDA kernel computes"):
        vgg_stem.vgg_conv1(x, w, torch.randn(64, device=dev))
    vgg_stem.vgg_conv1(x.detach(), w, torch.randn(64, device=dev)).sum() \
        .backward()
    assert w.grad is not None
    with torch.no_grad():  # nothing to refuse without grad mode
        vgg_stem.vgg_conv1(x, w, torch.randn(64, device=dev))


def _bwd_case(kind, C, seed=0):
    fmap, boxes = _roi_case(kind, C, seed)
    g = np.random.RandomState(seed + 1).randn(
        *boxes.shape[:2], 7, 7, C).astype(np.float32)
    return fmap, boxes, g


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


# C = 200: 4 channels a thread (fmap) / a 16-byte chunk (boxes); 203:
# single channels; 256: FPN's width
BWD_KINDS = ["random", "ragged", "degenerate", "outside", "wholemap",
             "on_grid", "crowded"]


@pytest.mark.parametrize("C", [200, 203, 256])
@pytest.mark.parametrize("kind", BWD_KINDS)
def test_roi_align_backward_kernels_match_plain(kind, C, dev):
    """K1-bwd-fmap and K1-bwd-boxes against their plain versions on the
    same inputs, both summing in f32 in their own orders: within 1e-5 of
    the largest value for the f32 map gradient and 1e-2 for the bf16 one
    (rounded to bf16 once, after the sums); the box gradient within 1e-4
    (its samples' differences of taps cancel); and both kernels give the
    same bits from a second launch."""
    fmap, boxes, g = (torch.from_numpy(a).to(dev)
                      for a in _bwd_case(kind, C))
    hw = fmap.shape[1:3]
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        f, gg = fmap.to(dtype), g.to(dtype)
        want_f = troi.roi_align_backward_reference(
            gg, boxes, hw, dtype, spatial_scale=1 / 16.0)
        want_b = troi.roi_align_boxes_grad_reference(
            gg, f, boxes, spatial_scale=1 / 16.0)
        got_f = troi._grad_fmap_kernel(gg, boxes, tuple(f.shape), dtype,
                                       1 / 16.0, 7, 2)
        again_f = troi._grad_fmap_kernel(gg, boxes, tuple(f.shape), dtype,
                                         1 / 16.0, 7, 2)
        got_b = troi._grad_boxes_kernel(gg, f, boxes, 1 / 16.0, 7, 2)
        again_b = troi._grad_boxes_kernel(gg, f, boxes, 1 / 16.0, 7, 2)
        torch.cuda.synchronize()
        assert got_f.dtype == dtype and got_b.dtype == torch.float32
        assert torch.equal(got_f, again_f), (dtype, "fmap repeat")
        assert torch.equal(got_b, again_b), (dtype, "boxes repeat")
        assert _rel(got_f, want_f) <= tol, (dtype, "fmap")
        assert _rel(got_b, want_b) <= 1e-4, (dtype, "boxes")


@pytest.mark.parametrize("kind", BWD_KINDS)
def test_roi_align_backward_fmap_tile_lists_match_model(kind, dev):
    """The kernel's tile lists are the CPU model's (``roi_tile_lists``,
    held against brute force in ``test_torch_roi_tiles.py``), on a
    workspace filled with garbage first: nothing in it needs clearing."""
    _, boxes, g = (torch.from_numpy(a).to(dev) for a in _bwd_case(kind, 8))
    B, R = boxes.shape[:2]
    layout = troi.fmap_workspace_layout(B, 9, 11, R)
    assert (layout["tile_h"], layout["tile_w"]) == troi.FMAP_TILE
    ws = torch.full((-(-layout["bytes"] // 4),), -7, dtype=torch.int32,
                    device=dev)
    troi._grad_fmap_kernel(g, boxes, (B, 9, 11, 8), torch.float32,
                           1 / 16.0, 7, 2, workspace=ws)
    torch.cuda.synchronize()
    assert troi.fmap_tile_lists(ws, layout, B, R) == troi.roi_tile_lists(
        boxes, (9, 11), spatial_scale=1 / 16.0)


def test_roi_align_backward_fmap_large_map(dev):
    """K1-bwd-fmap over a 2 x 75 x 83 x 256 map at spatial scale 1/4 (19 x
    21 tiles an image, the last row and column of them ragged), large and
    small ROIs: the lists are the model's, both types within their limits
    of the plain version, the same bits from two launches."""
    rng = np.random.RandomState(5)
    B, H, W, C, R = 2, 75, 83, 256, 40
    xy = rng.uniform(-40, 280, (B, R, 2))
    wh = rng.uniform(4, 360, (B, R, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(B, R, 7, 7, C).astype(np.float32)).to(dev)
    layout = troi.fmap_workspace_layout(B, H, W, R)
    assert (layout["nty"], layout["ntx"]) == (19, 21)
    ws = torch.empty(-(-layout["bytes"] // 4), dtype=torch.int32, device=dev)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        gg = g.to(dtype)
        want = troi.roi_align_backward_reference(gg, boxes, (H, W), dtype,
                                                 spatial_scale=0.25)
        got = troi._grad_fmap_kernel(gg, boxes, (B, H, W, C), dtype, 0.25,
                                     7, 2, workspace=ws)
        again = troi._grad_fmap_kernel(gg, boxes, (B, H, W, C), dtype, 0.25,
                                       7, 2)
        torch.cuda.synchronize()
        assert torch.equal(got, again), dtype
        assert _rel(got, want) <= tol, dtype
        assert troi.fmap_tile_lists(ws, layout, B, R) == troi.roi_tile_lists(
            boxes, (H, W), spatial_scale=0.25)


@pytest.mark.parametrize("hw", [(37, 29), (64, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_conv1_backward_kernel_matches_plain(hw, dtype, dev):
    """K2-bwd against the autograd of the plain version, both summing the
    same inputs in f32 (1e-5 of the largest value: the orders differ)."""
    g_ = torch.Generator().manual_seed(hw[0])
    x = torch.randn(2, *hw, 3, generator=g_).to(dev, dtype)
    w = (torch.randn(3, 3, 3, 64, generator=g_) * 0.3).to(dev)
    b = (torch.randn(64, generator=g_) * 0.1).to(dev)
    out = vgg_stem.vgg_conv1(x, w, b)
    g = torch.randn(out.shape, generator=g_).to(dev, dtype)
    want_w, want_b = vgg_stem.vgg_conv1_backward_reference(x, out, g)
    got_w, got_b = vgg_stem._backward_kernel(x, out, g)
    torch.cuda.synchronize()
    assert _rel(got_w, want_w) <= 1e-5 and _rel(got_b, want_b) <= 1e-5


# not multiples of the bf16-mma route's 128-pixel tiles; W = 300 spans more
# than two tiles in a row of H = 5
@pytest.mark.parametrize("bhw", [(1, 37, 29), (2, 64, 70), (1, 5, 300)])
def test_vgg_conv1_backward_bf16_mma_ragged_and_repeatable(bhw, dev):
    """K2-bwd's bf16-mma route against the plain version (1e-5 of the
    largest value), on its route, and the same bits from two launches."""
    g_ = torch.Generator().manual_seed(sum(bhw))
    x = torch.randn(*bhw, 3, generator=g_).to(dev, torch.bfloat16)
    w = (torch.randn(3, 3, 3, 64, generator=g_) * 0.3).to(dev)
    b = (torch.randn(64, generator=g_) * 0.1).to(dev)
    out = vgg_stem.vgg_conv1(x, w, b)
    g = torch.randn(out.shape, generator=g_).to(dev, torch.bfloat16)
    want_w, want_b = vgg_stem.vgg_conv1_backward_reference(x, out, g)
    vgg_stem.KERNEL_BWD.reset_counts()
    got = vgg_stem._backward_kernel(x, out, g)
    again = vgg_stem._backward_kernel(x, out, g)
    torch.cuda.synchronize()
    assert dict(vgg_stem.KERNEL_BWD.routes) == {"bf16-mma": 2}
    assert _rel(got[0], want_w) <= 1e-5 and _rel(got[1], want_b) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_autograd_on_the_card_launches_kernels_never_plain(dev,
                                                          monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for mod, name in ((troi, "roi_align_reference"),
                      (troi, "roi_align_backward_reference"),
                      (troi, "roi_align_boxes_grad_reference"),
                      (vgg_stem, "vgg_conv1_reference"),
                      (vgg_stem, "vgg_conv1_backward_reference")):
        monkeypatch.setattr(mod, name, refuse)
    ks = (troi.KERNEL, troi.KERNEL_BWD_FMAP, troi.KERNEL_BWD_BOXES,
          vgg_stem.KERNEL, vgg_stem.KERNEL_BWD)
    for k in ks:
        k.reset_counts()
    w = torch.randn(3, 3, 3, 64, device=dev, requires_grad=True)
    b = torch.zeros(64, device=dev, requires_grad=True)
    fmap = vgg_stem.vgg_conv1(torch.randn(2, 32, 32, 3, device=dev), w, b)
    boxes = torch.tensor([[[0.0, 0.0, 20.0, 25.0]], [[3.0, 4.0, 30.0, 9.0]]],
                         device=dev, requires_grad=True)
    troi.roi_align(fmap, boxes, spatial_scale=1.0).square().sum().backward()
    torch.cuda.synchronize()
    assert [k.launches for k in ks] == [1, 1, 1, 1, 1]
    assert all(torch.isfinite(t.grad).all() for t in (w, b, boxes))
    # the boxes alone: only K1-bwd-boxes runs backward
    for k in ks:
        k.reset_counts()
    troi.roi_align(fmap.detach(), boxes, spatial_scale=1.0).sum().backward()
    torch.cuda.synchronize()
    assert [k.launches for k in ks] == [1, 0, 1, 0, 0]


def _tiny_detector(device):
    from sgg_torch.models.detector import (FasterRCNNVGG,
                                           init_detector_weights)
    det = init_detector_weights(FasterRCNNVGG(
        9, obj_dim=48, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=24,
        detections_per_img=8), 0)
    return det.to(device)


# the card-vs-CPU step's gradients, relative in norm by part: above the
# sound step's reading and below the one with RoIAlign's boxes detached
# (on the H100: sound 2.0e-3 in the trunk, where a max-pool window or ReLU
# that the devices round to the other side weighs more than at full width;
# 6.7e-6 in the RPN; the fault 0.72 in the RPN); ``chip_smoke.py`` phase 8
# holds the full-width step at 2e-3
GRAD_LIMIT = 2e-2


def test_tiny_detector_train_step_card_matches_cpu(dev, monkeypatch):
    """One f32 detector step on the card and on the CPU from the same
    weights, on the card's proposal slots and the same sampler draws:
    losses within 1e-5 relative; each part's gradient (``p.grad``, no
    weight decay) within ``GRAD_LIMIT`` in norm, a limit that the same
    step with RoIAlign's boxes detached on the card exceeds in the RPN;
    the updated parameters apart by no more than the rate times their
    gradients' difference, up to one rounding of each update's terms."""
    import sgg_torch.models.detector as D
    from sgg_torch.models.detector import balanced_draws
    from sgg_torch.pretrain_detector import DetectorOptimizer, detector_losses
    lr, batch = 0.005, _sgdet_batch()
    p0 = {n: p.detach().clone()
          for n, p in _tiny_detector("cpu").named_parameters()}
    with torch.no_grad():
        out = _tiny_detector(dev)(
            torch.from_numpy(batch.images).to(dev),
            torch.from_numpy(batch.im_hw).to(dev),
            gt_boxes=torch.from_numpy(batch.boxes).to(dev),
            gt_mask=torch.from_numpy(batch.node_mask).to(dev))
    index = (out["proposal_index"], out["rpn_prop_mask"])
    gen = torch.Generator().manual_seed(0)
    draws = {"rpn": balanced_draws(gen, out["rpn_obj_logits"].shape, "cpu"),
             "roi": balanced_draws(gen, out["prop_mask"].shape, "cpu")}

    def step(d):
        det = _tiny_detector(d)
        opt = DetectorOptimizer(det, lambda count: lr)
        losses, _ = detector_losses(
            det, batch.to(d),
            draws={k: tuple(u.to(d) for u in v) for k, v in draws.items()},
            proposal_index=tuple(t.to(d) for t in index))
        sum(losses.values()).backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in det.named_parameters()}
        opt.step()
        return ({k: v.detach().cpu() for k, v in losses.items()}, grads,
                {n: p.detach().cpu() for n, p in det.named_parameters()})

    def part_err(got, want):
        out = {}
        for part in ("trunk", "rpn", "box_head", ("cls_score", "bbox_pred")):
            names = [n for n in want if n.startswith(part)]
            out[str(part)] = (sum(float((got[n] - want[n]).square().sum())
                                  for n in names)
                              / sum(float(want[n].square().sum())
                                    for n in names)) ** 0.5
        return out

    card, cpu = step(dev), step("cpu")
    for k, want in cpu[0].items():
        torch.testing.assert_close(card[0][k], want, atol=0, rtol=1e-5)
    errs = part_err(card[1], cpu[1])
    assert all(v <= GRAD_LIMIT for v in errs.values()), errs
    for n, want in cpu[2].items():
        d = cpu[1][n] + 5e-4 * p0[n]
        slack = 2.0 ** -22 * (p0[n].abs() + lr * d.abs()) + 1e-30
        excess = (card[2][n] - want).abs() - lr * (card[1][n] - cpu[1][n]
                                                   ).abs()
        assert bool((excess <= slack).all()), n
    roi_align = D.roi_align
    monkeypatch.setattr(D, "roi_align", lambda f, boxes, **kw: roi_align(
        f, boxes.detach(), **kw))
    fault = part_err(step(dev)[1], cpu[1])
    assert fault["rpn"] > GRAD_LIMIT, (fault, errs)
    print("tiny detector step card vs CPU: gradients", errs, "fault", fault)


def test_detector_train_step_does_not_wait_for_the_card(dev):
    from sgg_torch.pretrain_detector import (DetectorOptimizer,
                                             make_detector_train_step)
    det = _tiny_detector(dev).to_compute_dtype(torch.bfloat16)
    step = make_detector_train_step(det, DetectorOptimizer(
        det, lambda count: 0.005))
    batch = _sgdet_batch().to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    step(batch, gen)
    torch.cuda.synchronize()
    ks = (troi.KERNEL, troi.KERNEL_BWD_FMAP, troi.KERNEL_BWD_BOXES,
          vgg_stem.KERNEL, vgg_stem.KERNEL_BWD)
    for k in ks:
        k.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(v).item() for v in metrics.values())
    # K1-bwd-fmap's gather, K2-bwd on the tensor cores
    assert [dict(k.routes) for k in ks] == [
        {"bf16": 1}, {"bf16-gather": 1}, {"bf16": 1}, {"bf16": 1},
        {"bf16-mma": 1}]


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


def _tiny_sgdet(device, dtype=torch.float32):
    from sgg_torch.models.detector import (FasterRCNNVGG,
                                           init_detector_weights)
    from sgg_torch.models.relhead import RelModelIMP, init_weights

    det = init_detector_weights(FasterRCNNVGG(
        9, obj_dim=48, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=24,
        detections_per_img=8, score_thresh=0.01), 0)
    rel = init_weights(RelModelIMP(num_classes=9, num_predicates=6,
                                   mode="sgdet", hidden_dim=16, obj_dim=32), 1)
    det = det.requires_grad_(False).to_compute_dtype(dtype).to(device)
    return det.eval(), rel.to_compute_dtype(dtype).to(device).eval()


def _sgdet_batch():
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    return SyntheticSGGDataset(num_images=2, num_classes=9, num_predicates=6,
                               max_objects=6, image_size=96,
                               with_images=True, seed=3).batch(
        [0, 1], max_nodes=8, max_edges=12)


def test_tiny_sgdet_eval_step_card_matches_cpu(dev):
    """The retry eval step in f32 on the card and on the CPU, same weights:
    K1 runs three times (proposals, nodes, unions) and K2 once."""
    from sgg_torch.models.sgdet import make_sgdet_retry_eval_step

    cpu_det, cpu_rel = _tiny_sgdet("cpu")
    det, rel = _tiny_sgdet(dev)
    batch = _sgdet_batch()
    k_roi, k_stem = troi.KERNEL.launches, vgg_stem.KERNEL.launches
    got = make_sgdet_retry_eval_step(det, rel, max_pairs=32,
                                     device=dev)(batch)
    torch.cuda.synchronize()
    assert troi.KERNEL.launches == k_roi + 3
    assert vgg_stem.KERNEL.launches == k_stem + 1
    want = make_sgdet_retry_eval_step(cpu_det, cpu_rel, max_pairs=32,
                                      device="cpu")(batch)
    for k, w in want.items():
        g = got[k].cpu()
        if w.is_floating_point():
            tol = 1e-2 if "boxes" in k else 1e-4
            torch.testing.assert_close(g, w, atol=tol, rtol=0, msg=k)
        else:
            assert torch.equal(g, w), k


def test_sgdet_steps_do_not_wait_for_the_card(dev):
    """bf16: the detect and relate stages of the retry eval step and an
    SGDet train step run under ``set_sync_debug_mode("error")``, on the
    kernels' bf16 routes (3 K1 + 1 K2 a step)."""
    from sgg_torch.config import Config
    from sgg_torch.models.sgdet import (make_sgdet_retry_eval_step,
                                        make_sgdet_train_step)
    from sgg_torch.train.state import Optimizer

    det, rel = _tiny_sgdet(dev, torch.bfloat16)
    batch = _sgdet_batch().to(dev)
    step = make_sgdet_retry_eval_step(det, rel, max_pairs=32, device=dev)
    cfg = Config(device=str(dev), mode="sgdet", loss="dnorm", batch_size=2,
                 max_nodes=8, max_edges=12, compute_dtype="bfloat16")
    train = make_sgdet_train_step(det, rel, cfg, Optimizer(cfg, rel))
    gen = torch.Generator(device=dev).manual_seed(0)
    d = step.detect(batch)  # first calls: cuBLAS/cuDNN set-up, anchors
    rung = step.rung_for(step.flags(d)["pair_count"])
    step.relate(d, rung)
    train(batch, gen)
    torch.cuda.synchronize()
    troi.KERNEL.reset_counts()
    vgg_stem.KERNEL.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step.relate(step.detect(batch), rung)
        metrics = train(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out["rel_dists"]).all())
    assert all(torch.isfinite(v).item() for v in metrics.values())
    assert dict(troi.KERNEL.routes) == {"bf16": 6}
    assert dict(vgg_stem.KERNEL.routes) == {"bf16": 2}


def test_device_prefetch_on_the_card_keeps_order_and_content(dev):
    """``device_prefetch`` issues its copies on a stream of its own; each
    batch reaches the step's stream whole and in order while that stream
    is kept busy."""
    from sgg_torch.data.graph_batch import GraphBatch
    from sgg_torch.data.pipeline import device_prefetch
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    ds = SyntheticSGGDataset(num_images=8, num_classes=9, num_predicates=6,
                             max_objects=6, image_size=64, with_images=True,
                             seed=3)
    host = [ds.batch([2 * i, 2 * i + 1], max_nodes=8, max_edges=12)
            for i in range(4)]
    x = torch.randn(2048, 2048, device=dev)
    n = 0
    for got, want in zip(device_prefetch(iter(host), dev), host):
        x = torch.tanh(x @ x)  # the step's stream stays busy
        want = want.to("cpu")
        for f in GraphBatch.__dataclass_fields__:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.device.type == "cuda", f
                assert torch.equal(a.clone().cpu(), b), f
        n += 1
    assert n == len(host)
    assert torch.isfinite(x).all()


# -- the ResNet50-FPN shapes -------------------------------------------------

# (side, stride) of P2-P5 and pool at 592 px
FPN_LEVELS = [(148, 4), (74, 8), (37, 16), (19, 32), (10, 64)]


def _fpn_boxes(rng, B, R):
    """Proposal-like boxes from 4 to 600 px (every FPN level's range),
    partly outside the 592 px canvas."""
    xy = rng.uniform(-20, 560, (B, R, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(600), (B, R, 2)))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("side,stride", FPN_LEVELS)
def test_roi_align_kernels_at_fpn_level_shapes(side, stride, dev):
    """K1, K1-bwd-fmap and K1-bwd-boxes on a 2 x side x side x 256 map at
    scale 1/stride, as ``multiscale_roi_align`` calls them: 512 ROIs, the
    gradient's rows zero outside the level's own quarter (pool, 1/64: the
    relation head's map, every row). Forward f32 within 1e-5, bf16 within
    2e-2 of the largest; backward as ``test_roi_align_backward_kernels_
    match_plain``; the same bits from two launches."""
    from sgg_torch.models.resnet import roi_level_assignment
    rng = np.random.RandomState(side)
    B, R, C = 2, 512, 256
    fmap = torch.from_numpy(rng.randn(B, side, side, C).astype(
        np.float32)).to(dev)
    boxes = torch.from_numpy(_fpn_boxes(rng, B, R)).to(dev)
    g = torch.from_numpy(rng.randn(B, R, 7, 7, C).astype(np.float32)).to(dev)
    if stride < 64:
        sel = roi_level_assignment(boxes) == FPN_LEVELS.index((side, stride))
        g = g * sel[..., None, None, None]
    scale = 1.0 / stride
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        f, gg = fmap.to(dtype), g.to(dtype)
        want = troi.roi_align_reference(fmap, boxes, spatial_scale=scale)
        got = troi.roi_align(f, boxes, spatial_scale=scale)
        want_f = troi.roi_align_backward_reference(
            gg, boxes, (side, side), dtype, spatial_scale=scale)
        want_b = troi.roi_align_boxes_grad_reference(gg, f, boxes,
                                                     spatial_scale=scale)
        got_f = [troi._grad_fmap_kernel(gg, boxes, tuple(f.shape), dtype,
                                        scale, 7, 2) for _ in range(2)]
        got_b = [troi._grad_boxes_kernel(gg, f, boxes, scale, 7, 2)
                 for _ in range(2)]
        torch.cuda.synchronize()
        assert _rel(got, want) <= (1e-5 if dtype == torch.float32
                                   else 2e-2), dtype
        assert torch.equal(*got_f) and torch.equal(*got_b), dtype
        assert _rel(got_f[0], want_f) <= tol, (dtype, "fmap")
        assert _rel(got_b[0], want_b) <= 1e-4, (dtype, "boxes")


def test_resnet50_fpn_card_matches_cpu(dev):
    """``ResNet50FPN`` (f32, TF32 off) on the card against the CPU, every
    level within 1e-4 of its largest value, on a 144 px canvas whose top
    levels upsample inexactly; the ``pool`` level alone equal to the full
    pyramid's; bf16 finite."""
    from sgg_torch.models.relhead import init_weights
    from sgg_torch.models.resnet import ResNet50FPN
    net = init_weights(ResNet50FPN(), 0).eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 144, 144, 3).astype(np.float32))
    with torch.no_grad():
        want = net(x)
        net.to(dev)
        got = net(x.to(dev))
        pool = net.pool(x.to(dev))
        for m in net.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.bfloat16
        half = net(x.to(dev))
    for k, w in want.items():
        assert _rel(got[k].cpu(), w) <= 1e-4, k
        assert half[k].dtype == torch.bfloat16
        assert bool(torch.isfinite(half[k]).all()), k
    assert torch.equal(pool, got["pool"])


def _tiny_fpn(device):
    from sgg_torch.models.detector import (FasterRCNNFPN,
                                           init_detector_weights)
    return init_detector_weights(FasterRCNNFPN(
        9, obj_dim=48, rpn_pre_nms_top_n=64, rpn_post_nms_top_n=24,
        detections_per_img=8), 0).to(device)


def test_fpn_detector_train_step_card_matches_cpu_and_does_not_wait(dev):
    """One f32 FPN detector step on the card and on the CPU from the same
    weights, on the card's proposal slots and the same draws: losses within
    1e-5 relative, BatchNorm statistics untouched; then bf16 steps under
    ``set_sync_debug_mode("error")``, each launching K1 and both of its
    backward kernels four times (P2-P5) on their bf16 routes."""
    from sgg_torch.models.detector import balanced_draws
    from sgg_torch.pretrain_detector import (DetectorOptimizer,
                                             detector_losses,
                                             make_detector_train_step)
    batch = _sgdet_batch()
    with torch.no_grad():
        out = _tiny_fpn(dev)(
            torch.from_numpy(batch.images).to(dev),
            torch.from_numpy(batch.im_hw).to(dev),
            gt_boxes=torch.from_numpy(batch.boxes).to(dev),
            gt_mask=torch.from_numpy(batch.node_mask).to(dev))
    index = (out["proposal_index"], out["rpn_prop_mask"])
    gen = torch.Generator().manual_seed(0)
    draws = {"rpn": balanced_draws(gen, out["rpn_obj_logits"].shape, "cpu"),
             "roi": balanced_draws(gen, out["prop_mask"].shape, "cpu")}
    losses = {}
    for d in ("cpu", dev):
        det = _tiny_fpn(d)
        losses[str(d)], _ = detector_losses(
            det, batch.to(d),
            draws={k: tuple(u.to(d) for u in v) for k, v in draws.items()},
            proposal_index=tuple(t.to(d) for t in index))
    for k, want in losses["cpu"].items():
        torch.testing.assert_close(losses["cuda"][k].cpu(), want.detach(),
                                   atol=0, rtol=1e-5)

    det = _tiny_fpn(dev).to_compute_dtype(torch.bfloat16)
    stats = {k: b.clone() for k, b in det.named_buffers()}
    step = make_detector_train_step(det, DetectorOptimizer(
        det, lambda count: 0.005))
    bd = batch.to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    step(bd, g)
    torch.cuda.synchronize()
    ks = (troi.KERNEL, troi.KERNEL_BWD_FMAP, troi.KERNEL_BWD_BOXES)
    for k in ks:
        k.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(bd, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(v).item() for v in metrics.values())
    assert [dict(k.routes) for k in ks] == [
        {"bf16": 4}, {"bf16-gather": 4}, {"bf16": 4}]
    for k, b in det.named_buffers():
        assert torch.equal(b, stats[k]), k


def test_imported_vgg_detector_card_matches_cpu(dev):
    """A torchvision-format ``FasterRCNN(vgg16)`` state dict through the
    importer, then its f32 forward on the card against the CPU's, the CPU
    held on the card's proposals: the continuous outputs within 1e-4 of
    their size, the detections' decisions equal."""
    from sgg_torch.import_reference_ckpt import reference_state_dict
    from sgg_torch.models.detector import FasterRCNNVGG
    from sgg_torch.train.checkpoint import import_torch_faster_rcnn

    cpu = FasterRCNNVGG(8, obj_dim=48, score_thresh=0.05).eval()
    sd = reference_state_dict("detector", cpu,
                              torch.Generator().manual_seed(5))
    cpu.load_state_dict(import_torch_faster_rcnn(cpu.state_dict(), sd),
                        strict=True)
    card = FasterRCNNVGG(8, obj_dim=48, score_thresh=0.05)
    card.load_state_dict(cpu.state_dict())
    card = card.to(dev).eval()
    g = torch.Generator().manual_seed(0)
    images = torch.randn(2, 96, 96, 3, generator=g)
    im_hw = torch.tensor([[96.0, 96.0], [80.0, 96.0]])
    k_roi, k_stem = troi.KERNEL.launches, vgg_stem.KERNEL.launches
    with torch.no_grad():
        got = card(images.to(dev), im_hw.to(dev))
        torch.cuda.synchronize()
        assert troi.KERNEL.launches == k_roi + 1
        assert vgg_stem.KERNEL.launches == k_stem + 1
        got = {k: v.cpu() for k, v in got.items()}
        want = cpu(images, im_hw, proposal_index=(got["proposal_index"],
                                                  got["rpn_prop_mask"]))
    assert got["mask"].sum() > 0
    for k in ("fmap", "rpn_obj_logits", "rpn_deltas", "class_logits",
              "box_deltas"):
        scale = float(want[k].abs().max())
        torch.testing.assert_close(got[k], want[k], atol=1e-4 * scale,
                                   rtol=0, msg=k)
    for k in ("mask", "labels"):
        assert torch.equal(got[k], want[k]), k


def test_roi_align_backward_fmap_f32_gather_at_a_crowded_gan_shape(dev):
    """K1-bwd-fmap on ``f32-gather`` (the GAN's f32 fake map) with 256
    heavily overlapping union boxes an image and 40 node boxes over a
    37 x 37 map, against its plain version; two launches, the same bits."""
    rng = np.random.RandomState(5)
    B, H, C = 2, 37, 64
    nodes = rng.rand(B, 40, 4).astype(np.float32) * 400
    nodes[..., 2:] = nodes[..., :2] + 40 + rng.rand(B, 40, 2) * 150
    i, j = rng.randint(0, 40, (2, B, 256))
    take = np.take_along_axis
    unions = np.concatenate([
        np.minimum(take(nodes[..., :2], i[..., None], 1),
                   take(nodes[..., :2], j[..., None], 1)),
        np.maximum(take(nodes[..., 2:], i[..., None], 1),
                   take(nodes[..., 2:], j[..., None], 1))], -1)
    troi.KERNEL_BWD_FMAP.reset_counts()
    for boxes in (nodes, unions):
        b = torch.from_numpy(np.ascontiguousarray(boxes)).to(dev)
        g = torch.randn(B, b.shape[1], 7, 7, C, generator=torch.Generator(
        ).manual_seed(1)).to(dev)
        want = troi.roi_align_backward_reference(g, b, (H, H), torch.float32,
                                                 spatial_scale=1 / 16)
        got = [troi._grad_fmap_kernel(g, b, (B, H, H, C), torch.float32,
                                      1 / 16, 7, 2) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1])
        torch.testing.assert_close(got[0], want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    assert dict(troi.KERNEL_BWD_FMAP.routes) == {"f32-gather": 4}


def _tiny_gan_step(device, seed=0, vis_cond=False):
    from sgg_torch.config import Config
    from sgg_torch.models.backbone import Dropout
    from sgg_torch.models.gan import GANModel, init_gan_weights
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.gan_step import (create_gan_optimizers,
                                          make_gan_train_step)
    from sgg_torch.train.state import Optimizer
    model = init_weights(RelModelIMP(num_classes=9, num_predicates=6,
                                     hidden_dim=16, obj_dim=32), seed)
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    gan = init_gan_weights(GANModel(9, 6, embed_dim=16, hidden_dim=8,
                                    fmap_sz=8, n_layers_G=2, largeD=True,
                                    vis_cond=vis_cond), seed + 1)
    model, gan = model.to(device), gan.to(device)
    cfg = Config(device=str(device), mode="sgcls", loss="dnorm",
                 batch_size=2, max_nodes=8, max_edges=12,
                 compute_dtype="float32", gan=True, perturb="graphn")
    opt = Optimizer(cfg, model)
    g_opt, d_opt = create_gan_optimizers(cfg, gan)
    return (model, gan), make_gan_train_step(model, gan, cfg, opt, g_opt,
                                             d_opt)


def _gan_batch():
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    return SyntheticSGGDataset(num_images=2, num_classes=9, num_predicates=6,
                               max_objects=6, image_size=128,
                               with_images=True, seed=3).batch(
        [0, 1], max_nodes=8, max_edges=12)


def test_tiny_gan_step_card_matches_cpu_and_counts_routes(dev):
    """One f32 GAN step (D, G and rec; dropout off) on the card and on the
    CPU, from the same weights on the same sampled edges: the losses within
    1e-4 relative, the updated relation model within phase 6's limits;
    on the card K2 once, K1 twice on the real map and four times on the
    f32 fake map, K1-bwd-fmap twice on ``f32-gather``, nothing else; a
    second step waits for nothing."""
    from sgg_torch.train.assign import sample_edges
    batch = _gan_batch()
    edges = sample_edges(torch.Generator().manual_seed(0),
                         *(torch.from_numpy(a) for a in (
                             batch.rels, batch.rel_mask, batch.node_mask)),
                         max_out=12)
    fake = torch.from_numpy(batch.classes.astype(np.int64))
    fake[torch.from_numpy(batch.node_mask)] = fake[torch.from_numpy(
        batch.node_mask)] % 8 + 1
    (cpu, _), cpu_step = _tiny_gan_step("cpu")
    (card, card_gan), card_step = _tiny_gan_step(dev)
    kernels = (troi.KERNEL, troi.KERNEL_BWD_FMAP, troi.KERNEL_BWD_BOXES,
               vgg_stem.KERNEL, vgg_stem.KERNEL_BWD)
    for k in kernels:
        k.reset_counts()
    got = card_step(batch, fake, None, edges=edges)
    torch.cuda.synchronize()
    assert [dict(k.routes) for k in kernels] == [
        {"f32": 6}, {"f32-gather": 2}, {}, {"f32": 1}, {}]
    want = cpu_step(batch, fake, None, edges=edges)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], atol=0,
                                   rtol=1e-4)
    theirs = cpu.state_dict()
    for k, v in card.state_dict().items():
        torch.testing.assert_close(v.cpu(), theirs[k], atol=1e-6, rtol=1e-5)
    on_card = batch.to(dev)
    fake = fake.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = card_step(on_card, fake,
                            torch.Generator(device=dev).manual_seed(1))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_tiny_conditioned_gan_step_card_matches_cpu_and_does_not_wait(dev):
    """The ``vis_cond`` GAN step on the same vis tensor, card against CPU
    (the losses within 1e-4 relative, the relation model after within
    phase 6's limits), the routes of the unconditioned step, and a step
    under ``set_sync_debug_mode("error")``."""
    from sgg_torch.train.assign import sample_edges
    batch = _gan_batch()
    edges = sample_edges(torch.Generator().manual_seed(0),
                         *(torch.from_numpy(a) for a in (
                             batch.rels, batch.rel_mask, batch.node_mask)),
                         max_out=12)
    fake = torch.from_numpy(batch.classes.astype(np.int64))
    vis = torch.relu(torch.randn(2, 8, 7, 7, 512,
                                 generator=torch.Generator().manual_seed(2)))
    vis *= torch.from_numpy(batch.node_mask)[:, :, None, None, None]
    (cpu, _), cpu_step = _tiny_gan_step("cpu", vis_cond=True)
    (card, card_gan), card_step = _tiny_gan_step(dev, vis_cond=True)
    kernels = (troi.KERNEL, troi.KERNEL_BWD_FMAP, troi.KERNEL_BWD_BOXES,
               vgg_stem.KERNEL, vgg_stem.KERNEL_BWD)
    for k in kernels:
        k.reset_counts()
    got = card_step(batch, fake, None, edges=edges, vis_features=vis)
    torch.cuda.synchronize()
    assert [dict(k.routes) for k in kernels] == [
        {"f32": 6}, {"f32-gather": 2}, {}, {"f32": 1}, {}]
    want = cpu_step(batch, fake, None, edges=edges, vis_features=vis)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], atol=0,
                                   rtol=1e-4)
    theirs = cpu.state_dict()
    for k, v in card.state_dict().items():
        torch.testing.assert_close(v.cpu(), theirs[k], atol=1e-6, rtol=1e-5)
    on_card, fake, vis = batch.to(dev), fake.to(dev), vis.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = card_step(on_card, fake,
                            torch.Generator(device=dev).manual_seed(1),
                            vis_features=vis)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_extraction_forward_card_matches_cpu_and_does_not_wait(dev):
    """``extract_features``' pools step (f32, tiny heads, 128 px), card
    against CPU within 1e-4 of the pools' largest magnitude; K2 once and K1
    twice; no host sync until the pools are read."""
    import copy

    from sgg_torch.extract_features import make_pools_step
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    model = init_weights(RelModelIMP(num_classes=9, num_predicates=6,
                                     hidden_dim=16, obj_dim=32), 4)
    batch = _gan_batch()
    want = make_pools_step(model, "cpu")(batch)
    step = make_pools_step(copy.deepcopy(model).to(dev), dev)
    troi.KERNEL.reset_counts()
    vgg_stem.KERNEL.reset_counts()
    got = step(batch)
    torch.cuda.synchronize()
    assert (troi.KERNEL.launches, vgg_stem.KERNEL.launches) == (2, 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err
    on_card = batch.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = step(on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, got)


def test_batch_recall_and_distances_card_match_cpu(dev):
    """``batch_recall`` on the card gives the CPU's recalls exactly (ties
    among the scores included); ``_pairwise_distance``'s squares within
    1e-4 of the largest, and PRDC equal."""
    from sgg_torch.augment import gan_eval
    from sgg_torch.eval.recall_jit import batch_recall
    g = torch.Generator().manual_seed(5)
    B, N, E, G = 3, 9, 72, 6
    boxes = torch.rand(B, N, 2, generator=g) * 80
    boxes = torch.cat([boxes, boxes + 10 + torch.rand(B, N, 2, generator=g)
                       * 40], -1)
    classes = torch.randint(1, 6, (B, N), generator=g)
    pairs = torch.randint(0, N, (B, E, 2), generator=g)
    pair_mask = torch.rand(B, E, generator=g) < 0.9
    rel = torch.round(torch.rand(B, E, 5, generator=g) * 3)  # ties
    scores = torch.round(torch.rand(B, N, generator=g) * 2) / 2 + 0.5
    gt_rels = torch.cat([pairs[:, :G], torch.randint(1, 5, (B, G, 1),
                                                     generator=g)], -1)
    gt_mask = torch.rand(B, G, generator=g) < 0.8
    args = (boxes, classes, scores, pairs, pair_mask, rel, boxes, classes,
            gt_rels, gt_mask)
    want = batch_recall(*args, ks=(5, 20, 50))
    got = batch_recall(*(a.to(dev) for a in args), ks=(5, 20, 50))
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    rng = np.random.RandomState(6)
    real = rng.randn(300, 512).astype(np.float32)
    fake = (rng.randn(200, 512) + 0.2).astype(np.float32)
    for a, b in ((real, None), (real, fake)):
        d = {x: gan_eval._pairwise_distance(a, b, device=x).astype(
            np.float64) ** 2 for x in ("cuda", "cpu")}
        assert np.abs(d["cuda"] - d["cpu"]).max() <= 1e-4 * d["cpu"].max()
    assert gan_eval.compute_prdc(real, fake, device="cuda") == \
        gan_eval.compute_prdc(real, fake, device="cpu")
