"""The plain backward versions of the port's kernels against the JAX
package, in f32 on the CPU:

* K1-bwd-fmap's plain version (``roi_align_backward_reference``) against
  ``jax.vjp`` of ``roi_align_pallas`` (interpret mode, its custom VJP);
* K1-bwd-boxes' plain version (``roi_align_boxes_grad_reference``) against
  ``jax.grad`` of the XLA ``roi_align`` in its boxes (the JAX detector's
  proposals carry that gradient);
* K2-bwd's plain version (``vgg_conv1_backward_reference``) against
  ``jax.grad`` of flax's f32 ``nn.Conv`` + ReLU;
* and both autograd wrappers on the CPU, which take these plain versions.

The CUDA kernels are held against the plain versions in
``test_torch_cuda.py`` (on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sgg_tpu.ops.roi_align import roi_align as jax_roi_align
from sgg_tpu.ops.roi_align_pallas import roi_align_pallas
from sgg_torch.ops import roi_align as troi
from sgg_torch.ops import vgg_stem

SCALE = 1 / 16.0


def _case(kind, seed=0, C=8):
    rng = np.random.RandomState(seed)
    B, H, W = 2, 9, 11
    fmap = rng.randn(B, H, W, C).astype(np.float32)
    R = 70 if kind == "ragged" else 9
    boxes = rng.rand(B, R, 4).astype(np.float32) * 140
    boxes[..., 2:] += boxes[..., :2] + 10
    if kind == "degenerate":
        boxes[:, :3] = 0.0                       # zero-size at the origin
        boxes[:, 3] = [50.0, 60.0, 40.0, 20.0]   # x2 < x1, y2 < y1
        boxes[:, 4] = [30.0, 30.0, 30.0, 33.0]   # extents under one pixel
    if kind == "outside":
        boxes[:, 0] = [-40.0, -30.0, 20.0, 25.0]     # partly left/above
        boxes[:, 1] = [150.0, 120.0, 260.0, 300.0]   # right/below the map
        boxes[:, 2] = [-300.0, -300.0, -100.0, -90.0]  # wholly outside
        boxes[:, 3] = [-16.0, -16.0, 0.0, 0.0]     # ends on the -1 edge
    if kind == "wholemap":
        boxes[:, 0] = [0.0, 0.0, W * 16.0, H * 16.0]   # capped last samples
        boxes[:, 1] = [-20.0, -20.0, W * 16.0 + 30.0, H * 16.0 + 30.0]
    if kind == "on_grid":
        # y1 = 12, y2 = 124 px: start 0.75 and extent 7 cells, so every even
        # sample of S = 14 lands on an integer row (1, 2, ..., 7); the same
        # along x. Such a sample's high tap has weight 0, its derivative not.
        boxes[:, 0] = [12.0, 12.0, 124.0, 124.0]
        boxes[:, 1] = [28.0, 12.0, 140.0, 124.0]    # columns 2 .. 8
        boxes[:, 2] = [12.0, 28.0, 124.0, 140.0]    # rows 2 .. 8, 8 capped
        boxes[:, 3] = [44.0, 44.0, 156.0, 156.0]    # past the map's end
        # (no sample exactly at 0: XLA compiles ``/ S`` as a product with the
        # rounded reciprocal, which puts JAX's sample there just above 0,
        # past clip's tie, where the port divides exactly)
        boxes[:, 4, 0::2] = [12.0, 124.0]           # on the grid along x only
    g = rng.randn(B, R, 7, 7, C).astype(np.float32)
    return fmap, boxes, g


KINDS = ["random", "ragged", "degenerate", "outside", "wholemap",
         "on_grid"]
_JAX = {}


def _jax_grads(kind):
    """JAX's grad_fmap (Pallas VJP) and grad_boxes (XLA autodiff), once per
    case."""
    if kind not in _JAX:
        fmap, boxes, g = _case(kind)
        f, b, gj = map(jnp.asarray, (fmap, boxes, g))
        _, vjp = jax.vjp(lambda m: roi_align_pallas(
            m, b, spatial_scale=SCALE, chunk=4, interpret=True), f)
        grad_fmap = np.asarray(vjp(gj)[0])
        grad_boxes = np.asarray(jax.grad(lambda bx: jnp.sum(
            jax_roi_align(f, bx, spatial_scale=SCALE) * gj))(b))
        _JAX[kind] = (grad_fmap, grad_boxes)
    return _JAX[kind]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kind", KINDS)
def test_fmap_grad_matches_pallas_vjp(kind):
    fmap, boxes, g = _case(kind)
    want = _jax_grads(kind)[0]
    got = troi.roi_align_backward_reference(
        torch.from_numpy(g), torch.from_numpy(boxes), fmap.shape[1:3],
        torch.float32, spatial_scale=SCALE).numpy()
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"grad_fmap vs Pallas VJP ({kind}): {err:.3g} of its norm")
    assert err <= 1e-5


def test_on_grid_case_puts_samples_on_integer_coordinates():
    """The ``on_grid`` boxes give samples whose high tap weighs 0 while
    their weights' derivative does not."""
    _, boxes, _ = _case("on_grid")
    sb = torch.from_numpy(boxes) * SCALE
    for axis, dim in ((1, 9), (0, 11)):
        start = sb[..., axis]
        extent = (sb[..., axis + 2] - start).clamp(min=1.0)
        _, _, dmask, _, _, w_high = troi._axis_samples(start, extent, dim, 7,
                                                       2)
        on_grid = (w_high == 0) & (dmask != 0)
        assert int(on_grid[:, :4].sum()) >= 2 * 4 * 3, axis


@pytest.mark.parametrize("kind", KINDS)
def test_boxes_grad_matches_xla_autodiff(kind):
    """The plain box gradient against XLA's autodiff. Its algebra is
    K1-bwd-boxes': per bin the dot products of g with the map at the
    unfolded lo/hi rows and columns of the bin's samples. In the
    ``on_grid`` case many samples sit on integer coordinates, where the
    high tap's weight is 0 but the derivative needs the map at that tap: a
    version that took the folded tap tables of the forward (zero weights
    dropped) would fail this case."""
    fmap, boxes, g = _case(kind)
    want = _jax_grads(kind)[1]
    got = troi.roi_align_boxes_grad_reference(
        torch.from_numpy(g), torch.from_numpy(fmap), torch.from_numpy(boxes),
        spatial_scale=SCALE).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    print(f"grad_boxes vs XLA autodiff ({kind}): {_rel(got, want):.3g} of "
          f"its largest")
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("kind", ["random", "outside"])
def test_autograd_on_cpu_takes_the_plain_backward(kind):
    fmap, boxes, g = _case(kind)
    grad_fmap, grad_boxes = _jax_grads(kind)
    f = torch.from_numpy(fmap).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    out = troi.roi_align(f, b, spatial_scale=SCALE)
    gf, gb = torch.autograd.grad(out, (f, b), torch.from_numpy(g))
    assert np.linalg.norm(gf.numpy() - grad_fmap) <= \
        1e-5 * np.linalg.norm(grad_fmap)
    assert _rel(gb.numpy(), grad_boxes) <= 1e-4


def test_backward_of_a_bf16_map_is_bf16_summed_in_f32():
    fmap, boxes, g = _case("random")
    f16 = torch.from_numpy(fmap).bfloat16().requires_grad_()
    out = troi.roi_align(f16, torch.from_numpy(boxes), spatial_scale=SCALE)
    (gf,) = torch.autograd.grad(out, (f16,), torch.from_numpy(g).bfloat16())
    assert gf.dtype == torch.bfloat16
    want = troi.roi_align_backward_reference(
        torch.from_numpy(g).bfloat16(), torch.from_numpy(boxes),
        fmap.shape[1:3], torch.float32, spatial_scale=SCALE)
    assert torch.equal(gf, want.bfloat16())


def test_boxes_grad_is_the_derivative_of_the_forward():
    """A central difference of the plain forward in one box coordinate
    agrees with the plain box gradient (the forward builds its weights in
    f32, so the step is 0.02 px; no sample crosses a tap in these
    cases)."""
    fmap, boxes, g = _case("random", seed=4)
    f64 = torch.from_numpy(fmap).double()
    b = torch.from_numpy(boxes).double()
    gt = torch.from_numpy(g).double()
    grad = troi.roi_align_boxes_grad_reference(
        gt.float(), f64.float(), b.float(), spatial_scale=SCALE).double()
    eps = 0.02
    for r, k in ((0, 0), (1, 1), (2, 2), (3, 3)):
        plus, minus = b.clone(), b.clone()
        plus[0, r, k] += eps
        minus[0, r, k] -= eps
        num = ((troi.roi_align_reference(f64, plus, spatial_scale=SCALE)
                - troi.roi_align_reference(f64, minus, spatial_scale=SCALE))
               * gt).sum() / (2 * eps)
        assert abs(float(num) - float(grad[0, r, k])) <= \
            2e-3 * max(1.0, abs(float(num)))


class _Stem(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.relu(nn.Conv(64, (3, 3), padding=1, dtype=jnp.float32,
                               name="conv")(x))


@pytest.mark.parametrize("hw", [(12, 10), (7, 33)])
def test_vgg_conv1_backward_matches_flax_conv(hw):
    rng = np.random.RandomState(hw[0])
    x = rng.rand(2, *hw, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 64) * 0.2).astype(np.float32)
    b = (rng.randn(64) * 0.2).astype(np.float32)
    g = rng.randn(2, *hw, 64).astype(np.float32)
    params = {"params": {"conv": {"kernel": jnp.asarray(w),
                                  "bias": jnp.asarray(b)}}}
    grads = jax.grad(lambda p: jnp.sum(_Stem().apply(p, jnp.asarray(x))
                                       * jnp.asarray(g)))(params)
    want_w = np.asarray(grads["params"]["conv"]["kernel"])
    want_b = np.asarray(grads["params"]["conv"]["bias"])
    xt = torch.from_numpy(x)
    out = vgg_stem.vgg_conv1_reference(xt, torch.from_numpy(w),
                                       torch.from_numpy(b))
    gw, gb = vgg_stem.vgg_conv1_backward_reference(xt, out,
                                                   torch.from_numpy(g))
    assert gw.shape == (3, 3, 3, 64) and gb.shape == (64,)
    print(f"K2 plain backward vs flax ({hw}): w {_rel(gw.numpy(), want_w):.3g}"
          f", b {_rel(gb.numpy(), want_b):.3g} of the largest")
    assert _rel(gw.numpy(), want_w) <= 1e-5
    assert _rel(gb.numpy(), want_b) <= 1e-5
    # the wrapper's autograd on the CPU takes the same plain backward
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    gw2, gb2 = torch.autograd.grad(vgg_stem.vgg_conv1(xt, wt, bt), (wt, bt),
                                   torch.from_numpy(g))
    assert torch.equal(gw2, gw) and torch.equal(gb2, gb)


def test_vgg_conv1_refuses_images_that_need_a_gradient():
    x = torch.rand(1, 5, 6, 3, requires_grad=True)
    w, b = torch.randn(3, 3, 3, 64), torch.zeros(64)
    with pytest.raises(RuntimeError, match="no CUDA kernel computes"):
        vgg_stem.vgg_conv1(x, w, b)
    with torch.no_grad():
        vgg_stem.vgg_conv1(x, w, b)
