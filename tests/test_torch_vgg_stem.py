"""VGG conv1_1: the port's plain version against ``sgg_tpu``'s Pallas stem
kernel (interpret mode) and ``lax.conv_general_dilated`` in f32, and in
bf16 against the Pallas kernel's bf16 rounding (weights to bf16, f32 sums,
f32 bias), which is the contract of the CUDA kernel's bf16 route. The CUDA
kernel K2 itself is held against the plain version in
``test_torch_cuda.py``, which needs no JAX and runs on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.ops.vgg_stem_pallas import vgg_conv1_pallas
from sgg_torch.ops import vgg_stem


def _inputs(H, W, B=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    return x, w, b


def _lax(x, w, b):
    return np.asarray(jax.nn.relu(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b))


def _plain(x, w, b):
    return vgg_stem.vgg_conv1(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b)).numpy()


def test_plain_matches_pallas_interpret():
    x, w, b = _inputs(32, 24)
    want = np.asarray(vgg_conv1_pallas(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), tile_rows=16,
                                       interpret=True))
    np.testing.assert_allclose(_plain(x, w, b), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(32, 24), (37, 29)])
def test_plain_matches_lax_conv(hw):
    # 37 rows: no multiple of the Pallas kernel's 16-row tile (port only)
    x, w, b = _inputs(*hw, seed=1)
    got = _plain(x, w, b)
    assert got.shape == (2, *hw, 64)
    np.testing.assert_allclose(got, _lax(x, w, b), atol=1e-5, rtol=0)


def test_cpu_tensor_takes_plain_version():
    x, w, b = _inputs(8, 8)
    before = vgg_stem.KERNEL.launches
    _plain(x, w, b)
    assert vgg_stem.KERNEL.launches == before


def _pallas_bf16(x, w, b):
    """``vgg_conv1_pallas`` on bf16 ``x`` (it rounds ``w`` to bf16, sums in
    f32 and adds the f32 bias), as f32 numpy."""
    out = vgg_conv1_pallas(jnp.asarray(x).astype(jnp.bfloat16),
                           jnp.asarray(w), jnp.asarray(b), tile_rows=16,
                           interpret=True)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bf16_matches_pallas_bf16(seed):
    """bf16 in both packages on the same bf16-rounded weights, within 2e-2
    of the largest magnitude. The two frameworks round bf16 at different
    places: the Pallas kernel keeps the sum and the bias in f32 and rounds
    once, the plain PyTorch convolution also rounds the bias to bf16."""
    x, w, b = _inputs(32, 24, seed=seed)
    want = _pallas_bf16(x, w, b)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = vgg_stem.vgg_conv1(xt, wt, torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_on_rounded_inputs_matches_pallas_bf16(seed):
    """The rounding contract of the CUDA kernel's bf16 route, on the CPU:
    the plain version in f32 on bf16-rounded x and w (exact products, f32
    sums, f32 bias) is the Pallas kernel's bf16 result before its one
    final rounding, so the two differ by at most one bf16 ulp of the
    largest magnitude."""
    x, w, b = _inputs(32, 24, seed=seed)
    want = _pallas_bf16(x, w, b)
    xr = torch.from_numpy(x).bfloat16().float()
    wr = torch.from_numpy(w).bfloat16().float()
    got = vgg_stem.vgg_conv1_reference(xr, wr, torch.from_numpy(b)).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp
