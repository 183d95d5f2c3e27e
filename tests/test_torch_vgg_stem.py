"""VGG conv1_1: the port's plain version against ``sgg_tpu``'s Pallas stem
kernel (interpret mode) and ``lax.conv_general_dilated`` in f32. The CUDA
kernel K2 is held against the plain version in ``test_torch_cuda.py``,
which needs no JAX and runs on the card."""

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
