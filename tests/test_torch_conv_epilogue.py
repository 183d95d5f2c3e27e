"""The frozen trunk's conv epilogue (``ops/conv_epilogue.py``) on the CPU:
its plain version against PyTorch's bias -> ReLU -> pool chain, and the
trunk's choice between the fused pass and autograd's chain
(``VGG16Trunk.forward``). The kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sgg_torch.models import backbone
from sgg_torch.models.backbone import (POOL_AFTER, VGG16_CFG, VGG16Trunk,
                                       normalize_images)
from sgg_torch.models.relhead import init_weights
from sgg_torch.ops import conv_epilogue as ep
from sgg_torch.ops.vgg_stem import vgg_conv1_reference

BF16 = torch.bfloat16
# (H, W): even, odd (a pool floors the last row and column), mixed
SIZES = [(8, 12), (37, 37), (75, 38), (5, 75)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(hw, C, dtype, seed=0):
    rng = np.random.RandomState(seed)
    y = torch.from_numpy(rng.randn(2, *hw, C).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.randn(C) * 0.5).astype(np.float32))
    return y, b


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("C", [64, 512])
@pytest.mark.parametrize("hw", SIZES)
def test_plain_f32_is_the_chain_bit_for_bit(hw, C, pool):
    y, b = _case(hw, C, torch.float32)
    want = F.relu(_nchw(y) + b[:, None, None])
    if pool:
        want = F.max_pool2d(want, 2, 2)
    got = ep.conv_epilogue(y, b, pool)
    assert got.shape == ((2, hw[0] // 2, hw[1] // 2, C) if pool
                         else y.shape)
    assert got.is_contiguous()
    assert torch.equal(got, _nhwc(want))


@pytest.mark.parametrize("bias_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("hw", SIZES)
def test_plain_bf16_adds_in_f32_and_rounds_once(hw, pool, bias_dtype):
    """bf16 maps: the f32 sum of the widened map and bias, then ReLU and
    pool in f32, narrowed once to bf16; never the chain's bf16 + bf16
    add."""
    y, b = _case(hw, 128, BF16, seed=1)
    b = b.to(bias_dtype)
    want = F.relu(_nchw(y).float() + b.float()[:, None, None])
    if pool:
        want = F.max_pool2d(want, 2, 2)
    got = ep.conv_epilogue(y, b, pool)
    assert got.dtype == BF16
    assert torch.equal(got, _nhwc(want).to(BF16))


def test_plain_keeps_nan_and_refuses_a_gradient():
    y = torch.zeros(1, 2, 2, 8)
    y[0, 1, 1, 3] = float("nan")
    y[0, 0, 0, 5] = float("nan")
    got = ep.conv_epilogue(y, torch.full((8,), -1.0), True)
    assert torch.isnan(got[0, 0, 0, 3]) and torch.isnan(got[0, 0, 0, 5])
    assert float(got[0, 0, 0, 0]) == 0.0
    with pytest.raises(RuntimeError, match="conv_epilogue"):
        ep.conv_epilogue(y.requires_grad_(), torch.zeros(8), False)
    with torch.no_grad():  # under no_grad nothing is recorded: taken
        ep.conv_epilogue(y, torch.zeros(8), False)


def test_routes_name_dtype_and_pool():
    assert [ep.route(d, p) for d in (BF16, torch.float32)
            for p in (True, False)] == ["bf16-pool", "bf16-nopool",
                                        "f32-pool", "f32-nopool"]


# ------------------------------------------------------------------ trunk

@pytest.fixture
def epilogue_calls(monkeypatch):
    """Whether each of the trunk's epilogue passes pools, in call order."""
    calls = []

    def spy(y, b, pool):
        calls.append(pool)
        return ep.conv_epilogue(y, b, pool)

    monkeypatch.setattr(backbone, "conv_epilogue", spy)
    return calls


# a fused forward: one pass a cuDNN conv, 4 of them before a pool
FUSED = list(POOL_AFTER[1:])


def _trunk(dtype, store=False):
    trunk = init_weights(VGG16Trunk(), 0)
    trunk.compute_dtype = dtype
    if store:
        trunk.requires_grad_(False).to(dtype)
    return trunk


def _images(hw=(48, 40), seed=2):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (2, *hw, 3),
                                        dtype=np.uint8))


def _chain(trunk, images):
    """The trunk as autograd's path computes it."""
    dtype = trunk.compute_dtype
    stem = trunk.conv[0]
    x = normalize_images(images).to(dtype).contiguous()
    x = _nchw(vgg_conv1_reference(x, stem.weight.permute(2, 3, 1, 0),
                                  stem.bias))
    i = 1
    for v in VGG16_CFG[1:]:
        if v == "M":
            x = F.max_pool2d(x, 2, 2)
        else:
            c = trunk.conv[i]
            x = F.relu(F.conv2d(x, c.weight.to(dtype), c.bias.to(dtype),
                                padding=1))
            i += 1
    return _nhwc(x)


@pytest.mark.parametrize("hw", [(48, 40), (75, 37)])
@pytest.mark.parametrize("dtype,store", [(torch.float32, False),
                                         (BF16, False), (BF16, True)])
def test_frozen_trunk_takes_the_fused_epilogue(dtype, store, hw,
                                               epilogue_calls):
    trunk = _trunk(dtype, store)
    images = _images(hw)
    with torch.no_grad():
        got = trunk(images)
        want = _chain(trunk, images)
    assert epilogue_calls == FUSED and sum(FUSED) == 4 and len(FUSED) == 12
    assert got.shape == (2, hw[0] // 16, hw[1] // 16, 512)
    assert got.dtype == dtype and got.is_contiguous()
    # within one rounding of the map's type at the largest magnitude
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max())))
                  - (7 if dtype == BF16 else 23))
    assert float((got.float() - want.float()).abs().max()) <= ulp


def test_trunk_without_gradients_takes_it_under_grad_mode(epilogue_calls):
    """Grad mode on, but nothing asks a gradient: the fused pass."""
    trunk = _trunk(torch.float32).requires_grad_(False)
    out = trunk(_images())
    assert epilogue_calls == FUSED
    assert not out.requires_grad


@pytest.mark.parametrize("trainable", ["all", "conv5_3"])
def test_trunk_that_trains_keeps_autograd(trainable, epilogue_calls):
    """A weight that requires a gradient keeps autograd's chain, and the
    gradient reaches every conv that asks for one."""
    trunk = _trunk(torch.float32)
    if trainable != "all":
        trunk.requires_grad_(False)
        trunk.conv[-1].weight.requires_grad_(True)
    images = _images()
    out = trunk(images)
    assert epilogue_calls == []
    with torch.no_grad():
        assert torch.equal(out, _chain(trunk, images))
    out.square().sum().backward()
    for k, conv in enumerate(trunk.conv):
        for p in (conv.weight, conv.bias):
            if p.requires_grad:
                assert p.grad is not None and float(p.grad.abs().sum()) > 0, k
            else:
                assert p.grad is None
    assert trunk.conv[-1].weight.grad is not None
