"""The frozen VGG16 trunk's conv epilogue: bias, ReLU and, before a pool,
the 2x2 max-pool in one pass over a bias-less convolution's output.

It replaces no TPU kernel: XLA fused this epilogue into the TPU's
convolutions. On the card the trunk's convolutions stay cuDNN's
``conv2d``, run without their bias, and this pass follows each one
(``models/backbone.py``). For tensors on the CPU it is the plain version
(``conv_epilogue_reference``); for tensors on the card the CUDA kernel
``csrc/conv_epilogue.cu``, with no fall-back from one to the other. Its
launch counter names four routes: ``<dtype>-<pool>``, dtype ``bf16`` or
``f32``, pool ``pool`` or ``nopool``.

Arithmetic (both versions): the map and the bias are widened to float32
and added in float32 (one float32 rounding), and a bfloat16 map's sum is
narrowed once to bfloat16. Rounding and ``+ b`` are monotone, so the
pooled form gives the bits of bias -> ReLU -> pool in this arithmetic.
Not differentiable: an input that requires a gradient is refused while
grad mode is on, and the trunk takes this pass only when autograd records
nothing (``VGG16Trunk.forward``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sgg_torch.ops._cuda import CudaKernel, refuse_grad

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("conv_epilogue.cu", "sgg_conv_epilogue",
                    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the kernel's 16-byte vector, in elements; C / vector must divide 256
_VEC = {torch.float32: 4, torch.bfloat16: 8}
_THREADS = 256


def route(dtype: torch.dtype, pool: bool) -> str:
    return f"{_NAMES[dtype]}-{'pool' if pool else 'nopool'}"


def conv_epilogue_reference(y: torch.Tensor, b: torch.Tensor,
                            pool: bool) -> torch.Tensor:
    """Plain version: ``relu(y + b)``, or ``relu(max_pool2d(y, 2, 2) + b)``
    with ``pool``, on NHWC ``y`` (B, H, W, C), computed in float32 and
    narrowed once to ``y``'s type; a new NHWC tensor."""
    v = y.float()
    if pool:
        v = F.max_pool2d(v.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return torch.relu(v + b.float()).to(y.dtype).contiguous()


def _check_card(y: torch.Tensor, b: torch.Tensor) -> None:
    if y.device.type != "cuda" or b.device != y.device:
        raise ValueError(f"conv_epilogue: y on {y.device}, b on {b.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"conv_epilogue: y {y.dtype} (float32/bfloat16)")
    C = y.shape[-1] if y.dim() == 4 else -1
    if C < 1 or tuple(b.shape) != (C,):
        raise ValueError(f"conv_epilogue: y {tuple(y.shape)} (B, H, W, C), "
                         f"b {tuple(b.shape)}")
    vec = _VEC[y.dtype]
    if C % vec or _THREADS % (C // vec):
        raise ValueError(f"conv_epilogue: C = {C} must be {vec} times a "
                         f"divisor of {_THREADS} for {y.dtype}")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("conv_epilogue: y must be contiguous NHWC, "
                         "16-byte aligned")
    if y.numel() // vec >= 2 ** 31:
        raise ValueError(f"conv_epilogue: y {tuple(y.shape)} has 2**31 "
                         f"16-byte vectors or more")


def conv_epilogue(y: torch.Tensor, b: torch.Tensor,
                  pool: bool) -> torch.Tensor:
    """``relu(y + b)`` (in place on the card) or, with ``pool``,
    ``relu(max_pool2d(y, 2, 2) + b)`` into a new (B, H // 2, W // 2, C)
    tensor; ``y`` (B, H, W, C) channels-last float32/bfloat16, ``b`` (C,)
    of any float type, added in float32."""
    refuse_grad("conv_epilogue", y, b,
                backward="the frozen trunk's epilogue has no backward")
    if y.device.type == "cpu":
        return conv_epilogue_reference(y, b, pool)
    _check_card(y, b)
    B, H, W, C = y.shape
    out = (torch.empty((B, H // 2, W // 2, C), dtype=y.dtype,
                       device=y.device) if pool else y)
    if out.numel() == 0:
        return out
    # the kernel widens a float32 or bfloat16 bias itself: no cast launch
    b = (b if b.dtype in _DTYPES else b.float()).contiguous()
    KERNEL.launch(y.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W, C,
                  _DTYPES[y.dtype], _DTYPES[b.dtype], int(pool),
                  torch.cuda.current_stream(y.device).cuda_stream,
                  route=route(y.dtype, pool))
    return out
