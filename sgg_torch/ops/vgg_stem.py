"""VGG16 conv1_1 (3 -> 64, 3x3, pad 1, bias, ReLU): the CUDA kernel K2 and
its plain PyTorch version.

Counterpart of the TPU kernel ``sgg_tpu/ops/vgg_stem_pallas.py:
vgg_conv1_pallas`` — the first layer of ``VGG16Trunk`` (reference
torchvision ``vgg16.features[0]``, ``sgg_models/rel_model_base.py:310-321``).
Channels-last in and out, HWIO weights, as in the JAX package.

``vgg_conv1`` takes the plain version for a tensor on the CPU and launches
the CUDA kernel (``csrc/vgg_stem.cu``) for a tensor on the card; there is
no fall-back from one to the other. For bfloat16 ``x`` both versions round
the weights to bfloat16 (the kernel then multiplies on the tensor cores
with float32 accumulation and a float32 bias); for float32 ``x`` the kernel
is exact float32 arithmetic.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sgg_torch.ops._cuda import CudaKernel, refuse_grad

KERNEL = CudaKernel(
    "vgg_stem.cu", "sgg_vgg_conv1",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def vgg_conv1_reference(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``relu(conv2d(x, w, padding=1) + b)`` on NHWC
    ``x`` (B, H, W, 3) and HWIO ``w`` (3, 3, 3, 64) -> (B, H, W, 64)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 b.to(x.dtype), padding=1)
    return torch.relu(y).permute(0, 2, 3, 1).contiguous()


def vgg_conv1(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x, w, pad=1) + b) for the 3 -> 64 VGG stem, any H, W.

    x: (B, H, W, 3) float32/bfloat16; w: (3, 3, 3, 64) HWIO; b: (64,).
    Returns (B, H, W, 64) in x's type, channels-last contiguous.

    On the card the output has no ``grad_fn``: with grad mode on, inputs
    that require a gradient are refused (the trunk is frozen, so nothing
    asks for this backward). The plain version on the CPU is
    differentiable.
    """
    if x.device.type == "cpu":
        return vgg_conv1_reference(x, w, b)
    if x.device.type != "cuda" or w.device != x.device \
            or b.device != x.device:
        raise ValueError(f"vgg_conv1: x on {x.device}, w on {w.device}, "
                         f"b on {b.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"vgg_conv1: x {x.dtype} (float32/bfloat16)")
    if x.dim() != 4 or x.shape[-1] != 3 or tuple(w.shape) != (3, 3, 3, 64) \
            or tuple(b.shape) != (64,):
        raise ValueError(f"vgg_conv1: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    if not x.is_contiguous():
        raise ValueError("vgg_conv1: x must be contiguous NHWC")
    refuse_grad("vgg_conv1", x, w, b,
                backward="the trunk is frozen; like K1's backward, queued "
                         "in ROADMAP Queue B, it would need a kernel")
    B, H, W, _ = x.shape
    w32 = w.float().contiguous()  # (dy, dx, c, o) == (27, 64) row-major
    b32 = b.float().contiguous()
    out = torch.empty((B, H, W, 64), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), w32.data_ptr(), b32.data_ptr(),
                  out.data_ptr(), B, H, W, _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream,
                  route=ROUTES[x.dtype])
    return out
