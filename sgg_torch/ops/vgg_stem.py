"""VGG16 conv1_1 (3 -> 64, 3x3, pad 1, bias, ReLU): the CUDA kernel K2 and
its plain PyTorch version.

Counterpart of the TPU kernel ``sgg_tpu/ops/vgg_stem_pallas.py:
vgg_conv1_pallas`` — the first layer of ``VGG16Trunk`` (reference
torchvision ``vgg16.features[0]``, ``sgg_models/rel_model_base.py:310-321``).
Channels-last in and out, HWIO weights, as in the JAX package.

``vgg_conv1`` is a ``torch.autograd.Function``, differentiable in the
weights and the bias (the images get no gradient, and one that asks for it
is refused). For tensors on the CPU its forward and backward are the plain
versions (``vgg_conv1_reference``, ``vgg_conv1_backward_reference``); for
tensors on the card they are CUDA kernels: K2 (``csrc/vgg_stem.cu``)
forward, K2-bwd (``csrc/vgg_stem_bwd.cu``) backward, whose launch counter
names its two routes: "bf16-mma" (bf16 inputs, on the tensor cores) and
"f32" (exact FMAs on the CUDA cores). There is no fall-back
from a kernel to a plain version. For bfloat16 ``x`` both forwards round
the weights to bfloat16 (the kernel then multiplies on the tensor cores
with float32 accumulation and a float32 bias); for float32 ``x`` the kernel
is exact float32 arithmetic. Both backwards sum in float32 and return
float32 gradients, which autograd casts to the weights' type.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sgg_torch.ops._cuda import CudaKernel, refuse_grad
from sgg_torch.utils.profiling import (kernel_flops, vgg_conv1_bwd_flops,
                                       vgg_conv1_flops)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "vgg_stem.cu", "sgg_vgg_conv1", [_P, _P, _P, _P, _I, _I, _I, _I, _P])
KERNEL_BWD = CudaKernel(
    "vgg_stem_bwd.cu", "sgg_vgg_conv1_bwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
# K2-bwd's first pass runs a fixed grid, so a fixed summation order: the f32
# route 1056 blocks (8 an SM of an H100), the bf16-mma route 2 blocks an SM
BWD_BLOCKS = 1056
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16"}
BWD_ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16-mma"}


def vgg_conv1_reference(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``relu(conv2d(x, w, padding=1) + b)`` on NHWC
    ``x`` (B, H, W, 3) and HWIO ``w`` (3, 3, 3, 64) -> (B, H, W, 64)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 b.to(x.dtype), padding=1)
    return torch.relu(y).permute(0, 2, 3, 1).contiguous()


def vgg_conv1_backward_reference(x: torch.Tensor, out: torch.Tensor,
                                 g: torch.Tensor):
    """Plain (grad_w (3, 3, 3, 64) HWIO, grad_b (64,)), f32: the autograd
    of ``vgg_conv1_reference`` in f32 for the output's gradient ``g``,
    with the ReLU's mask taken from the forward's output ``out``."""
    x32 = x.float().permute(0, 3, 1, 2)
    gm = torch.where(out > 0, g.float(), 0.0).permute(0, 3, 1, 2)
    w = torch.zeros((64, 3, 3, 3), device=x.device, requires_grad=True)
    b = torch.zeros(64, device=x.device, requires_grad=True)
    with torch.enable_grad():
        y = F.conv2d(x32, w, b, padding=1)
        gw, gb = torch.autograd.grad(y, (w, b), gm)
    return gw.permute(2, 3, 1, 0).contiguous(), gb


def _check_card(x, w, b) -> None:
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_kernel(x, w, b) -> torch.Tensor:
    B, H, W, _ = x.shape
    w32 = w.float().contiguous()  # (dy, dx, c, o) == (27, 64) row-major
    b32 = b.float().contiguous()
    out = torch.empty((B, H, W, 64), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), w32.data_ptr(), b32.data_ptr(),
                  out.data_ptr(), B, H, W, _DTYPES[x.dtype], _stream(x),
                  route=ROUTES[x.dtype])
    return out


def _backward_kernel(x, out, g):
    """K2-bwd: per-block partial sums, then one reduce; f32. bf16 inputs
    take the tensor cores ("bf16-mma", which copies its inputs in 16- and
    4-byte pieces: a view off 16-byte alignment is copied first), f32
    inputs exact FMAs ("f32")."""
    B, H, W, _ = x.shape
    blocks = BWD_BLOCKS
    if x.dtype == torch.bfloat16:
        blocks = 2 * torch.cuda.get_device_properties(
            x.device).multi_processor_count
        x, out, g = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (x, out, g))
    partials = torch.empty((blocks, 28, 64), dtype=torch.float32,
                           device=x.device)
    grad = torch.empty((28, 64), dtype=torch.float32, device=x.device)
    KERNEL_BWD.launch(x.data_ptr(), out.data_ptr(), g.data_ptr(),
                      partials.data_ptr(), grad.data_ptr(), B, H, W,
                      blocks, _DTYPES[x.dtype], _stream(x),
                      route=BWD_ROUTES[x.dtype])
    return grad[:27].view(3, 3, 3, 64), grad[27]


class _VggConv1(torch.autograd.Function):
    """K2 and K2-bwd on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, w, b):
        with kernel_flops(vgg_conv1_flops(x.shape[:3].numel())):
            out = (vgg_conv1_reference(x, w, b) if x.device.type == "cpu"
                   else _forward_kernel(x, w, b))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        if not any(ctx.needs_input_grad[1:]):
            return None, None, None
        with kernel_flops(vgg_conv1_bwd_flops(x.shape[:3].numel())):
            if x.device.type == "cpu":
                gw, gb = vgg_conv1_backward_reference(x, out, g)
            else:
                gw, gb = _backward_kernel(x, out,
                                          g.to(x.dtype).contiguous())
        return None, gw, gb


def vgg_conv1(x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x, w, pad=1) + b) for the 3 -> 64 VGG stem, any H, W.

    x: (B, H, W, 3) float32/bfloat16; w: (3, 3, 3, 64) HWIO; b: (64,).
    Returns (B, H, W, 64) in x's type, channels-last contiguous,
    differentiable in ``w`` and ``b``. Images that require a gradient are
    refused while grad mode is on: no kernel computes it.
    """
    if x.device.type != "cpu":
        _check_card(x, w, b)
    refuse_grad("vgg_conv1", x,
                backward="the VGG stem's images get no gradient; K2-bwd "
                         "computes the weights' and the bias'")
    return _VggConv1.apply(x, w, b)
