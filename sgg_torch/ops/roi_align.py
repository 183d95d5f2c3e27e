"""RoIAlign: the CUDA kernel K1 and its plain PyTorch version.

Counterpart of ``sgg_tpu/ops/roi_align.py:roi_align`` and of the TPU kernel
``sgg_tpu/ops/roi_align_pallas.py:roi_align_pallas``; semantics of
``torchvision.ops.roi_align(aligned=False, sampling_ratio=ratio)`` over
NHWC feature maps and image-pixel boxes (reference
``sgg_models/rel_model_base.py:97-99,256-260``).

``roi_align`` takes the plain version for a tensor on the CPU and launches
the CUDA kernel (``csrc/roi_align.cu``) for a tensor on the card; there is
no fall-back from one to the other. ``folded_axis_taps`` models the
kernel's per-bin tap tables in numpy for the CPU tests; nothing on the
main path calls it.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sgg_torch.ops._cuda import CudaKernel, refuse_grad

KERNEL = CudaKernel(
    "roi_align.cu", "sgg_roi_align",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _interp_weights(start: torch.Tensor, extent: torch.Tensor, dim: int,
                    pooled: int, ratio: int) -> torch.Tensor:
    """(..., P, dim) f32 bilinear-sample + bin-average weights such that
    ``W @ fmap_axis`` is torchvision ``roi_align(aligned=False)`` along one
    axis (``sgg_tpu/ops/roi_align.py:_interp_weights``)."""
    S = pooled * ratio
    i = torch.arange(S, dtype=torch.float32, device=start.device)
    # divided by a tensor: by a Python number PyTorch multiplies with the
    # rounded reciprocal on the card, one ulp off the division that the
    # CPU and the CUDA kernel do
    y = (start[..., None]
         + extent[..., None] * (i + 0.5) / torch.full_like(i, S))  # (..., S)
    valid = (y >= -1.0) & (y <= dim)
    yc = y.clamp(min=0.0)
    y_low = torch.floor(yc).long()
    cap = y_low >= dim - 1
    y_low = torch.where(cap, torch.full_like(y_low, dim - 1), y_low)
    y_high = torch.where(cap, torch.full_like(y_low, dim - 1), y_low + 1)
    zero = torch.zeros_like(yc)
    frac = torch.where(cap, zero, yc - y_low.float())
    w_low = torch.where(valid, 1.0 - frac, zero)
    w_high = torch.where(valid, frac, zero)
    W = (w_low[..., None] * F.one_hot(y_low, dim).float()
         + w_high[..., None] * F.one_hot(y_high, dim).float())
    return W.reshape(*W.shape[:-2], pooled, ratio, dim).mean(dim=-2)


def folded_axis_taps(start: float, extent: float, dim: int, pooled: int,
                     ratio: int) -> List[List[Tuple[int, float]]]:
    """Model of the tap table that the CUDA kernel builds per ROI and axis
    (``csrc/roi_align.cu``): for each of the ``pooled`` bins the distinct
    (index, weight) taps of its ``ratio`` samples, the bin average folded
    in as a factor ``1 / ratio``, equal indices merged, zero weights
    dropped. At most ``2 * ratio`` taps a bin; scattered into a dense
    (pooled, dim) matrix they are one ROI's ``_interp_weights``. All
    arithmetic is float32, in the kernel's order."""
    f32 = np.float32
    start, extent = f32(start), f32(extent)
    S, inv = pooled * ratio, f32(1.0) / f32(ratio)
    table = []
    for p in range(pooled):
        taps: List[List] = []
        for i in range(p * ratio, (p + 1) * ratio):
            y = start + extent * (f32(i) + f32(0.5)) / f32(S)
            valid = bool(y >= f32(-1.0)) and bool(y <= f32(dim))
            yc = max(y, f32(0.0))
            low = int(np.floor(yc))
            cap = low >= dim - 1
            low = dim - 1 if cap else low
            high = dim - 1 if cap else low + 1
            frac = f32(0.0) if cap else yc - f32(low)
            w_low = f32(1.0) - frac if valid else f32(0.0)
            w_high = frac if valid else f32(0.0)
            for index, w in ((low, w_low * inv), (high, w_high * inv)):
                if w == 0.0:
                    continue
                for tap in taps:
                    if tap[0] == index:
                        tap[1] = tap[1] + w
                        break
                else:
                    taps.append([index, w])
        table.append([(index, float(w)) for index, w in taps])
    return table


def _box_frames(boxes: torch.Tensor, spatial_scale: float):
    sb = boxes.float() * spatial_scale
    x1, y1 = sb[..., 0], sb[..., 1]
    roi_w = torch.clamp(sb[..., 2] - x1, min=1.0)  # aligned=False
    roi_h = torch.clamp(sb[..., 3] - y1, min=1.0)
    return x1, y1, roi_w, roi_h


def roi_align_reference(fmap: torch.Tensor, boxes: torch.Tensor, *,
                        spatial_scale: float, pooled: int = 7,
                        ratio: int = 2, roi_chunk: int = 64) -> torch.Tensor:
    """Plain version: two interpolation products per ROI,
    ``out[p, q, c] = Wy[p, :] @ fmap[:, :, c] @ Wx[q, :]^T``, over ROI
    chunks that bound the (B, chunk, P, W, C) intermediate."""
    B, H, W, C = fmap.shape
    x1, y1, roi_w, roi_h = _box_frames(boxes, spatial_scale)
    dtype = fmap.dtype
    Wy = _interp_weights(y1, roi_h, H, pooled, ratio).to(dtype)  # (B,R,P,H)
    Wx = _interp_weights(x1, roi_w, W, pooled, ratio).to(dtype)  # (B,R,P,W)
    outs = []
    for s in range(0, boxes.shape[1], roi_chunk):
        wy, wx = Wy[:, s:s + roi_chunk], Wx[:, s:s + roi_chunk]
        t = torch.einsum("brph,bhwc->brpwc", wy, fmap)
        outs.append(torch.einsum("brqw,brpwc->brpqc", wx, t))
    if not outs:
        return fmap.new_zeros((B, 0, pooled, pooled, C))
    return torch.cat(outs, dim=1)


def roi_align(fmap: torch.Tensor, boxes: torch.Tensor, *,
              spatial_scale: float, pooled: int = 7,
              ratio: int = 2) -> torch.Tensor:
    """(B, H, W, C) NHWC fmap + (B, R, 4) image-pixel boxes ->
    (B, R, P, P, C) in the fmap's type.

    On the card the output has no ``grad_fn``: with grad mode on, inputs
    that require a gradient are refused (K1's backward, ``grad_fmap``, is
    queued for the GAN slice, ROADMAP Queue B). The plain version on the
    CPU is differentiable."""
    if fmap.device.type == "cpu":
        return roi_align_reference(fmap, boxes, spatial_scale=spatial_scale,
                                   pooled=pooled, ratio=ratio)
    if fmap.device.type != "cuda" or boxes.device != fmap.device:
        raise ValueError(f"roi_align: fmap on {fmap.device}, boxes on "
                         f"{boxes.device}")
    if fmap.dtype not in _DTYPES or boxes.dtype != torch.float32:
        raise TypeError(f"roi_align: fmap {fmap.dtype} (float32/bfloat16), "
                        f"boxes {boxes.dtype} (float32)")
    if fmap.dim() != 4 or boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.shape[0] != fmap.shape[0]:
        raise ValueError(f"roi_align: fmap {tuple(fmap.shape)}, boxes "
                         f"{tuple(boxes.shape)}")
    if not (fmap.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("roi_align: fmap and boxes must be contiguous")
    refuse_grad("roi_align", fmap, boxes,
                backward="K1's backward is queued for the GAN slice, "
                         "ROADMAP Queue B")
    B, H, W, C = fmap.shape
    R = boxes.shape[1]
    out = torch.empty((B, R, pooled, pooled, C), dtype=fmap.dtype,
                      device=fmap.device)
    KERNEL.launch(fmap.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W,
                  C, R, float(spatial_scale), pooled, ratio,
                  _DTYPES[fmap.dtype],
                  torch.cuda.current_stream(fmap.device).cuda_stream,
                  route=ROUTES[fmap.dtype])
    return out
