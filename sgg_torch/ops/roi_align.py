"""RoIAlign: the CUDA kernel K1 and its plain PyTorch version.

Counterpart of ``sgg_tpu/ops/roi_align.py:roi_align`` and of the TPU kernel
``sgg_tpu/ops/roi_align_pallas.py:roi_align_pallas``; semantics of
``torchvision.ops.roi_align(aligned=False, sampling_ratio=ratio)`` over
NHWC feature maps and image-pixel boxes (reference
``sgg_models/rel_model_base.py:97-99,256-260``).

``roi_align`` is a ``torch.autograd.Function``, differentiable in the
feature map and in the boxes. For tensors on the CPU its forward and
backward are the plain versions (``roi_align_reference``,
``roi_align_backward_reference``, ``roi_align_boxes_grad_reference``); for
tensors on the card they are CUDA kernels: K1 (``csrc/roi_align.cu``)
forward, K1-bwd-fmap and K1-bwd-boxes (``csrc/roi_align_bwd.cu``)
backward. There is no fall-back from a kernel to a plain version. The
backward computes what the JAX package differentiates: ``grad_fmap`` as
``roi_align_pallas``' custom VJP (``_bwd``), ``grad_boxes`` as XLA's
autodiff of the separable ``sgg_tpu/ops/roi_align.py:roi_align`` (the JAX
detector's train step differentiates through its proposals).
K1-bwd-fmap is a gather that needs no atomics: per tile of map cells it
lists the ROIs with a tap there, on the card, then sums each cell over its
tile's list in a fixed order, on the tensor cores for a bf16 map and in f32
on the CUDA cores for an f32 one (``csrc/roi_align_bwd.cu``; its routes:
``fmap_route``); two launches give the same bits.
``folded_axis_taps`` models the kernels' per-bin tap tables and
``roi_tile_lists`` K1-bwd-fmap's tile lists, for the CPU tests; nothing on
the main path calls either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sgg_torch.ops._cuda import CudaKernel
from sgg_torch.utils import counters
from sgg_torch.utils.profiling import (kernel_flops, roi_align_boxes_grad_flops,
                                       roi_align_flops)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel(
    "roi_align.cu", "sgg_roi_align",
    [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P])
KERNEL_BWD_FMAP = CudaKernel(
    "roi_align_bwd.cu", "sgg_roi_align_bwd_fmap",
    [_P, _P, _P, ctypes.c_size_t, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I,
     _P])
KERNEL_BWD_BOXES = CudaKernel(
    "roi_align_bwd.cu", "sgg_roi_align_bwd_boxes",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K1-bwd-fmap's routes by the C function's route id
# (``sgg_roi_align_bwd_fmap_route``)
FMAP_ROUTES = ("f32-staged", "f32-gather", "bf16-mma", "bf16-gather")
# ROIs an image past which the staged routes cannot hold a tile's list in
# shared memory (kMmaMaxR of csrc/roi_align_bwd.cu)
FMAP_STAGED_MAX_R = 4096
# K1-bwd-fmap's tiles: map rows x columns (kTileH, kTileW of
# csrc/roi_align_bwd.cu; the card tests hold the two equal)
FMAP_TILE = (4, 4)


def fmap_route(dtype: torch.dtype, C: int, g_ptr: int, R: int) -> str:
    """K1-bwd-fmap's route, as ``csrc/roi_align_bwd.cu:fmap_route`` chooses
    it from what its launcher sees (the card tests hold the two equal): a
    16-byte aligned ``g`` (at address ``g_ptr``) with at most
    ``FMAP_STAGED_MAX_R`` ROIs an image is staged through shared memory,
    on the tensor cores for a bf16 map with C % 8 == 0 (``bf16-mma``), on
    the CUDA cores in f32 for an f32 map with C % 4 == 0 (``f32-staged``);
    any other map takes the unstaged CUDA-core gather (``f32-gather``,
    ``bf16-gather``)."""
    staged = g_ptr % 16 == 0 and R <= FMAP_STAGED_MAX_R
    if dtype == torch.bfloat16:
        return "bf16-mma" if staged and C % 8 == 0 else "bf16-gather"
    return "f32-staged" if staged and C % 4 == 0 else "f32-gather"


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


def roi_tile_lists(boxes: torch.Tensor, fmap_hw: Tuple[int, int], *,
                   spatial_scale: float, tile: Tuple[int, int] = FMAP_TILE,
                   pooled: int = 7, ratio: int = 2) -> List[List[List[int]]]:
    """Model of K1-bwd-fmap's tile lists: per image, per tile of ``tile``
    (rows, columns) map cells (row-major, ragged at the right and bottom
    edges), the ROIs in ascending order that have a tap of nonzero weight
    in one of the tile's rows and one in its columns, as the kernel's
    per-axis tile masks hold them (each sample's low and high tap where its
    weight is not 0; ``w / ratio`` is 0 only where ``w`` is)."""
    H, W = fmap_hw
    x1, y1, roi_w, roi_h = _box_frames(boxes.detach().cpu(), spatial_scale)
    hits = []
    for start, extent, dim, tile in ((y1, roi_h, H, tile[0]),
                                     (x1, roi_w, W, tile[1])):
        lo, hi, _, _, w_lo, w_hi = _axis_samples(start, extent, dim, pooled,
                                                 ratio)
        n = -(-dim // tile)
        hits.append(((F.one_hot(lo // tile, n) & (w_lo != 0)[..., None])
                     | (F.one_hot(hi // tile, n) & (w_hi != 0)[..., None])
                     ).any(-2))  # (B, R, tiles along the axis)
    rows, cols = hits
    return [[torch.nonzero(rows[b, :, ty] & cols[b, :, tx])[:, 0].tolist()
             for ty in range(rows.shape[-1]) for tx in range(cols.shape[-1])]
            for b in range(rows.shape[0])]


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


def roi_align_backward_reference(g: torch.Tensor, boxes: torch.Tensor,
                                 fmap_hw: Tuple[int, int],
                                 dtype: torch.dtype, *, spatial_scale: float,
                                 pooled: int = 7, ratio: int = 2,
                                 roi_chunk: int = 64) -> torch.Tensor:
    """Plain ``grad_fmap`` (B, H, W, C) in ``dtype`` from the output's
    gradient ``g`` (B, R, P, P, C): ``sgg_tpu/ops/roi_align_pallas.py:_bwd``,
    the two transposed interpolation products in f32
    (``brqw,brpqc->brpwc``, then ``brph,brpwc->bhwc``), over ROI chunks."""
    H, W = fmap_hw
    B, R = boxes.shape[:2]
    x1, y1, roi_w, roi_h = _box_frames(boxes, spatial_scale)
    Wy = _interp_weights(y1, roi_h, H, pooled, ratio)  # (B, R, P, H)
    Wx = _interp_weights(x1, roi_w, W, pooled, ratio)  # (B, R, P, W)
    grad = g.new_zeros((B, H, W, g.shape[-1]), dtype=torch.float32)
    for s in range(0, R, roi_chunk):
        g32 = g[:, s:s + roi_chunk].float()
        gy = torch.einsum("brqw,brpqc->brpwc", Wx[:, s:s + roi_chunk], g32)
        grad += torch.einsum("brph,brpwc->bhwc", Wy[:, s:s + roi_chunk], gy)
    return grad.to(dtype)


def _axis_samples(start: torch.Tensor, extent: torch.Tensor, dim: int,
                  pooled: int, ratio: int):
    """Per sample along one axis (..., S): the low and high tap; the
    derivative of the sample's bilinear weights in its coordinate, folded
    with the bin average (``1 / ratio``): 0 where the sample is invalid or
    capped, times ``jnp.clip``'s gradient at 0 (1 above, 1/2 at, 0 below);
    ``(i + 0.5) / S``, the coordinate's derivative in the extent; and the
    low and high tap's weights (0 where the sample is invalid)."""
    S = pooled * ratio
    i = torch.arange(S, dtype=torch.float32, device=start.device)
    frac_pos = (i + 0.5) / torch.full_like(i, S)
    y = start[..., None] + extent[..., None] * (i + 0.5) / torch.full_like(
        i, S)
    valid = (y >= -1.0) & (y <= dim)
    yc = y.clamp(min=0.0)
    y_low = torch.floor(yc).long()
    cap = y_low >= dim - 1
    y_low = torch.where(cap, torch.full_like(y_low, dim - 1), y_low)
    y_high = torch.where(cap, torch.full_like(y_low, dim - 1), y_low + 1)
    clip_grad = torch.where(y > 0, 1.0, torch.where(y == 0, 0.5, 0.0))
    dmask = torch.where(valid & ~cap, clip_grad, 0.0) / ratio
    zero = torch.zeros_like(yc)
    frac = torch.where(cap, zero, yc - y_low.float())
    w_low = torch.where(valid, 1.0 - frac, zero)
    w_high = torch.where(valid, frac, zero)
    return y_low, y_high, dmask, frac_pos, w_low, w_high


def _bin_slots(start, extent, dim: int, pooled: int, ratio: int):
    """Per bin (..., P, 2 ratio) the slots of its samples along one axis:
    sample s's low tap at slot 2 s and its high tap at 2 s + 1, unfolded
    (a tap whose weight is 0 keeps its slot), with the slots' weights
    divided by ``ratio``; and per sample (..., S) ``dmask`` and
    ``frac_pos`` of ``_axis_samples``."""
    lo, hi, dmask, frac_pos, w_lo, w_hi = _axis_samples(start, extent, dim,
                                                        pooled, ratio)
    shape = (*lo.shape[:-1], pooled, 2 * ratio)
    cells = torch.stack([lo, hi], -1).reshape(shape)
    weights = (torch.stack([w_lo, w_hi], -1) / ratio).reshape(shape)
    return cells, weights, dmask, frac_pos


def _floor_grad(raw: torch.Tensor) -> torch.Tensor:
    """Gradient of ``jnp.maximum(raw, 1.0)`` in ``raw``."""
    return torch.where(raw > 1.0, 1.0, torch.where(raw == 1.0, 0.5, 0.0))


def _chain_axis(d: torch.Tensor, frac_pos: torch.Tensor, raw: torch.Tensor):
    """d/d(low edge), d/d(high edge) of one axis from the samples'
    derivatives ``d`` (B, R, S), through ``y_i = start + extent (i + 0.5) /
    S`` and the floor of the extent at 1."""
    d_start = d.sum(-1)
    d_hi = (d * frac_pos).sum(-1) * _floor_grad(raw)
    return d_start - d_hi, d_hi


def roi_align_boxes_grad_reference(g: torch.Tensor, fmap: torch.Tensor,
                                   boxes: torch.Tensor, *,
                                   spatial_scale: float, pooled: int = 7,
                                   ratio: int = 2,
                                   roi_chunk: int = 64) -> torch.Tensor:
    """Plain ``grad_boxes`` (B, R, 4) f32: what XLA's autodiff of
    ``sgg_tpu/ops/roi_align.py:roi_align`` gives for the boxes, in f32, in
    K1-bwd-boxes' algebra.

    Per bin (p, q) and cell (a, b) of its slots (``_bin_slots``: the lo and
    hi row of each of its y samples times the lo and hi column of each of
    its x samples), ``D = sum_c g[p, q, c] f[row_a, col_b, c]``. Sample s
    of bin p along y then takes ``dmask * sum_q sum_b wx[q, b] (D[2 s + 1,
    b] - D[2 s, b])``, the same along x with the roles swapped; then
    through ``y_i = start + extent (i + 0.5) / S``, the floor of the extent
    at 1 and the spatial scale. The slots are unfolded: a sample on an
    integer coordinate has a high tap of weight 0 whose cell its derivative
    still needs."""
    B, H, W, C = fmap.shape
    R = boxes.shape[1]
    if R == 0:
        return boxes.new_zeros(boxes.shape, dtype=torch.float32)
    f32 = fmap.float().reshape(B, H * W, C)
    sb = boxes.float() * spatial_scale
    x1, y1 = sb[..., 0], sb[..., 1]
    raw_w, raw_h = sb[..., 2] - x1, sb[..., 3] - y1
    rows, wy, dmy, fy = _bin_slots(y1, raw_h.clamp(min=1.0), H, pooled,
                                   ratio)
    cols, wx, dmx, fx = _bin_slots(x1, raw_w.clamp(min=1.0), W, pooled,
                                   ratio)
    ty, tx = [], []
    for s in range(0, R, roi_chunk):
        sl = slice(s, s + roi_chunk)
        cells = (rows[:, sl, :, None, :, None] * W
                 + cols[:, sl, None, :, None, :])  # (B, r, P, P, 2ratio^2)
        fc = torch.gather(f32, 1, cells.reshape(B, -1, 1).expand(-1, -1, C))
        D = torch.einsum("brpqc,brpqaec->brpqae", g[:, sl].float(),
                         fc.reshape(*cells.shape, C))
        ty.append(torch.einsum("brpqse,brqe->brps",
                               D[..., 1::2, :] - D[..., 0::2, :], wx[:, sl]))
        tx.append(torch.einsum("brpqas,brpa->brqs",
                               D[..., 1::2] - D[..., 0::2], wy[:, sl]))
    dy1, dy2 = _chain_axis(torch.cat(ty, 1).reshape(B, R, -1) * dmy, fy,
                           raw_h)
    dx1, dx2 = _chain_axis(torch.cat(tx, 1).reshape(B, R, -1) * dmx, fx,
                           raw_w)
    return torch.stack([dx1, dy1, dx2, dy2], -1) * spatial_scale


def _check_card(fmap: torch.Tensor, boxes: torch.Tensor) -> None:
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_kernel(fmap, boxes, scale, pooled, ratio) -> torch.Tensor:
    B, H, W, C = fmap.shape
    R = boxes.shape[1]
    out = torch.empty((B, R, pooled, pooled, C), dtype=fmap.dtype,
                      device=fmap.device)
    KERNEL.launch(fmap.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W,
                  C, R, float(scale), pooled, ratio, _DTYPES[fmap.dtype],
                  _stream(fmap), route=ROUTES[fmap.dtype])
    return out


@functools.lru_cache(maxsize=64)
def fmap_workspace_layout(B: int, H: int, W: int, R: int,
                          pooled: int = 7) -> dict:
    """K1-bwd-fmap's workspace as its library lays it out: the tile's rows
    and columns of map cells, the tiles along y and x, its bytes, and the
    int32 word offsets of the tiles' lists (R words a tile, the first
    ``count`` used) and of the ROIs' tile masks; the tiles' counts are
    words 0 .. tiles - 1."""
    out = (ctypes.c_longlong * 7)()
    KERNEL_BWD_FMAP.helper("sgg_roi_align_bwd_fmap_layout",
                           [_I, _I, _I, _I, _I,
                            ctypes.POINTER(ctypes.c_longlong)])(
        B, H, W, R, pooled, out)
    return dict(zip(("tile_h", "tile_w", "nty", "ntx", "bytes", "lists",
                     "masks"), (int(v) for v in out)))


def fmap_tile_lists(workspace: torch.Tensor, layout: dict, B: int,
                    R: int) -> List[List[List[int]]]:
    """K1-bwd-fmap's tile lists as its list pass left them in
    ``workspace``, per image and tile: what ``roi_tile_lists`` models."""
    ws = workspace.cpu()
    nt = layout["nty"] * layout["ntx"]
    counts = ws[:B * nt].tolist()
    lists = ws[layout["lists"]:layout["lists"] + B * nt * R].view(B * nt, R)
    return [[lists[b * nt + t, :counts[b * nt + t]].tolist()
             for t in range(nt)] for b in range(B)]


def _grad_fmap_kernel(g, boxes, fmap_shape, dtype, scale, pooled, ratio,
                      workspace=None):
    """K1-bwd-fmap: the tile lists built on the card into an int32
    workspace (allocated here unless given, for a test to read; nothing in
    it needs clearing), then the gather writes the gradient in ``dtype``;
    the host waits for nothing. Each launch is counted by its route
    (``fmap_route``), in the kernel's ``routes`` and in the process's
    counter ``k1_bwd_fmap.<route>``."""
    B, H, W, C = fmap_shape
    R = boxes.shape[1]
    if workspace is None:
        workspace = torch.empty(
            -(-fmap_workspace_layout(B, H, W, R, pooled)["bytes"] // 4),
            dtype=torch.int32, device=g.device)
    grad = torch.empty((B, H, W, C), dtype=dtype, device=g.device)
    route = fmap_route(dtype, C, g.data_ptr(), R)
    KERNEL_BWD_FMAP.launch(
        g.data_ptr(), boxes.data_ptr(), workspace.data_ptr(),
        workspace.numel() * workspace.element_size(), grad.data_ptr(),
        B, H, W, C, R, float(scale), pooled, ratio, _DTYPES[dtype],
        _stream(g), route=route)
    counters.bump(f"k1_bwd_fmap.{route}")
    return grad


def _grad_boxes_kernel(g, fmap, boxes, scale, pooled, ratio):
    B, H, W, C = fmap.shape
    grad = torch.empty(boxes.shape, dtype=torch.float32, device=g.device)
    KERNEL_BWD_BOXES.launch(
        g.data_ptr(), fmap.data_ptr(), boxes.data_ptr(), grad.data_ptr(),
        B, H, W, C, boxes.shape[1], float(scale), pooled, ratio,
        _DTYPES[fmap.dtype], _stream(g), route=ROUTES[fmap.dtype])
    return grad


class _RoIAlign(torch.autograd.Function):
    """K1 and its backward kernels on the card, the plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, fmap, boxes, spatial_scale, pooled, ratio):
        ctx.args = (spatial_scale, pooled, ratio)
        ctx.fmap_shape, ctx.fmap_dtype = tuple(fmap.shape), fmap.dtype
        ctx.save_for_backward(fmap, boxes)
        n_out = boxes.shape[0] * boxes.shape[1] * pooled * pooled \
            * fmap.shape[-1]
        with kernel_flops(roi_align_flops(n_out, ratio)):
            if fmap.device.type == "cpu":
                return roi_align_reference(fmap, boxes,
                                           spatial_scale=spatial_scale,
                                           pooled=pooled, ratio=ratio)
            return _forward_kernel(fmap, boxes, spatial_scale, pooled,
                                   ratio)

    @staticmethod
    def backward(ctx, g):
        fmap, boxes = ctx.saved_tensors
        scale, pooled, ratio = ctx.args
        want_fmap, want_boxes = ctx.needs_input_grad[:2]
        n_out = g.numel()
        with kernel_flops(want_fmap * roi_align_flops(n_out, ratio)
                          + want_boxes * roi_align_boxes_grad_flops(n_out,
                                                                    ratio)):
            return _RoIAlign._backward(ctx, g, fmap, boxes, scale, pooled,
                                       ratio, want_fmap, want_boxes)

    @staticmethod
    def _backward(ctx, g, fmap, boxes, scale, pooled, ratio, want_fmap,
                  want_boxes):
        grad_fmap = grad_boxes = None
        if fmap.device.type == "cpu":
            if want_fmap:
                grad_fmap = roi_align_backward_reference(
                    g, boxes, ctx.fmap_shape[1:3], ctx.fmap_dtype,
                    spatial_scale=scale, pooled=pooled, ratio=ratio)
            if want_boxes:
                grad_boxes = roi_align_boxes_grad_reference(
                    g, fmap, boxes, spatial_scale=scale, pooled=pooled,
                    ratio=ratio)
            return grad_fmap, grad_boxes, None, None, None
        g = g.to(ctx.fmap_dtype).contiguous()
        if want_fmap:
            grad_fmap = _grad_fmap_kernel(g, boxes, ctx.fmap_shape,
                                          ctx.fmap_dtype, scale, pooled,
                                          ratio)
        if want_boxes:
            grad_boxes = _grad_boxes_kernel(g, fmap, boxes, scale, pooled,
                                            ratio)
        return grad_fmap, grad_boxes, None, None, None


def roi_align(fmap: torch.Tensor, boxes: torch.Tensor, *,
              spatial_scale: float, pooled: int = 7,
              ratio: int = 2) -> torch.Tensor:
    """(B, H, W, C) NHWC fmap + (B, R, 4) image-pixel boxes ->
    (B, R, P, P, C) in the fmap's type, differentiable in both inputs.

    On the CPU: the plain versions. On the card: K1 forward; backward K1-
    bwd-fmap where the map needs a gradient and K1-bwd-boxes where the
    boxes do (the fmap's gradient in its type, the boxes' in f32)."""
    if fmap.device.type != "cpu":
        _check_card(fmap, boxes)
    return _RoIAlign.apply(fmap, boxes, spatial_scale, pooled, ratio)
