"""Trunk deep-dive: where the VGG16 trunk's time goes, layer by layer, and
whether another conv1_1 moves it.

    python -m sgg_torch.tools.profile_trunk [--batch 24 --img 592]
        [--iters 10] [--quick] [--layers-only] [-device cpu --tiny]

Counterpart of ``tools/profile_trunk.py``, on the card in bf16:

1. ms, TF/s and MFU of each layer of the port's trunk as a frozen trunk
   runs it (normalize, conv1_1 = K2, then the twelve bias-less cuDNN
   convs, each with its epilogue pass: bias and ReLU, and the max-pool
   where one follows), each timed directly on its own input (eager
   PyTorch runs layer by layer, so XLA's cumulative-prefix differences
   are not needed); then, on each of those twelve convs' outputs, the
   epilogue alone three ways: the kernel (``epilogue <conv>``), its plain
   version (``plain <conv>``) and PyTorch's chain that the trunk ran
   before it, ``add_`` of the bias, ``relu`` and ``max_pool2d``
   (``library <conv>``), with each one's byte bound; ``--quick`` skips
   it;
2. the whole trunk at a third, one and two times ``--batch`` (8, 24
   and 48);
3. conv1_1 variants as whole-trunk replacements, each against the
   baseline's output: the baseline is K2 (``ops/vgg_stem.py``, NHWC in
   and out, which the other convs see as channels-last memory);
   ``channel_pad8`` (the input padded to 8 channels), ``im2col``
   (``F.unfold`` and one 27 x 64 product), ``im2col_manual`` (nine shifted
   slices concatenated, one product), ``fold_norm`` (the uint8
   normalization folded into conv1_1's weights and bias; the border taps
   differ, as in the JAX tool) and ``cudnn`` (cuDNN's ``conv2d`` + ReLU).
   Every variant hands conv1_2 a channels-last map, as K2 does;
4. the layout sweep of conv1_1 and conv1_2 through cuDNN at the trunk's
   shape: NCHW-contiguous against channels-last memory.

``--layers-only`` runs the baseline and the per-layer table. ``--tiny``
is accepted for the CPU tests' sake and changes nothing (the trunk has
no narrow form). The last line is the JSON object of
``StageProfiler.line`` (stages: ``baseline``, ``layer <name>``, ``batch
B=<n>``, ``variant <name>``, ``layout <conv> <layout>``, ``epilogue
<conv>``, ``plain <conv>``, ``library <conv>``), with each variant's
error against the baseline and each epilogue's bytes
(``epilogue_bytes``: the conv's output read once, the epilogue's output
written once) and its bound on the card (``epilogue_bound_ms``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sgg_torch.device import resolve_device
from sgg_torch.models.backbone import (IMAGENET_MEAN, IMAGENET_STD,
                                       POOL_AFTER, VGG16_CFG, VGG16Trunk,
                                       normalize_images)
from sgg_torch.models.relhead import init_weights
from sgg_torch.models.resnet import set_compute_dtype
from sgg_torch.ops.conv_epilogue import (conv_epilogue,
                                         conv_epilogue_reference)
from sgg_torch.ops.vgg_stem import vgg_conv1
from sgg_torch.tools import _common
from sgg_torch.utils.profiling import StageProfiler, past_l2

BF16 = torch.bfloat16
VARIANTS = ("channel_pad8", "im2col", "im2col_manual", "fold_norm", "cudnn")
LAYOUTS = ("nchw", "channels_last")


def batch_sweep(batch: int) -> Tuple[int, int, int]:
    """A third, one and two times ``batch``: 8, 24 and 48 at the
    default."""
    return max(batch // 3, 1), batch, 2 * batch


def layer_names() -> List[str]:
    """conv1_1, then each cuDNN conv, named with the pool its epilogue
    takes: ``conv1_2 (64) + pool1``."""
    names, block, k = [], 1, 1
    for v in VGG16_CFG:
        if v == "M":
            names[-1] += f" + pool{block}"
            block, k = block + 1, 1
        else:
            names.append(f"conv{block}_{k} ({v})")
            k += 1
    return names


def _stem_args(trunk: VGG16Trunk):
    stem = trunk.conv[0]
    return stem.weight.permute(2, 3, 1, 0), stem.bias


def _convs(trunk: VGG16Trunk) -> List[Tuple[torch.nn.Conv2d, bool]]:
    """The twelve cuDNN convs, each with whether a pool follows it."""
    return list(zip(list(trunk.conv)[1:], POOL_AFTER[1:]))


def _bare_conv(conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` without its bias on an NCHW view of channels-last memory:
    its NHWC output."""
    return F.conv2d(x, conv.weight, None, padding=1).permute(0, 2, 3, 1)


def _library(y: torch.Tensor, b: torch.Tensor, pool: bool) -> torch.Tensor:
    """PyTorch's chain after cuDNN's conv on the NHWC output ``y``, as the
    trunk ran it before the epilogue: the bias ``add_`` that
    ``F.conv2d`` issues after cuDNN's kernel, ``relu``, ``max_pool2d``."""
    x = y.permute(0, 3, 1, 2)
    x.add_(b.to(x.dtype).reshape(1, -1, 1, 1))
    x = F.relu(x)
    return F.max_pool2d(x, 2, 2) if pool else x


def layers(trunk: VGG16Trunk) -> List[Tuple[str, Callable]]:
    """The trunk as its layers, in order, as ``VGG16Trunk.forward`` runs a
    frozen trunk: ``normalize``, conv1_1 (K2), then each bias-less cuDNN
    conv with its epilogue; each maps the previous one's output (NCHW
    views of channels-last memory after conv1_1) to its own."""
    w, b = _stem_args(trunk)
    out = [("normalize",
            lambda x: normalize_images(x).to(BF16).contiguous())]
    names = layer_names()
    out.append((names[0], lambda x: vgg_conv1(x, w, b).permute(0, 3, 1, 2)))
    for name, (conv, pool) in zip(names[1:], _convs(trunk)):
        out.append((name, lambda x, c=conv, p=pool: conv_epilogue(
            _bare_conv(c, x), c.bias, p).permute(0, 3, 1, 2)))
    return out


def _tail(trunk: VGG16Trunk, y: torch.Tensor) -> torch.Tensor:
    """conv1_2 .. conv5_3 on conv1_1's output ``y`` (NCHW, channels-last
    memory), as the trunk runs them; NHWC out."""
    for _, fn in layers(trunk)[2:]:
        y = fn(y)
    return y.permute(0, 2, 3, 1).contiguous()


def _norm(x: torch.Tensor) -> torch.Tensor:
    return normalize_images(x).to(BF16)


def _conv1(x_nchw: torch.Tensor, w_oihw: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    y = F.relu(F.conv2d(x_nchw.contiguous(memory_format=torch.channels_last),
                        w_oihw, b, padding=1))
    return y.contiguous(memory_format=torch.channels_last)


def variants(trunk: VGG16Trunk) -> Dict[str, Callable]:
    """conv1_1 replacements (uint8 NHWC canvases -> the trunk's output)."""
    stem = trunk.conv[0]
    w = stem.weight.float()  # (64, 3, 3, 3) OIHW
    b = stem.bias.float()
    w16, b16 = w.to(BF16), b.to(BF16)

    def channel_pad8(x):
        xn = F.pad(_norm(x), (0, 5)).permute(0, 3, 1, 2)
        return _tail(trunk, _conv1(xn, F.pad(w16, (0, 0, 0, 0, 0, 5)), b16))

    def im2col(x):
        xn = _norm(x).permute(0, 3, 1, 2)
        B, _, H, W = xn.shape
        cols = F.unfold(xn, 3, padding=1)  # (B, 27, H W), (c, dy, dx)
        y = cols.transpose(1, 2) @ w16.reshape(64, 27).t()
        y = F.relu(y + b16).view(B, H, W, 64).permute(0, 3, 1, 2)
        return _tail(trunk, y)

    def im2col_manual(x):
        xn = _norm(x)
        B, H, W, _ = xn.shape
        xp = F.pad(xn, (0, 0, 1, 1, 1, 1))
        patches = torch.cat([xp[:, dy:dy + H, dx:dx + W]
                             for dy in range(3) for dx in range(3)], -1)
        wm = w16.permute(2, 3, 1, 0).reshape(27, 64)  # (dy, dx, c) rows
        y = F.relu(patches @ wm + b16).permute(0, 3, 1, 2)
        return _tail(trunk, y)

    mean = torch.tensor(IMAGENET_MEAN, device=w.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=w.device) * 255.0
    w_f = w / std[None, :, None, None]
    b_f = (b - (w_f * mean[None, :, None, None]).sum((1, 2, 3)))

    def fold_norm(x):
        xr = x.to(BF16).permute(0, 3, 1, 2)  # raw uint8 -> bf16
        return _tail(trunk, _conv1(xr, w_f.to(BF16), b_f.to(BF16)))

    def cudnn(x):
        return _tail(trunk, _conv1(_norm(x).permute(0, 3, 1, 2), w16, b16))

    return {"channel_pad8": channel_pad8, "im2col": im2col,
            "im2col_manual": im2col_manual, "fold_norm": fold_norm,
            "cudnn": cudnn}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = _common.parser(__doc__, 24, 40, 256, 592)
    ap.add_argument("--quick", action="store_true",
                    help="skip the per-layer table")
    ap.add_argument("--layers-only", action="store_true",
                    help="only the baseline and the per-layer table")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, IMG = args.batch, args.img
    rng = np.random.RandomState(0)

    def canvases(n):
        return torch.from_numpy(rng.randint(0, 256, (n, IMG, IMG, 3),
                                            dtype=np.uint8)).to(dev)

    trunk = init_weights(VGG16Trunk(), 0).requires_grad_(False)
    set_compute_dtype(trunk, BF16, store=True)
    trunk = trunk.to(dev)
    x = canvases(B)
    prof = StageProfiler("profile_trunk", dev, iters=args.iters, batch=B)
    errors = {}
    with torch.no_grad():
        ref = prof.stage("baseline", lambda: trunk(x)).float()
        for bsz in () if args.layers_only else batch_sweep(B):
            xb = canvases(bsz)
            prof.batch = bsz
            prof.stage(f"batch B={bsz}", lambda: trunk(xb),
                       iters=max(3, args.iters // 2))
            del xb
        prof.batch = B
        if not args.layers_only:
            for name, fn in variants(trunk).items():
                got = prof.stage(f"variant {name}", lambda: fn(x)).float()
                errors[name] = float((got - ref).abs().max()
                                     / ref.abs().max().clamp(min=1e-30))
                print(f"  {name}: rel err against the baseline "
                      f"{errors[name]:.4g}", flush=True)
                del got
            layout_sweep(prof, trunk, x, args)
        bytes_, bound = {}, {}
        if not args.quick:
            h = x
            for name, fn in layers(trunk):
                h = prof.stage(f"layer {name}", lambda: fn(h))
            bytes_, bound = epilogues(prof, trunk, x)
    return prof.line(sizes=vars(args), dtype="bfloat16",
                     variant_rel_err=errors, epilogue_bytes=bytes_,
                     epilogue_bound_ms=bound)


def epilogues(prof, trunk, x) -> Tuple[Dict, Dict]:
    """On each cuDNN conv's bias-less output, the epilogue as the kernel,
    its plain version and PyTorch's chain (all three update or read that
    output in place, so each call sees the last one's map: the bytes are
    the same), each call on the next of copies that together outgrow the
    card's L2 (``past_l2``: a small map is read from HBM, as in the trunk);
    returns each conv's bytes and its bound in ms on the card (None on the
    CPU)."""
    bytes_, bound = {}, {}
    (_, norm), (_, stem) = layers(trunk)[:2]
    h = stem(norm(x))
    for name, (conv, pool) in zip(layer_names()[1:], _convs(trunk)):
        y = _bare_conv(conv, h)
        B, H, W, C = y.shape
        written = B * (H // 2) * (W // 2) * C if pool else y.numel()
        bytes_[name] = (y.numel() + written) * y.element_size()
        bound[name] = (bytes_[name] / prof.peaks[0] * 1e3
                       if prof.peaks else None)
        maps = past_l2(y)
        for kind, fn in (("epilogue", conv_epilogue),
                         ("plain", conv_epilogue_reference),
                         ("library", _library)):
            prof.stage(f"{kind} {name}",
                       lambda f=fn: f(maps(), conv.bias, pool), flops=False)
        h = conv_epilogue(_bare_conv(conv, h), conv.bias,
                          pool).permute(0, 3, 1, 2)
        del y, maps
    return bytes_, bound


def layout_sweep(prof, trunk, x, args) -> None:
    """conv1_1 (3 -> 64) and conv1_2 (64 -> 64) at the trunk's shape
    through cuDNN, on NCHW-contiguous inputs and on channels-last ones."""
    it = max(3, args.iters // 2)
    x1 = _norm(x).permute(0, 3, 1, 2)
    w1 = trunk.conv[0].weight.to(BF16)
    x2 = _conv1(x1, w1, trunk.conv[0].bias.to(BF16))
    w2, b2 = trunk.conv[1].weight, trunk.conv[1].bias
    for conv, xin, w, b in (("conv1_1", x1, w1, None),
                            ("conv1_2", x2, w2, b2)):
        for layout in LAYOUTS:
            fmt = (torch.contiguous_format if layout == "nchw"
                   else torch.channels_last)
            xi = xin.contiguous(memory_format=fmt)
            wi = w.contiguous(memory_format=fmt)
            prof.stage(f"layout {conv} {layout}",
                       lambda: F.conv2d(xi, wi, b, padding=1), iters=it)
            del xi


if __name__ == "__main__":
    main()
