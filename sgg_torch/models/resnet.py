"""ResNet50 + Feature Pyramid Network backbone, NHWC at the interfaces.

Counterpart of ``sgg_tpu/models/resnet.py`` (the torchvision
``maskrcnn_resnet50_fpn`` backbone the reference uses for non-VG splits,
``sgg_models/rel_model_base.py:58-81``): a bottleneck ResNet50 giving C2-C5,
an FPN with 256-channel lateral 1x1 convs, a top-down pathway of nearest
upsampling, 3x3 output convs (P2-P5) and the stride-64 ``pool`` level (a
1x1 max-pool of P5 at stride 2), which the RPN uses and the relation head
pools from.

Every BatchNorm uses its running statistics, as every call site of the JAX
package does (``train=False``; torchvision's FrozenBatchNorm): its
``weight`` and ``bias`` are parameters that detector pretraining trains,
its mean and variance buffers that nothing updates. The arithmetic is
flax's, in float32 whatever the compute type.

Module names follow the flax ones (``body.conv1``, ``body.layer{s}_{b}.
conv{1,2,3}``/``bn{1,2,3}``/``downsample``/``bn_down``,
``fpn.lateral_c{2..5}``, ``fpn.output_c{2..5}``), so
``convert.variables_from_jax`` maps a JAX ``ResNet50FPN`` onto the
``state_dict``. The convolutions are cuDNN's (the JAX package runs them
through XLA, outside any Pallas kernel), in ``compute_dtype`` over float32
weights cast at use; inside, the maps are NCHW views of channels-last
memory.

``multiscale_roi_align`` pools every ROI from each of P2-P5 with RoIAlign
(kernel K1 on the card) and keeps each ROI's level, four launches a
proposal set, as the JAX package does to keep its shapes static.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.models.backbone import normalize_images
from sgg_torch.models.union_features import BatchNorm
from sgg_torch.ops.roi_align import roi_align

FPN_CHANNELS = 256
RESNET50_BLOCKS = (3, 4, 6, 3)
RESNET50_WIDTHS = (64, 128, 256, 512)
LEVELS = ("p2", "p3", "p4", "p5", "pool")
STRIDES = (4, 8, 16, 32, 64)


class FrozenBatchNorm(BatchNorm):
    """flax ``nn.BatchNorm(use_running_average=True)`` in any mode:
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32 (or the
    input's type where it is wider), the result in the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        y = (xf - self.running_mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype):
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias,
                    stride=conv.stride, padding=conv.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x width) with frozen BatchNorms and a
    projection shortcut where the shape changes (a 1x1 conv at the stride:
    flax's "SAME" for a 1x1 kernel pads nothing)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.compute_dtype = torch.float32
        out = features * 4
        self.conv1 = nn.Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride,
                               padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        if in_ch != out or stride != 1:
            self.downsample = nn.Conv2d(in_ch, out, 1, stride=stride,
                                        bias=False)
            self.bn_down = FrozenBatchNorm(out)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.relu(self.bn1(_conv(self.conv1, x, dt)))
        y = F.relu(self.bn2(_conv(self.conv2, y, dt)))
        y = self.bn3(_conv(self.conv3, y, dt))
        residual = x if self.downsample is None else self.bn_down(
            _conv(self.downsample, x, dt))
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """Images (B, H, W, 3) -> {'c2': s4, 'c3': s8, 'c4': s16, 'c5': s32},
    NCHW views of channels-last maps in ``compute_dtype``."""

    def __init__(self):
        super().__init__()
        self.compute_dtype = torch.float32
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        c_in = 64
        for stage, (n, w) in enumerate(zip(RESNET50_BLOCKS,
                                           RESNET50_WIDTHS)):
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                self.add_module(f"layer{stage + 1}_{b}",
                                Bottleneck(c_in, w, stride))
                c_in = w * 4

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        dt = self.compute_dtype
        x = normalize_images(images).to(dt).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(_conv(self.conv1, x, dt)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        out = {}
        for stage, n in enumerate(RESNET50_BLOCKS):
            for b in range(n):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            out[f"c{stage + 2}"] = x
        return out


class FPN(nn.Module):
    """Lateral 1x1 convs, the top-down pathway (``jax.image.resize``'s
    nearest, which samples at ``floor((i + 0.5) * in / out)``: torch's
    ``nearest-exact``; ``nearest`` samples at ``floor(i * in / out)``),
    3x3 output convs and the ``pool`` level."""

    def __init__(self, channels: int = FPN_CHANNELS):
        super().__init__()
        self.compute_dtype = torch.float32
        for i, n in enumerate(("c2", "c3", "c4", "c5")):
            c_in = RESNET50_WIDTHS[i] * 4
            self.add_module(f"lateral_{n}", nn.Conv2d(c_in, channels, 1))
            self.add_module(f"output_{n}",
                            nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, feats: Dict[str, torch.Tensor],
                pool_only: bool = False) -> Dict[str, torch.Tensor]:
        """The pyramid {'p2'..'p5', 'pool'}; with ``pool_only`` just
        {'pool'}, from C5 alone (the top level takes nothing from below)."""
        dt = self.compute_dtype
        names = ("c5",) if pool_only else ("c2", "c3", "c4", "c5")
        lat = {n: _conv(getattr(self, f"lateral_{n}"), feats[n], dt)
               for n in names}
        for lo, hi in (("c4", "c5"), ("c3", "c4"), ("c2", "c3")):
            if lo in lat:
                lat[lo] = lat[lo] + F.interpolate(
                    lat[hi], size=lat[lo].shape[-2:], mode="nearest-exact")
        outs = {f"p{int(n[1])}": _conv(getattr(self, f"output_{n}"), lat[n],
                                       dt) for n in names}
        # torchvision LastLevelMaxPool: a 1x1 max-pool at stride 2
        outs["pool"] = F.max_pool2d(outs["p5"], 1, 2)
        if pool_only:
            return {"pool": outs["pool"]}
        return outs


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class ResNet50FPN(nn.Module):
    """Images (B, H, W, 3) -> the 256-channel pyramid {'p2'..'p5',
    'pool'}, NHWC; ``pool`` computes only the stride-64 level."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50()
        self.fpn = FPN()

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: _nhwc(v) for k, v in self.fpn(self.body(images)).items()}

    def pool(self, images: torch.Tensor) -> torch.Tensor:
        """The ``pool`` level alone (B, h, w, 256): the JAX relation model
        uses no other, and XLA drops what it does not use."""
        return _nhwc(self.fpn(self.body(images), pool_only=True)["pool"])


def set_compute_dtype(module: nn.Module, dtype: torch.dtype,
                      store: bool) -> None:
    """Compute every submodule that has a ``compute_dtype`` in ``dtype``;
    with ``store`` (a frozen module) also store the conv and dense weights
    in it, the BatchNorms staying float32 as flax keeps them."""
    for mod in module.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = dtype
        if store and isinstance(mod, (nn.Conv2d, nn.Linear)):
            mod.to(dtype)


def roi_level_assignment(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5,
                         canonical_scale: float = 224.0,
                         canonical_level: int = 4) -> torch.Tensor:
    """FPN paper eqn. 1 (torchvision LevelMapper): each box's level index,
    0-based from ``k_min``, int64."""
    boxes = boxes.detach().float()
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    s = torch.sqrt(w * h).clamp(min=1e-6)
    # divided by a tensor: by a Python number the card multiplies with the
    # rounded reciprocal, which can put a box on the next level
    k = torch.floor(canonical_level + torch.log2(
        s / torch.full_like(s, canonical_scale) + 1e-8))
    return (k.clamp(k_min, k_max) - k_min).long()


def multiscale_roi_align(pyramid: Sequence[torch.Tensor],
                         boxes: torch.Tensor, strides: Sequence[int],
                         pooled: int = 7, ratio: int = 2) -> torch.Tensor:
    """MultiScaleRoIAlign over P2-P5: every level pooled (one K1 launch a
    level on the card), each ROI kept from its own level.

    pyramid: (B, Hl, Wl, C) maps; boxes (B, R, 4) image pixels, float32.
    Differentiable in the maps and the boxes; an unselected level's rows
    get a zero gradient."""
    levels = roi_level_assignment(boxes)
    out = None
    for lvl, (fmap, stride) in enumerate(zip(pyramid, strides)):
        pooled_l = roi_align(fmap, boxes, spatial_scale=1.0 / stride,
                             pooled=pooled, ratio=ratio)
        sel = (levels == lvl)[..., None, None, None].to(pooled_l.dtype)
        out = pooled_l * sel if out is None else out + pooled_l * sel
    return out
