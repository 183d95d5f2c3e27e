"""Backbone feature extractors (NHWC at the interfaces).

Counterpart of ``sgg_tpu/models/backbone.py`` (reference torchvision
backbone assembly, ``sgg_models/rel_model_base.py:83-117``): a VGG16
convolutional trunk with the final maxpool removed (stride-16 feature maps,
512 channels), and the 4096-d fully-connected RoI heads cloned from the VGG
classifier (``rel_model_base.py:110-111``, ``load_vgg`` ``:310-321``).

The trunk's first conv is the CUDA kernel K2 (``ops/vgg_stem.py``); it
returns channels-last activations, which the other twelve convs (cuDNN)
keep, so the trunk's NHWC output needs no copy.

Mixed precision follows flax's ``dtype=`` layers: the modules keep
float32 weights and compute in their ``compute_dtype``, casting input,
weight and bias at use (``linear_in``, ``VGG16Trunk``), so gradients and
optimizer updates land on float32 master weights. A frozen trunk may be
stored in the compute type itself, which is the same as casting at use.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.ops.vgg_stem import vgg_conv1

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def linear_in(layer: nn.Linear, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``: input, weight and bias cast at
    use (flax ``nn.Dense(dtype=dtype)`` over float32 parameters)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode keep each element with probability
    ``1 - p`` and scale the kept ones by ``1 / (1 - p)``.

    The mask is drawn with ``torch.rand`` from the ``generator`` passed to
    ``forward`` (on the input's device), so a seeded generator repeats a
    step exactly; without one it comes from the device's default
    generator. The JAX package draws other bits: the two agree in law,
    not element by element, and parity tests set ``p = 0``.
    """

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


_NORM: dict = {}


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization for raw uint8 batches; float inputs are
    taken as already normalized by the host pipeline. The f32 mean and
    std (times 255) reach a device once: a copy from the host in every
    step would wait for the card."""
    if x.dtype != torch.uint8:
        return x
    if x.device not in _NORM:
        _NORM[x.device] = tuple(
            (torch.tensor(v) * 255.0).to(x.device)
            for v in (IMAGENET_MEAN, IMAGENET_STD))
    mean, std = _NORM[x.device]
    return (x.float() - mean) / std


# torchvision vgg16.features channel plan; 'M' = 2x2 maxpool
# (the final 'M' of VGG16 is removed, rel_model_base.py:312).
VGG16_CFG: Sequence[Any] = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                            512, 512, 512, "M", 512, 512, 512)


class VGG16Trunk(nn.Module):
    """VGG16 conv trunk: (B, H, W, 3) -> (B, H/16, W/16, 512), NHWC,
    computed in ``compute_dtype`` (weights and biases cast at use, so a
    trunk that trains keeps float32 master weights; the stem, K2, rounds
    its weights itself)."""

    def __init__(self):
        super().__init__()
        self.compute_dtype = torch.float32
        convs, c_in = [], 3
        for v in VGG16_CFG:
            if v != "M":
                convs.append(nn.Conv2d(c_in, v, 3, padding=1))
                c_in = v
        self.conv = nn.ModuleList(convs)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        x = normalize_images(images).to(dtype).contiguous()
        stem = self.conv[0]
        # K2: NHWC in, NHWC out; viewed as NCHW it is channels-last memory
        x = vgg_conv1(x, stem.weight.permute(2, 3, 1, 0), stem.bias)
        x = x.permute(0, 3, 1, 2)
        i = 1
        for v in VGG16_CFG[1:]:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                conv = self.conv[i]
                x = F.relu(F.conv2d(x, conv.weight.to(dtype),
                                    conv.bias.to(dtype), padding=1))
                i += 1
        return x.permute(0, 2, 3, 1).contiguous()


class RoiHead(nn.Module):
    """VGG classifier head over flattened P x P x C RoI features.

    ``with_final_relu=True`` is ``roi_fmap_obj`` (fc6-relu-drop-fc7-relu-
    drop); ``False`` is ``roi_fmap`` for edges (fc6-relu-drop-fc7,
    rel_model_base.py:310-321). The flatten order is HWC, as in the JAX
    package, so ``fc6.weight`` is the transposed flax kernel.

    ``gather_idx`` expands a deduplicated fc6 output back to every ordered
    edge slot; ``broadcast_add`` adds a per-edge vector that is constant
    over the pool window through ``v @ sum_spatial(fc6.weight)`` — fc6 is
    linear before its ReLU, so ``fc6(pool + bcast(v)) == fc6(pool) + v @
    K_sum`` (``sgg_tpu/models/backbone.py:RoiHead``).

    Dropout (rate 0.5, train mode only) draws its masks from ``generator``
    (see ``Dropout``).
    """

    def __init__(self, in_dim: int, out_dim: int = 4096,
                 with_final_relu: bool = False):
        super().__init__()
        self.compute_dtype = torch.float32
        self.fc6 = nn.Linear(in_dim, out_dim)
        self.fc7 = nn.Linear(out_dim, out_dim)
        self.drop = Dropout(0.5)
        self.with_final_relu = with_final_relu

    def forward(self, x: torch.Tensor, *,
                gather_idx: Optional[torch.Tensor] = None,
                broadcast_add: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.compute_dtype
        x = linear_in(self.fc6, x.reshape(*x.shape[:-3], -1), dtype)
        if gather_idx is not None:  # (B, U, out) -> (B, E, out)
            x = torch.gather(
                x, 1, gather_idx[..., None].expand(*gather_idx.shape,
                                                   x.shape[-1]))
        if broadcast_add is not None:
            c = broadcast_add.shape[-1]
            out_dim = self.fc6.out_features
            k_sum = self.fc6.weight.reshape(out_dim, -1, c).sum(1)  # (out, C)
            x = x + broadcast_add.to(dtype) @ k_sum.t().to(dtype)
        x = self.drop(F.relu(x), generator)
        x = linear_in(self.fc7, x, dtype)
        if self.with_final_relu:
            x = self.drop(F.relu(x), generator)
        return x
