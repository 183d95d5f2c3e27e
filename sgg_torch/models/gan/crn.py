"""Cascaded Refinement Network (Chen & Koltun, ICCV 2017).

Counterpart of ``sgg_tpu/models/gan/crn.py`` (reference ``augment/crn.py``,
from google/sg2im): a stack of modules, each upsampling the running
features (nearest) and refining them with convolutions conditioned on the
layout pooled to the current resolution, then a 3x3 output conv. The GAN
generator uses it to grow the composed layout into a fake feature map.

NHWC at the interface, as the JAX module; NCHW inside. The BatchNorms
carry flax ``nn.BatchNorm``'s arithmetic (``models/union_features.py::
BatchNorm``) at torch's momentum 0.1 (flax's 0.9).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.models.union_features import BatchNorm


def _adaptive_pool_matrix(n_in: int, n_out: int, like: torch.Tensor
                          ) -> torch.Tensor:
    """(n_out, n_in) in ``like``'s type and device, built there (no copy
    from the host): row i averages input bin [floor(i In / Out),
    ceil((i + 1) In / Out)), torch ``adaptive_avg_pool2d``'s binning, each
    weight ``1 / (e - s)`` in float32."""
    i = torch.arange(n_out, device=like.device)
    s = (i * n_in) // n_out
    e = -(-((i + 1) * n_in) // n_out)
    j = torch.arange(n_in, device=like.device)
    inside = (j[None] >= s[:, None]) & (j[None] < e[:, None])
    w = 1.0 / (e - s).float()
    return torch.where(inside, w[:, None], 0.0).to(like.dtype)


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``adaptive_avg_pool2d`` of an NCHW map as two bin-average products,
    rows first (the JAX package's order)."""
    H, W = out_hw
    if x.shape[-2] == H and x.shape[-1] == W:
        return x
    ph = _adaptive_pool_matrix(x.shape[-2], H, x)
    pw = _adaptive_pool_matrix(x.shape[-1], W, x)
    x = torch.einsum("oh,...hw->...ow", ph, x)
    return torch.einsum("pw,...ow->...op", pw, x)


def upsample_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch's legacy nearest upsampling of an NCHW map (``mode="nearest"``,
    not ``"nearest-exact"``): ``out[i] = in[floor(i * In / Out)]``."""
    H, W = out_hw
    ih = (torch.arange(H, device=x.device) * x.shape[-2]) // H
    iw = (torch.arange(W, device=x.device) * x.shape[-1]) // W
    return x.index_select(-2, ih).index_select(-1, iw)


class RefinementModule(nn.Module):
    """conv-BN-LeakyReLU twice over [pooled layout, upsampled features]
    (reference crn.py:64-94)."""

    def __init__(self, layout_dim: int, input_dim: int, output_dim: int,
                 negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.conv0 = nn.Conv2d(layout_dim + input_dim, output_dim, 3,
                               padding=1)
        self.bn0 = BatchNorm(output_dim, momentum=0.1)
        self.conv1 = nn.Conv2d(output_dim, output_dim, 3, padding=1)
        self.bn1 = BatchNorm(output_dim, momentum=0.1)

    def forward(self, layout: torch.Tensor, feats: torch.Tensor
                ) -> torch.Tensor:
        layout = adaptive_avg_pool(layout, feats.shape[-2:])
        x = torch.cat([layout, feats], dim=1)
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            x = F.leaky_relu(bn(conv(x)), self.negative_slope)
        return x


class RefinementNetwork(nn.Module):
    """The CRN cascade (reference crn.py:97-143): ``dims[0]`` is the
    layout's channels, ``dims[1:]`` each stage's output channels."""

    def __init__(self, dims: Sequence[int] = (64, 128, 256, 512),
                 negative_slope: float = 0.2):
        super().__init__()
        self.n_stages = len(dims) - 1
        in_dim = 1  # the stages start from a one-channel map of zeros
        for i in range(self.n_stages):
            self.add_module(f"mod{i}", RefinementModule(
                dims[0], in_dim, dims[i + 1], negative_slope))
            in_dim = dims[i + 1]
        self.output_conv = nn.Conv2d(dims[-1], dims[-1], 3, padding=1)

    def forward(self, layout: torch.Tensor) -> torch.Tensor:
        """(B, H, W, dims[0]) NHWC layout -> (B, H, W, dims[-1])."""
        B, H, W, _ = layout.shape
        in_h, in_w = H >> self.n_stages, W >> self.n_stages
        if in_h <= 0 or in_w <= 0:
            raise ValueError(f"a {H}x{W} layout is too small for "
                             f"{self.n_stages} stages")
        layout = layout.permute(0, 3, 1, 2)
        feats = layout.new_zeros((B, 1, in_h, in_w))
        for i in range(self.n_stages):
            out_hw = (H, W) if i == self.n_stages - 1 else \
                (feats.shape[-2] * 2, feats.shape[-1] * 2)
            feats = getattr(self, f"mod{i}")(
                layout, upsample_nearest(feats, out_hw))
        return self.output_conv(feats).permute(0, 2, 3, 1)
