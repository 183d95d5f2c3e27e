"""Union-box edge features: rasterized box-pair masks through a small conv.

Counterpart of ``sgg_tpu/models/union_features.py`` (reference
``UnionBoxesAndFeats``, ``lib/get_union_boxes.py:17-101``): the
subject/object boxes of each candidate edge are rasterized into a
``(2, 27, 27)`` mask pair shifted by -0.5, passed through conv 7x7 ->
ReLU -> BatchNorm -> maxpool 3/2 -> conv 3x3 -> ReLU -> BatchNorm, and
added to the RoIAligned union features.

Conv strides follow the reference's runtime behaviour: its ``conv_layer``
lambda names its stride parameter ``stide`` but passes the module's
feature-map stride (16), so both convs run at stride 16 and the 27x27
rects collapse to one 1x1 feature broadcast over the 7x7 pools (the JAX
package's default ``conv_strides=(16, 16)``).

Two rasterizers, as in the JAX package: ``edge_model="motifs"`` draws
each box in its union's frame (``ops/rects.py``); ``"raw_boxes"`` paints
each box in the whole image's [0, 1] frame (reference
``draw_union_boxes_grid``, ``get_union_boxes.py:105-116``): ``grid_sample``
of a constant image, which separates into per-axis coverage sums
(``ops/grid_sample.py``), so it needs each image's (height, width).

Both BatchNorms follow flax's ``nn.BatchNorm`` (``BatchNorm`` below), not
torch's: in train mode they normalize with the biased batch variance and
move their running statistics toward it at momentum 0.01
(``BATCHNORM_MOMENTUM``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.constants import BATCHNORM_MOMENTUM
from sgg_torch.ops.boxes import scale_boxes_01
from sgg_torch.ops.grid_sample import box01_extents, paint_weights
from sgg_torch.ops.rects import draw_union_rects
from sgg_torch.parallel import all_reduce, current

EDGE_MODELS = ("motifs", "raw_boxes")


def conv2d_in(layer: nn.Conv2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` (flax ``nn.Conv(dtype=dtype)``
    over float32 parameters), as one GEMM of the windows (strided views of
    the padded input) by the weight matrix.

    Not ``F.conv2d``: with a stride larger than its input, as here,
    PyTorch's CPU bf16 convolution returns a weight gradient with
    uninitialized entries (garbage up to inf, varying run to run). Not
    ``F.unfold`` either: on the card it launches a kernel per sample.
    """
    (kh, kw), (sh, sw), (ph, pw) = layer.kernel_size, layer.stride, \
        layer.padding
    xp = F.pad(x.to(dtype), (pw, pw, ph, ph))
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)  # (n, C, oh, ow, kh, kw)
    n, _, oh, ow = win.shape[:4]
    cols = win.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, -1)
    y = F.linear(cols, layer.weight.to(dtype).reshape(layer.out_channels, -1),
                 layer.bias.to(dtype))
    return y.reshape(n, oh, ow, -1).permute(0, 3, 1, 2)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``nn.BatchNorm`` arithmetic (its
    parameter and buffer names, so ``state_dict``s carry over).

    Statistics and the affine transform are computed in float32 and the
    result is returned in the input's type, as flax does for a bf16 layer.
    Train mode: ``var = max(E[x^2] - E[x]^2, 0)`` over N, H, W (the biased
    variance), used to normalize and folded into the running statistics as
    ``(1 - m) * running + m * batch``, ``m = momentum``. Eval mode: the
    running statistics. ``sgg_tpu/models/union_features.py:89-97``. Under
    a data-parallel group the batch moments are those of the global batch
    (a differentiable all-reduce of the ranks'), so the running statistics
    stay equal on every rank, as flax's over the global array.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = BATCHNORM_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            sq = (xf * xf).mean(dim=(0, 2, 3))
            group = current()
            if group is not None:
                # every rank holds as many rows: the global moments are
                # the means of the ranks' over the world
                mean, sq = (all_reduce(torch.stack([mean, sq]))
                            / group.world).unbind()
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class UnionBoxFeats(nn.Module):
    """rects conv branch; call with pair boxes, add the result to the
    union pools. Computes in ``compute_dtype`` from float32 weights."""

    def __init__(self, dim: int = 512, pooling_size: int = 7,
                 edge_model: str = "motifs"):
        super().__init__()
        if edge_model not in EDGE_MODELS:
            raise ValueError(f"edge_model {edge_model!r} not in "
                             f"{EDGE_MODELS}")
        self.edge_model = edge_model
        self.pooling_size = pooling_size
        self.dim = dim
        self.compute_dtype = torch.float32
        self.conv1 = nn.Conv2d(2, dim // 2, 7, stride=16, padding=3)
        self.bn1 = BatchNorm(dim // 2)
        self.conv2 = nn.Conv2d(dim // 2, dim, 3, stride=16, padding=1)
        self.bn2 = BatchNorm(dim)

    def forward(self, pair_boxes: torch.Tensor,
                im_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pair_boxes: (B, E, 8) subject+object boxes in image pixels;
        ``im_hw`` (B, 2), each image's (height, width), which
        ``raw_boxes`` needs.

        Returns (B, E, h, w, dim); h = w = 1 under the reference strides.
        """
        P = self.pooling_size * 4 - 1  # 27 (get_union_boxes.py:67)
        B, E = pair_boxes.shape[:2]
        if self.edge_model == "raw_boxes":
            if im_hw is None:
                raise ValueError("edge_model='raw_boxes' needs each image's "
                                 "(height, width): pass im_hw")
            boxes01 = scale_boxes_01(pair_boxes.reshape(B, E * 2, 4),
                                     im_hw.float())
            x0, y0, ww, hh = box01_extents(boxes01)
            vy = paint_weights(y0, hh, P, P).sum(-1)  # (B, 2E, P)
            vx = paint_weights(x0, ww, P, P).sum(-1)
            masks = vy[..., :, None] * vx[..., None, :]
            rects = masks.reshape(B, E, 2, P, P) - 0.5
        else:
            rects = draw_union_rects(pair_boxes, P) - 0.5  # (B, E, 2, P, P)
        x = rects.reshape(B * E, 2, P, P)
        dt = self.compute_dtype
        x = self.bn1(F.relu(conv2d_in(self.conv1, x, dt)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.bn2(F.relu(conv2d_in(self.conv2, x, dt)))
        return x.permute(0, 2, 3, 1).reshape(B, E, x.shape[2], x.shape[3],
                                             self.dim)
