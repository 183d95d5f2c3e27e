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
package's default ``conv_strides=(16, 16)``). Only ``edge_model="motifs"`` is ported; the
``raw_boxes`` rasterizer needs ``grid_sample`` and comes later.

Both BatchNorms follow flax's ``nn.BatchNorm`` (``BatchNorm`` below), not
torch's: in train mode they normalize with the biased batch variance and
move their running statistics toward it at momentum 0.01
(``BATCHNORM_MOMENTUM``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.constants import BATCHNORM_MOMENTUM
from sgg_torch.ops.rects import draw_union_rects


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
    running statistics. ``sgg_tpu/models/union_features.py:89-97``.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = BATCHNORM_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
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
        if edge_model != "motifs":
            raise NotImplementedError(
                f"edge_model={edge_model!r} is not ported yet (needs "
                f"grid_sample); use 'motifs'")
        self.pooling_size = pooling_size
        self.dim = dim
        self.compute_dtype = torch.float32
        self.conv1 = nn.Conv2d(2, dim // 2, 7, stride=16, padding=3)
        self.bn1 = BatchNorm(dim // 2)
        self.conv2 = nn.Conv2d(dim // 2, dim, 3, stride=16, padding=1)
        self.bn2 = BatchNorm(dim)

    def forward(self, pair_boxes: torch.Tensor) -> torch.Tensor:
        """pair_boxes: (B, E, 8) subject+object boxes in image pixels.

        Returns (B, E, h, w, dim); h = w = 1 under the reference strides.
        """
        P = self.pooling_size * 4 - 1  # 27 (get_union_boxes.py:67)
        rects = draw_union_rects(pair_boxes, P) - 0.5  # (B, E, 2, P, P)
        B, E = rects.shape[:2]
        x = rects.reshape(B * E, 2, P, P)
        dt = self.compute_dtype
        x = self.bn1(F.relu(conv2d_in(self.conv1, x, dt)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.bn2(F.relu(conv2d_in(self.conv2, x, dt)))
        return x.permute(0, 2, 3, 1).reshape(B, E, x.shape[2], x.shape[3],
                                             self.dim)
