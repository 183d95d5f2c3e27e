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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.ops.rects import draw_union_rects


class UnionBoxFeats(nn.Module):
    """rects conv branch; call with pair boxes, add the result to the
    union pools. BatchNorm runs on its running statistics (eval mode)."""

    def __init__(self, dim: int = 512, pooling_size: int = 7,
                 edge_model: str = "motifs"):
        super().__init__()
        if edge_model != "motifs":
            raise NotImplementedError(
                f"edge_model={edge_model!r} is not ported yet (needs "
                f"grid_sample); use 'motifs'")
        self.pooling_size = pooling_size
        self.dim = dim
        self.conv1 = nn.Conv2d(2, dim // 2, 7, stride=16, padding=3)
        self.bn1 = nn.BatchNorm2d(dim // 2, eps=1e-5)
        self.conv2 = nn.Conv2d(dim // 2, dim, 3, stride=16, padding=1)
        self.bn2 = nn.BatchNorm2d(dim, eps=1e-5)

    def forward(self, pair_boxes: torch.Tensor) -> torch.Tensor:
        """pair_boxes: (B, E, 8) subject+object boxes in image pixels.

        Returns (B, E, h, w, dim); h = w = 1 under the reference strides.
        """
        P = self.pooling_size * 4 - 1  # 27 (get_union_boxes.py:67)
        rects = draw_union_rects(pair_boxes, P) - 0.5  # (B, E, 2, P, P)
        B, E = rects.shape[:2]
        x = rects.reshape(B * E, 2, P, P).to(self.conv1.weight.dtype)
        x = self.bn1(F.relu(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.bn2(F.relu(self.conv2(x)))
        return x.permute(0, 2, 3, 1).reshape(B, E, x.shape[2], x.shape[3],
                                             self.dim)
