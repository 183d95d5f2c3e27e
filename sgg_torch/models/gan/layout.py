"""Layout composition: paint per-node features into their box locations.

Counterpart of ``sgg_tpu/models/gan/layout.py`` (reference
``augment/layout.py``, from google/sg2im): each node's spatial feature is
warped into its [0, 1] box on an H x W canvas by bilinear grid sampling and
summed (or averaged) over the image's nodes.

The sampling grid is affine and separable by axis, so painting is two
interpolation-weight products (``ops/grid_sample.py::paint_weights``), the
node mask folded into the column weights and the sum over nodes fused into
the second product: the (B, N, H, W, D) canvas of every node is never
materialized.
"""

from __future__ import annotations

import torch

from sgg_torch.ops.grid_sample import box01_extents, paint_weights


def boxes_to_layout(vecs: torch.Tensor, boxes01: torch.Tensor,
                    node_mask: torch.Tensor, H: int, W: int = None,
                    pooling: str = "sum") -> torch.Tensor:
    """(B, N, p, q, D) spatial node features (or (B, N, D), spread to 8 x 8
    as in the reference, layout.py:55-57), (B, N, 4) boxes in [0, 1] and
    the (B, N) node mask -> (B, H, W, D) canvases."""
    if W is None:
        W = H
    if pooling not in ("sum", "avg"):
        raise ValueError(pooling)
    if vecs.dim() == 3:
        vecs = vecs[:, :, None, None, :].expand(*vecs.shape[:2], 8, 8,
                                                 vecs.shape[-1])
    p, q = vecs.shape[2], vecs.shape[3]
    x0, y0, ww, hh = box01_extents(boxes01)
    dtype = vecs.dtype
    Wy = paint_weights(y0, hh, H, p).to(dtype)  # (B, N, H, p)
    Wx = paint_weights(x0, ww, W, q).to(dtype)  # (B, N, W, q)
    Wx = Wx * node_mask[..., None, None].to(dtype)
    t = torch.einsum("bnyp,bnpqc->bnyqc", Wy, vecs)
    out = torch.einsum("bnxq,bnyqc->byxc", Wx, t)
    if pooling == "avg":
        counts = torch.clamp(node_mask.sum(dim=1), min=1)
        out = out / counts[:, None, None, None].to(out.dtype)
    return out


def masks_to_layout(vecs: torch.Tensor, boxes01: torch.Tensor,
                    masks: torch.Tensor, node_mask: torch.Tensor, H: int,
                    W: int = None, pooling: str = "sum") -> torch.Tensor:
    """Mask-modulated variant (reference layout.py:74-99): (B, N, D)
    vectors times (B, N, M, M) binary masks, painted into their boxes."""
    img_in = vecs[:, :, None, None, :] * masks[..., None].to(vecs.dtype)
    return boxes_to_layout(img_in, boxes01, node_mask, H, W, pooling)
