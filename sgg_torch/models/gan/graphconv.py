"""Scene-graph triple convolution (sg2im-style) over padded batches.

Counterpart of ``sgg_tpu/models/gan/graphconv.py`` (reference
``augment/graphconv.py``, itself from google/sg2im): each layer runs a
per-triplet MLP over ``[subj, pred, obj]`` concatenations, splits its output
into subject, predicate and object updates, and pools the subject and
object updates back onto the nodes.

Inputs are padded ``(B, N, D)`` nodes and ``(B, E, D)`` predicates with
masks. The reference's ``scatter_add`` pooling (``graphconv.py:97-106``) is
a per-image one-hot incidence product; BatchNorm statistics are taken over
the valid elements only (``MaskedBatchNorm``), since padding would bias
them. Module and parameter names follow the flax modules
(``gconv_{i}.net1.Dense_{j}``, ``MaskedBatchNorm_{j}``), so
``convert.variables_from_jax`` carries weights over.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgg_torch.parallel.mesh import all_reduce, all_reduce_scalars


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid elements of (..., C) inputs, with flax's
    momentum convention (``running = m * running + (1 - m) * batch``, m
    0.9: torch's 0.1).

    Train mode normalizes with the biased variance of the valid elements
    and folds the unbiased ``n / (n - 1)`` one into the running variance,
    as torch's ``BatchNorm1d`` tracks it (``sgg_tpu/models/gan/
    graphconv.py:40-55``); eval mode normalizes with the running
    statistics. Computes in float32."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            m = mask.float()[..., None]
            # under a data-parallel group: the global batch's masked
            # moments, from sums and counts all-reduced over the ranks
            # (each rank holds its own number of valid elements)
            n = torch.clamp(all_reduce_scalars(m.sum())[0], min=1.0)
            mean = all_reduce((x * m).sum(dim=dims)) / n
            var = all_reduce((((x - mean) ** 2) * m).sum(dim=dims)) / n
            with torch.no_grad():
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                mo = self.momentum
                self.running_mean.copy_(mo * self.running_mean
                                        + (1 - mo) * mean)
                self.running_var.copy_(mo * self.running_var
                                       + (1 - mo) * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight + self.bias


class TripleMLP(nn.Module):
    """``build_mlp`` (reference graphconv.py:157-176) with masked
    BatchNorms: Dense, then (BatchNorm and) ReLU after every layer but a
    final one without ``final_nonlinearity``."""

    def __init__(self, in_dim: int, dims: Sequence[int],
                 batch_norm: bool = False, final_nonlinearity: bool = True):
        super().__init__()
        self.n = len(dims)
        self.batch_norm = batch_norm
        self.final_nonlinearity = final_nonlinearity
        n_bn = 0
        for i, d in enumerate(dims):
            self.add_module(f"Dense_{i}", nn.Linear(in_dim, d))
            if batch_norm and (i < self.n - 1 or final_nonlinearity):
                self.add_module(f"MaskedBatchNorm_{n_bn}", MaskedBatchNorm(d))
                n_bn += 1
            in_dim = d

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        n_bn = 0
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1 or self.final_nonlinearity:
                if self.batch_norm:
                    x = getattr(self, f"MaskedBatchNorm_{n_bn}")(x, mask)
                    n_bn += 1
                x = F.relu(x)
        return x


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D)[(B, E)] -> (B, E, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


class GraphTripleConv(nn.Module):
    """One scene-graph conv layer (reference graphconv.py:17-119)."""

    def __init__(self, obj_dim: int, pred_dim: int, output_dim: int,
                 hidden_dim: int = 512, pooling: str = "avg",
                 batch_norm: bool = False, final_nonlinearity: bool = True):
        super().__init__()
        if pooling not in ("avg", "sum"):
            raise ValueError(pooling)
        self.hidden_dim, self.output_dim = hidden_dim, output_dim
        self.pooling = pooling
        self.final_nonlinearity = final_nonlinearity
        H = hidden_dim
        self.net1 = TripleMLP(2 * obj_dim + pred_dim, (H, 2 * H + output_dim),
                              batch_norm, final_nonlinearity)
        self.net2 = TripleMLP(H, (H, output_dim), batch_norm,
                              final_nonlinearity)

    def forward(self, obj_vecs, pred_vecs, edges, node_mask, edge_mask):
        """obj_vecs (B, N, Din), pred_vecs (B, E, Dp), edges (B, E, 2) ->
        (new obj_vecs (B, N, Dout), new pred_vecs (B, E, Dout))."""
        N = obj_vecs.shape[1]
        H, Dout = self.hidden_dim, self.output_dim
        s_idx, o_idx = edges[..., 0], edges[..., 1]
        t_vecs = torch.cat([_take(obj_vecs, s_idx), pred_vecs,
                            _take(obj_vecs, o_idx)], dim=-1)
        new_t = self.net1(t_vecs, edge_mask)
        new_s = new_t[..., :H]
        new_p = new_t[..., H:H + Dout]
        new_o = new_t[..., H + Dout:]
        if not self.final_nonlinearity:
            # the reference still ReLUs the s/o updates on the last layer
            # (graphconv.py:86-88)
            new_s, new_o = F.relu(new_s), F.relu(new_o)
        m = edge_mask.to(new_t.dtype)[..., None]
        s_inc = F.one_hot(s_idx, N).to(new_t.dtype) * m  # (B, E, N)
        o_inc = F.one_hot(o_idx, N).to(new_t.dtype) * m
        pooled = (torch.einsum("ben,beh->bnh", s_inc, new_s)
                  + torch.einsum("ben,beh->bnh", o_inc, new_o))
        if self.pooling == "avg":
            counts = s_inc.sum(dim=1) + o_inc.sum(dim=1)  # (B, N)
            pooled = pooled / torch.clamp(counts, min=1.0)[..., None]
        return self.net2(pooled, node_mask), new_p


class GraphTripleConvNet(nn.Module):
    """A stack of graph conv layers (reference graphconv.py:122-154); the
    last maps to ``output_dim`` without a final nonlinearity."""

    def __init__(self, obj_dim: int, pred_dim: int, output_dim: int,
                 num_layers: int = 5, hidden_dim: int = 512,
                 pooling: str = "avg", batch_norm: bool = False):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"gconv_{i}", GraphTripleConv(
                obj_dim, pred_dim, output_dim if last else hidden_dim,
                hidden_dim=hidden_dim, pooling=pooling,
                batch_norm=batch_norm, final_nonlinearity=not last))
            obj_dim = pred_dim = hidden_dim

    def forward(self, obj_vecs, pred_vecs, edges, node_mask, edge_mask):
        for i in range(self.num_layers):
            obj_vecs, pred_vecs = getattr(self, f"gconv_{i}")(
                obj_vecs, pred_vecs, edges, node_mask, edge_mask)
        return obj_vecs, pred_vecs
