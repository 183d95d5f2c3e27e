"""Node and edge classification losses, including the density-aware
(dnorm) edge loss of "Graph Density-Aware Losses for Novel Compositions in
Scene Graph Generation" (BMVC 2020).

Counterpart of ``sgg_tpu/train/losses.py`` (reference ``lib/losses.py``):

* ``baseline``: mean CE over all M sampled edges, scaled by gamma
  (``losses.py:39-43``);
* ``dnorm``: FG edges weighted ``alpha / M_FG``, BG edges ``beta / M_FG``
  (``losses.py:45-57``);
* ``dnorm-fgbg``: FG ``alpha / M_FG``, BG ``beta / M_BG``
  (``losses.py:58-60``);
* node loss: plain CE over object logits (``losses.py:73-74``).

Batches are padded, so every count (M, M_FG, M_BG) is a mask-aware sum:
padding adds zero loss and zero count. The CE is computed in float32, and
every count and weight stays on the device (no host sync).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Per-element float32 CE, zeroed where ``mask`` is False."""
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.long().reshape(-1), reduction="none")
    return torch.where(mask.reshape(-1), ce, 0.0).reshape(mask.shape)


def edge_losses(rel_logits: torch.Tensor, rel_labels: torch.Tensor,
                rel_mask: torch.Tensor, loss_type: str = "dnorm",
                loss_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                ) -> Dict[str, torch.Tensor]:
    """Edge (predicate) loss over the whole padded batch.

    rel_logits (B, E, R); rel_labels (B, E), 0 = background; rel_mask
    (B, E). ``loss_weights`` is (alpha, beta, gamma), reference
    config.py:186-190. Returns ``{"rel_loss": scalar}``.
    """
    alpha, beta, gamma = loss_weights
    ce = _masked_ce(rel_logits, rel_labels, rel_mask)
    is_fg = rel_mask & (rel_labels > 0)
    is_bg = rel_mask & (rel_labels == 0)
    m_fg = is_fg.sum().float()
    m_bg = is_bg.sum().float()
    m = rel_mask.sum().float()

    if loss_type == "baseline":
        if not alpha == beta == 1:
            raise ValueError(f"wrong loss is used, use dnorm or dnorm-fgbg "
                             f"(alpha {alpha}, beta {beta})")
        loss = gamma * ce.sum() / torch.clamp(m, min=1.0)
    elif loss_type in ("dnorm", "dnorm-fgbg"):
        fg_w = torch.where(m_fg > 0, alpha / torch.clamp(m_fg, min=1.0), 1.0)
        if loss_type == "dnorm":
            # BG keeps weight 1 when there is no FG edge (reference
            # losses.py:56-57 reweights only if M_BG > 0 and M_FG > 0)
            bg_w = torch.where((m_bg > 0) & (m_fg > 0),
                               beta / torch.clamp(m_fg, min=1.0), 1.0)
        else:
            bg_w = torch.where(m_bg > 0, beta / torch.clamp(m_bg, min=1.0),
                               1.0)
        weights = torch.where(is_fg, fg_w, torch.where(is_bg, bg_w, 0.0))
        loss = gamma * (ce * weights).sum()
    else:
        raise NotImplementedError(loss_type)
    return {"rel_loss": loss}


def node_losses(obj_logits: torch.Tensor, obj_labels: torch.Tensor,
                node_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean CE over valid objects (reference losses.py:73-74)."""
    ce = _masked_ce(obj_logits, obj_labels, node_mask)
    n = torch.clamp(node_mask.sum().float(), min=1.0)
    return {"obj_loss": ce.sum() / n}
