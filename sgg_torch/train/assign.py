"""Relation edge sampling and enumeration (``sgg_tpu/train/assign.py``).

``sample_edges`` is the predcls/sgcls training sampler (reference
``proposal_assignments_gtbox``): annotated (FG) pairs capped at
``round(max_out * REL_FG_FRACTION)``, filled with background pairs (all
ordered valid pairs minus the diagonal minus the FG pairs) up to
``max_out`` per image, all chosen by one sort of random priority scores
(FG in [2, 3), BG in [0, 1), invalid ``-inf``). ``all_pairs`` is the
reference's all-ordered-pairs enumeration
(``sgg_models/rel_model_base.py:148-163``), padded to a static
``N*(N-1)``; ``compact_pairs`` gathers the valid pairs into a smaller
budget, order-preserving; ``unordered_union_index`` lets union-box work run
once per unordered pair.
"""

from __future__ import annotations

from typing import Optional

import torch

from sgg_torch.constants import REL_FG_FRACTION


def select_edges(u_fg: torch.Tensor, u_bg: torch.Tensor, rels: torch.Tensor,
                 rel_mask: torch.Tensor, node_mask: torch.Tensor, *,
                 max_out: int, fg_fraction: float = REL_FG_FRACTION):
    """FG/BG edge selection from given uniforms: ``_sample_edges_one`` of
    the JAX package over the whole batch at once.

    u_fg (B, E) and u_bg (B, N*N) are uniforms in [0, 1): FG edge ``e``
    ranks by ``u_fg[:, e]``, BG pair ``(i, j)`` scores ``u_bg[:, i*N + j]``.
    rels (B, E, 3) ``(subj, obj, predicate)``; rel_mask (B, E); node_mask
    (B, N). Returns (sampled (B, max_out, 3) int64, mask (B, max_out)
    bool), FG first, BG with predicate 0, invalid slots all 0.

    Ties are broken as ``jax.lax.top_k`` and the stable ``argsort`` break
    them (lower index first), so the same uniforms give the same edges.
    """
    B, E = rel_mask.shape
    N = node_mask.shape[1]
    dev = rel_mask.device
    max_fg = int(round(max_out * fg_fraction))
    inf = float("inf")  # a Python scalar: a device tensor made from one
    # would be a host-to-device copy, which waits for the card

    # FG: rank among valid FG edges by u_fg; ranks >= max_fg are dropped
    order = torch.argsort(torch.where(rel_mask, u_fg, inf), dim=1,
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(E, device=dev).expand(B, E))
    fg_keep = rel_mask & (rank < max_fg)
    # FG scores in [2, 3) always beat BG scores in [0, 1)
    fg_score = torch.where(fg_keep, 2.0 + u_fg, -inf)

    # BG: ordered valid pairs minus the diagonal minus the FG pairs (a pair
    # annotated twice is FG once)
    subj, obj = rels[..., 0].long(), rels[..., 1].long()
    pair_valid = node_mask[:, :, None] & node_mask[:, None, :] \
        & ~torch.eye(N, dtype=torch.bool, device=dev)
    fg_pair = torch.zeros((B, N * N), dtype=torch.int32, device=dev) \
        .scatter_add_(1, subj * N + obj, rel_mask.int()) > 0
    bg_valid = pair_valid.reshape(B, N * N) & ~fg_pair
    bg_score = torch.where(bg_valid, u_bg, -inf)

    grid = torch.arange(N, device=dev)
    all_scores = torch.cat([fg_score, bg_score], dim=1)
    all_subj = torch.cat([subj, grid.repeat_interleave(N).expand(B, -1)], 1)
    all_obj = torch.cat([obj, grid.repeat(N).expand(B, -1)], 1)
    all_pred = torch.cat([rels[..., 2].long(),
                          torch.zeros((B, N * N), dtype=torch.long,
                                      device=dev)], 1)

    # top-k as a stable descending sort: equal scores keep index order
    top_scores, top_idx = torch.sort(all_scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :max_out], top_idx[:, :max_out]
    out_mask = top_scores > -inf
    out = torch.stack([
        torch.where(out_mask, torch.gather(a, 1, top_idx), 0)
        for a in (all_subj, all_obj, all_pred)], dim=2)
    return out, out_mask


def sample_edges(generator: Optional[torch.Generator], rels: torch.Tensor,
                 rel_mask: torch.Tensor, node_mask: torch.Tensor, *,
                 max_out: int, fg_fraction: float = REL_FG_FRACTION):
    """Batched FG/BG edge sampling for training (``sample_edges`` of the
    JAX package): draws ``u_fg`` (B, E) then ``u_bg`` (B, N*N) from
    ``generator``, which lives on the batch's device, and returns
    ``select_edges`` of them.

    ``max_out`` is the per-image budget (the reference's
    ``RELS_PER_IMG``); budgets are per image, not pooled over the batch as
    in the reference (``proposal_assignments_gtbox.py:47-56``), like the
    JAX package.
    """
    B, E = rel_mask.shape
    N = node_mask.shape[1]
    dev = rel_mask.device
    u_fg = torch.rand((B, E), generator=generator, device=dev)
    u_bg = torch.rand((B, N * N), generator=generator, device=dev)
    return select_edges(u_fg, u_bg, rels, rel_mask, node_mask,
                        max_out=max_out, fg_fraction=fg_fraction)


def all_pairs(node_mask: torch.Tensor):
    """All ordered valid pairs minus the diagonal.

    node_mask (B, N) bool -> (pairs (B, N*(N-1), 2) int64, mask (B, N*(N-1))
    bool), in the row-major order of ``nonzero`` over the off-diagonal grid
    (the evaluator's ranking ties depend on this order).
    """
    B, N = node_mask.shape
    off = ~torch.eye(N, dtype=torch.bool, device=node_mask.device)
    subj, obj = torch.nonzero(off, as_tuple=True)
    pairs = torch.stack([subj, obj], dim=1)
    pairs = pairs[None].expand(B, N * (N - 1), 2)
    mask = node_mask[:, subj] & node_mask[:, obj]
    return pairs, mask


def _stable_order_valid_first(valid: torch.Tensor) -> torch.Tensor:
    """Slot order with valid entries first, each group in slot order
    (``argsort(~valid, stable=True)``)."""
    return torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)


def unordered_union_index(pairs: torch.Tensor, pair_mask: torch.Tensor,
                          max_unique: int, num_nodes: int):
    """Dedup structure for union-box work over *unordered* pairs.

    Union boxes are symmetric in the pair order and every eval enumeration
    is swap-closed, so union RoIAlign (and the linear part of the edge fc6)
    can run once per unordered pair at half the edge budget and be
    gathered back to every ordered slot.

    Returns:
      uni_slots (B, U): each unordered representative's ordered-edge slot.
      gather_idx (B, E): for each ordered edge, its representative's row in
        ``uni_slots`` (garbage for invalid edges).
      ok (B,): True iff the image's unique pairs fit ``U``; False means the
        gathered values are garbage and callers must fall back.
      n_unique (B,): unique-pair counts.
    """
    B, E = pair_mask.shape
    dev = pairs.device
    slot = torch.arange(E, device=dev)[None, :]
    mn = torch.minimum(pairs[..., 0], pairs[..., 1]).long()
    mx = torch.maximum(pairs[..., 0], pairs[..., 1]).long()
    # ``num_nodes`` bounds the pair indices; the packed key must stay
    # collision-free, or distinct pairs would merge unnoticed
    shift = 1
    while shift < num_nodes:
        shift *= 2
    if shift * (num_nodes - 1) + (num_nodes - 1) >= (1 << 30):
        raise ValueError(f"unordered-pair key packing overflows for node "
                         f"bucket {num_nodes}")
    key = mn * shift + mx
    # invalid slots get unique keys above the valid key space
    key = torch.where(pair_mask, key, (1 << 30) + slot)

    order = torch.argsort(key, dim=1, stable=True)
    skey = torch.gather(key, 1, order)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       skey[:, 1:] != skey[:, :-1]], dim=1)
    # slot of each sorted run's first element (the stable sort puts the
    # lowest-slot, i.e. row-major-first, direction first)
    first_pos = torch.cummax(
        torch.where(first, slot.expand(B, E), torch.full_like(slot, -1)),
        dim=1).values
    rep_sorted = torch.gather(order, 1, first_pos)
    rep = torch.zeros((B, E), dtype=torch.long, device=dev).scatter(
        1, order, rep_sorted)

    uniq = (rep == slot) & pair_mask
    n_unique = uniq.sum(dim=1)
    ok = n_unique <= max_unique
    uni_slots = _stable_order_valid_first(uniq)[:, :max_unique]
    inv = torch.zeros((B, E), dtype=torch.long, device=dev).scatter(
        1, uni_slots,
        torch.arange(uni_slots.shape[1], device=dev)[None, :].expand(
            B, uni_slots.shape[1]))
    gather_idx = torch.gather(inv, 1, rep)
    return uni_slots, gather_idx, ok, n_unique


def compact_pairs(pairs: torch.Tensor, pair_mask: torch.Tensor,
                  max_pairs: int):
    """Gather the valid pairs into a (B, max_pairs) buffer, order-preserving.

    Exact whenever every image has <= max_pairs valid pairs; ``val_epoch``
    guarantees that from host-side node counts.
    Returns (pairs, mask, per-image valid count).
    """
    count = pair_mask.sum(dim=1)
    order = _stable_order_valid_first(pair_mask)[:, :max_pairs]
    cpairs = torch.gather(pairs, 1, order[..., None].expand(*order.shape, 2))
    cmask = torch.gather(pair_mask, 1, order)
    return cpairs, cmask, count
