"""Inference-time edge enumeration (the evaluation half of
``sgg_tpu/train/assign.py``).

``all_pairs`` is the reference's all-ordered-pairs enumeration
(``sgg_models/rel_model_base.py:148-163``), padded to a static
``N*(N-1)``; ``compact_pairs`` gathers the valid pairs into a smaller
budget, order-preserving; ``unordered_union_index`` lets union-box work run
once per unordered pair. The training sampler ``sample_edges`` comes with
the training slice.
"""

from __future__ import annotations

import torch


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
