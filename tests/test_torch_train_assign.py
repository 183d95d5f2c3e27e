"""Port parity of the training edge sampler: ``sgg_torch.train.assign``
against ``sgg_tpu.train.assign`` on the CPU. Given the same uniforms the
sampled edges and masks must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.train import assign as jassign
from sgg_torch.train.assign import sample_edges, select_edges

B, N, E = 3, 6, 10


def _graph(rng, n_nodes, n_rels, dup=0):
    """rels (B, E, 3), rel_mask (B, E), node_mask (B, N) with
    ``n_nodes[b]`` valid nodes and ``n_rels[b]`` relations (``dup`` of them
    repeat an earlier (subj, obj) pair with another predicate)."""
    rels = np.zeros((B, E, 3), np.int32)
    rel_mask = np.zeros((B, E), bool)
    node_mask = np.zeros((B, N), bool)
    for b in range(B):
        n, r = n_nodes[b], n_rels[b]
        node_mask[b, :n] = True
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        pick = rng.choice(len(pairs), size=r - dup, replace=False)
        chosen = [pairs[k] for k in pick]
        chosen += [chosen[k % len(chosen)] for k in range(dup)]
        for e, (s, o) in enumerate(chosen):
            rels[b, e] = (s, o, rng.randint(1, 7))
            rel_mask[b, e] = True
    return rels, rel_mask, node_mask


# name -> (valid nodes per image, relations per image, duplicates, max_out,
# uniforms quantized to this many levels or None)
CASES = {
    "max_out_below_candidates": ((6, 5, 4), (4, 3, 2), 0, 6, None),
    "max_out_above_candidates": ((4, 3, 2), (3, 2, 1), 0, 40, None),
    "image_without_relation": ((5, 4, 3), (3, 0, 2), 0, 8, None),
    "image_without_bg_candidate": ((2, 3, 2), (2, 6, 1), 0, 12, None),
    "fg_over_cap_with_duplicate_pairs": ((6, 6, 5), (9, 8, 6), 3, 16, None),
    "tied_scores": ((6, 5, 4), (5, 4, 3), 1, 20, 4),
}


def _jax_select(monkeypatch, u_fg, u_bg, rels, rel_mask, node_mask, max_out):
    """``sgg_tpu``'s per-image sampler on the given uniforms (its two
    ``jax.random.uniform`` draws, FG then BG, replaced by them)."""
    out, masks = [], []
    for b in range(B):
        draws = iter([jnp.asarray(u_fg[b]), jnp.asarray(u_bg[b])])
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape: next(draws))
        o, m = jassign._sample_edges_one(
            jax.random.key(0), jnp.asarray(rels[b]), jnp.asarray(rel_mask[b]),
            jnp.asarray(node_mask[b]), max_out, 0.25)
        out.append(np.asarray(o))
        masks.append(np.asarray(m))
    monkeypatch.undo()
    return np.stack(out), np.stack(masks)


@pytest.mark.parametrize("case", list(CASES))
def test_select_edges_matches_jax(monkeypatch, case):
    n_nodes, n_rels, dup, max_out, levels = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    rels, rel_mask, node_mask = _graph(rng, n_nodes, n_rels, dup)
    u_fg = rng.rand(B, E).astype(np.float32)
    u_bg = rng.rand(B, N * N).astype(np.float32)
    if levels:
        u_fg = np.floor(u_fg * levels) / levels
        u_bg = np.floor(u_bg * levels) / levels
    want, want_mask = _jax_select(monkeypatch, u_fg, u_bg, rels, rel_mask,
                                  node_mask, max_out)
    got, got_mask = select_edges(
        torch.from_numpy(u_fg), torch.from_numpy(u_bg),
        torch.from_numpy(rels), torch.from_numpy(rel_mask),
        torch.from_numpy(node_mask), max_out=max_out)
    assert got.dtype == torch.long and got.shape == (B, max_out, 3)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(got.numpy(), want)
    # FG is capped at round(max_out * 0.25) and comes first
    is_fg = got_mask.numpy() & (got.numpy()[..., 2] > 0)
    assert (is_fg.sum(1) <= round(max_out * 0.25)).all()


def test_select_edges_on_jax_draws_matches_sample_edges():
    """The uniforms ``sgg_tpu.train.assign.sample_edges`` draws from its key
    (split per image, then FG/BG), fed to the port, give its edges."""
    rng = np.random.RandomState(11)
    rels, rel_mask, node_mask = _graph(rng, (6, 4, 5), (5, 2, 4))
    key = jax.random.key(3)
    want, want_mask = jassign.sample_edges(key, rels, rel_mask, node_mask,
                                           max_out=9)
    u_fg, u_bg = [], []
    for k in jax.random.split(key, B):
        k_fg, k_bg = jax.random.split(k)
        u_fg.append(np.asarray(jax.random.uniform(k_fg, (E,))))
        u_bg.append(np.asarray(jax.random.uniform(k_bg, (N * N,))))
    got, got_mask = select_edges(
        torch.from_numpy(np.stack(u_fg)), torch.from_numpy(np.stack(u_bg)),
        torch.from_numpy(rels), torch.from_numpy(rel_mask),
        torch.from_numpy(node_mask), max_out=9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_sample_edges_draws_fg_then_bg_from_the_generator():
    rng = np.random.RandomState(12)
    rels, rel_mask, node_mask = (torch.from_numpy(a) for a in _graph(
        rng, (6, 4, 5), (5, 2, 4)))
    got = sample_edges(torch.Generator().manual_seed(7), rels, rel_mask,
                       node_mask, max_out=9)
    g = torch.Generator().manual_seed(7)
    u_fg = torch.rand((B, E), generator=g)
    u_bg = torch.rand((B, N * N), generator=g)
    want = select_edges(u_fg, u_bg, rels, rel_mask, node_mask, max_out=9)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
