"""Port parity: box, rects and pair-enumeration ops of ``sgg_torch``
against their ``sgg_tpu`` counterparts, on numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.ops import boxes as jboxes
from sgg_tpu.ops import rects as jrects
from sgg_tpu.train import assign as jassign
from sgg_torch.ops import boxes as tboxes
from sgg_torch.ops import rects as trects
from sgg_torch.train import assign as tassign


def _boxes(rng, *shape):
    xy = rng.rand(*shape, 2) * 80
    wh = rng.rand(*shape, 2) * 40 + 1
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _node_mask(counts, N):
    m = np.zeros((len(counts), N), bool)
    for b, n in enumerate(counts):
        m[b, :n] = True
    return m


def test_union_boxes_and_iou():
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 3, 7)
    subj = rng.randint(0, 7, (3, 11))
    obj = rng.randint(0, 7, (3, 11))
    want = np.asarray(jboxes.union_boxes(jnp.asarray(boxes), jnp.asarray(subj),
                                         jnp.asarray(obj)))
    got = tboxes.union_boxes(torch.from_numpy(boxes), torch.from_numpy(subj),
                             torch.from_numpy(obj)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jboxes.box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    got = tboxes.box_iou(torch.from_numpy(boxes),
                         torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_draw_union_rects():
    rng = np.random.RandomState(1)
    pb = np.concatenate([_boxes(rng, 2, 9), _boxes(rng, 2, 9)], -1)
    pb[0, 0] = 0.0  # degenerate padded pair: zero-area union
    want = np.asarray(jrects.draw_union_rects(jnp.asarray(pb), 27))
    got = trects.draw_union_rects(torch.from_numpy(pb), 27).numpy()
    assert got.shape == want.shape == (2, 9, 2, 27, 27)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_all_pairs():
    nm = _node_mask((5, 2, 0), 6)
    jp, jm = jassign.all_pairs(jnp.asarray(nm))
    tp, tm = tassign.all_pairs(torch.from_numpy(nm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("budget", [8, 20, 30])
def test_compact_pairs(budget):
    nm = _node_mask((5, 3, 1), 6)
    jp, jm = jassign.all_pairs(jnp.asarray(nm))
    want = jassign.compact_pairs(jp, jm, budget)
    got = tassign.compact_pairs(torch.from_numpy(np.array(jp)),
                                torch.from_numpy(np.array(jm)), budget)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("compact", [None, 32])
def test_unordered_union_index(compact):
    nm = _node_mask((6, 4, 2), 7)
    jp, jm = jassign.all_pairs(jnp.asarray(nm))
    if compact:
        jp, jm, _ = jassign.compact_pairs(jp, jm, compact)
    E = jp.shape[1]
    want = jassign.unordered_union_index(jp, jm, E // 2, num_nodes=7)
    got = tassign.unordered_union_index(torch.from_numpy(np.array(jp)),
                                        torch.from_numpy(np.array(jm)),
                                        E // 2, num_nodes=7)
    assert bool(got[2].all())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unordered_union_index_not_swap_closed():
    # 4 distinct unordered keys against a unique budget of 2: ok is False
    pairs = np.asarray([[[0, 1], [2, 3], [4, 5], [6, 7], [1, 0]]], np.int64)
    pm = np.asarray([[True, True, True, True, False]])
    want = jassign.unordered_union_index(jnp.asarray(pairs, jnp.int32),
                                         jnp.asarray(pm), 2, num_nodes=8)
    got = tassign.unordered_union_index(torch.from_numpy(pairs),
                                        torch.from_numpy(pm), 2, num_nodes=8)
    assert not bool(got[2][0])
    assert int(got[3][0]) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
