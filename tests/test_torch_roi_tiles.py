"""K1-bwd-fmap's tile decomposition on the CPU, in f32:

* the model of its tile lists (``roi_tile_lists``: per tile the ROIs with a
  tap of nonzero weight in the tile's rows and one in its columns, in
  ascending order) against brute force over the folded tap tables of
  ``folded_axis_taps`` (every cell a ROI weighs, its tile);
* summing each tile's cells over its list, in list order, against
  ``jax.vjp`` of ``roi_align_pallas`` (interpret mode, its custom VJP).

Cases: the six kinds of ``test_torch_backward.py`` (2 x 9 x 11 maps, ragged
4 x 4 tiles), a crowded draw whose ROIs all fall in one tile, and a stride-4
map of 148 x 148 where large ROIs' samples lie more than a tile apart. The
kernel's own lists are held against this model on the card
(``test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgg_tpu.ops.roi_align_pallas import roi_align_pallas
from sgg_torch.ops import roi_align as troi
from test_torch_backward import KINDS, SCALE, _case

TH, TW = troi.FMAP_TILE


def _crowded(seed=0, C=8):
    """70 ROIs jittered around one point: every tap in map rows and columns
    4 .. 7, the tile (1, 1)."""
    rng = np.random.RandomState(seed)
    B, H, W = 2, 9, 11
    centre = 88.0 + rng.uniform(-4, 4, (B, 70, 2))
    half = rng.uniform(2, 6, (B, 70, 2))
    boxes = np.concatenate([centre - half, centre + half], -1)
    return (rng.randn(B, H, W, C).astype(np.float32),
            boxes.astype(np.float32),
            rng.randn(B, 70, 7, 7, C).astype(np.float32))


def _stride4(seed=0, C=4):
    """A 148 x 148 map at spatial scale 1/4 (a 592-pixel canvas): boxes of
    540-590 px, and of 850-1000 px reaching past the canvas, put a ROI's
    14 samples 10-18 cells apart, so its taps skip whole tiles; smaller
    boxes mixed in."""
    rng = np.random.RandomState(seed)
    B, H, W, R = 1, 148, 148, 12
    xy = rng.uniform(0, 40, (B, R, 2))
    wh = rng.uniform(540, 590, (B, R, 2))
    xy[:, 4:6] = rng.uniform(-250, -150, (B, 2, 2))
    wh[:, 4:6] = rng.uniform(850, 1000, (B, 2, 2))
    xy[:, 6:] = rng.uniform(0, 500, (B, R - 6, 2))
    wh[:, 6:] = rng.uniform(8, 200, (B, R - 6, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return (rng.randn(B, H, W, C).astype(np.float32), boxes,
            rng.randn(B, R, 7, 7, C).astype(np.float32))


CASES = KINDS + ["crowded", "stride4"]


def _data(kind):
    """(fmap, boxes, g, spatial scale) of a case."""
    if kind == "crowded":
        return (*_crowded(), SCALE)
    if kind == "stride4":
        return (*_stride4(), 0.25)
    return (*_case(kind), SCALE)


def _tables(boxes, H, W, scale):
    """Per image and ROI the folded (rows, columns) tap tables."""
    x1, y1, rw, rh = (t.numpy() for t in troi._box_frames(
        torch.from_numpy(boxes), scale))
    return [[(troi.folded_axis_taps(y1[b, r], rh[b, r], H, 7, 2),
              troi.folded_axis_taps(x1[b, r], rw[b, r], W, 7, 2))
             for r in range(boxes.shape[1])] for b in range(boxes.shape[0])]


def _brute_lists(boxes, H, W, scale):
    """Per image and tile, the ROIs that weigh one of the tile's cells:
    every (row tap, column tap) pair of every bin pair (p, q)."""
    ntx = -(-W // TW)
    out = []
    for per_roi in _tables(boxes, H, W, scale):
        lists = [[] for _ in range(-(-H // TH) * ntx)]
        for r, (rows, cols) in enumerate(per_roi):
            hit = {(y // TH) * ntx + x // TW
                   for p in rows for y, wy in p
                   for q in cols for x, wx in q if wy * wx != 0}
            for t in hit:
                lists[t].append(r)
        out.append(lists)
    return out


@pytest.mark.parametrize("kind", CASES)
def test_tile_lists_match_brute_force(kind):
    fmap, boxes, _, scale = _data(kind)
    H, W = fmap.shape[1:3]
    got = troi.roi_tile_lists(torch.from_numpy(boxes), (H, W),
                              spatial_scale=scale)
    assert got == _brute_lists(boxes, H, W, scale)
    assert all(lst == sorted(set(lst)) for per_b in got for lst in per_b)


def test_crowded_case_falls_in_one_tile():
    fmap, boxes, _, scale = _data("crowded")
    lists = troi.roi_tile_lists(torch.from_numpy(boxes), fmap.shape[1:3],
                                spatial_scale=scale)
    want = [list(range(70)) if t == 1 * 3 + 1 else [] for t in range(9)]
    assert (TH, TW) == (4, 4) and all(per_b == want for per_b in lists)


def test_stride4_case_skips_tiles():
    """Large ROIs at stride 4 miss tiles inside their span: a bounding
    range would list them there, and the gather must not count on it."""
    fmap, boxes, _, scale = _data("stride4")
    H, W = fmap.shape[1:3]
    lists = troi.roi_tile_lists(torch.from_numpy(boxes), (H, W),
                                spatial_scale=scale)[0]
    ntx = -(-W // TW)
    skipped = 0
    for r in range(6):
        tiles = [t for t, lst in enumerate(lists) if r in lst]
        for along in ({t // ntx for t in tiles}, {t % ntx for t in tiles}):
            skipped += len(set(range(min(along), max(along) + 1)) - along)
    assert skipped >= 20


def test_rois_whose_taps_all_weigh_zero_are_in_no_list():
    fmap, boxes, _, scale = _data("outside")
    lists = troi.roi_tile_lists(torch.from_numpy(boxes), fmap.shape[1:3],
                                spatial_scale=scale)
    for per_b in lists:
        assert not any(2 in lst for lst in per_b)  # wholly outside the map
        assert any(3 in lst for lst in per_b)      # ends on the -1 edge


def _tiled_grad(g, boxes, H, W, scale):
    """grad_fmap summed tile by tile: each tile's cells over the tile's
    list, in list order, in f32."""
    B, C = g.shape[0], g.shape[-1]
    lists = troi.roi_tile_lists(torch.from_numpy(boxes), (H, W),
                                spatial_scale=scale)
    tables = _tables(boxes, H, W, scale)
    ntx = -(-W // TW)
    grad = np.full((B, H, W, C), np.nan, np.float32)
    for b in range(B):
        for t, lst in enumerate(lists[b]):
            y0, x0 = (t // ntx) * TH, (t % ntx) * TW
            th, tw = min(TH, H - y0), min(TW, W - x0)
            acc = np.zeros((th, tw, C), np.float32)
            for r in lst:
                w = []
                for table, o, n in zip(tables[b][r], (y0, x0), (th, tw)):
                    dense = np.zeros((len(table), n), np.float32)
                    for p, taps in enumerate(table):
                        for i, wt in taps:
                            if o <= i < o + n:
                                dense[p, i - o] = wt
                    w.append(dense)
                acc += np.einsum("pi,pqc,qj->ijc", w[0], g[b, r], w[1])
            grad[b, y0:y0 + th, x0:x0 + tw] = acc
    return grad


@pytest.mark.parametrize("kind", CASES)
def test_tiled_sums_match_pallas_vjp(kind):
    """Every cell written once (no NaN left), and within 1e-6 of the
    largest value of the Pallas kernel's VJP."""
    fmap, boxes, g, scale = _data(kind)
    _, vjp = jax.vjp(lambda m: roi_align_pallas(
        m, jnp.asarray(boxes), spatial_scale=scale, chunk=4,
        interpret=True), jnp.asarray(fmap))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = _tiled_grad(g, boxes, *fmap.shape[1:3], scale)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"tiled grad_fmap vs Pallas VJP ({kind}): {err:.3g} of its "
          f"largest")
    assert err <= 1e-6
