"""The port's shape buckets (``BatchLoader(buckets=)``) against
``sgg_tpu``'s on the CPU: ``tests/test_pipeline.py``'s bucket case (ten
graphs of two sizes into ``(4, 8)`` and ``(16, 32)``) run on the port's
loader, and every batch, field by field, equal to ``sgg_tpu``'s, in order,
shuffled or not, with the remainders kept or dropped; with ``shard=`` each
rank's batches are its rows of the one-process batches, on the same bucket
sequence; a batch the ranks do not divide raises."""

import dataclasses

import numpy as np
import pytest

from sgg_tpu.data.datasets import SGGDataset as JDataset
from sgg_tpu.data.pipeline import BatchLoader as JLoader
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.pipeline import BatchLoader

BUCKETS = [(16, 32), (4, 8)]  # given unsorted: the loaders sort them
SIZES = [2, 3, 3, 2, 9, 10, 9, 10, 2, 3, 5, 2]


def _datasets(sizes=SIZES):
    rng = np.random.RandomState(7)
    boxes, classes, rels = [], [], []
    for k in sizes:
        b = rng.rand(k, 4).astype(np.float32) * 400
        b[:, 2:] += b[:, :2] + 10
        boxes.append(b)
        classes.append(rng.randint(1, 9, k))
        rels.append(np.asarray([[0, 1, rng.randint(1, 4)]], np.int32))
    kw = dict(name="stanford", mode="train", filenames=[], images_dir="",
              gt_boxes=boxes, gt_classes=classes, relationships=rels,
              ind_to_classes=["bg"] + [f"c{i}" for i in range(8)],
              ind_to_predicates=["bg", "p1", "p2", "p3"])
    return JDataset(**kw), SGGDataset(**kw)


def _loaders(shuffle, drop_last, batch_size=2, shard=None):
    jds, tds = _datasets()
    kw = dict(batch_size=batch_size, max_nodes=16, max_edges=32,
              with_images=False, im_scale=64, shuffle=shuffle,
              drop_last=drop_last, buckets=BUCKETS, num_workers=1, seed=3)
    return JLoader(jds, **kw), BatchLoader(tds, shard=shard, **kw)


def _fields(batch):
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None}


def test_bucketed_batching_on_the_port():
    """``tests/test_pipeline.py::test_bucketed_batching``'s checks."""
    _, tds = _datasets(SIZES[:10])
    kw = dict(batch_size=2, max_nodes=16, max_edges=32, with_images=False,
              im_scale=64, shuffle=False, buckets=[(4, 8), (16, 32)])
    shapes = [(b.max_nodes, b.max_edges, b.batch_size)
              for b in BatchLoader(tds, **kw)]
    assert (4, 8, 2) in shapes and (16, 32, 2) in shapes
    assert sum(s[2] for s in shapes) == 10
    for gb in BatchLoader(tds, **kw):
        n = np.asarray(gb.node_mask).sum(1)
        # the smallest bucket that holds each image
        assert (n <= gb.max_nodes).all()
        assert gb.max_nodes == 4 or (n > 4).all()


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batches_equal_sgg_tpus(shuffle, drop_last):
    jl, tl = _loaders(shuffle, drop_last)
    n = 0
    for epoch in range(2):  # a new order each epoch
        jl._epoch = tl._epoch = epoch
        got, want = list(tl), list(jl)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            n += 1
            assert (g.max_nodes, g.max_edges) == (w.max_nodes, w.max_edges)
            gf, wf = _fields(g), _fields(w)
            assert set(gf) == set(wf)
            for k in wf:
                np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
    # images of 2 and 3 nodes: (4, 8); of 5, 9 and 10: (16, 32)
    shapes = {(b.max_nodes, b.max_edges) for b in got}
    assert shapes == {(4, 8), (16, 32)}


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_shards_are_rows_of_the_bucketed_batches(drop_last, world):
    _, whole = _loaders(True, drop_last, batch_size=4)
    parts = [_loaders(True, drop_last, batch_size=4, shard=(r, world))[1]
             for r in range(world)]
    batches = list(whole)
    shards = [list(p) for p in parts]
    assert all(len(s) == len(batches) for s in shards)
    for i, b in enumerate(batches):
        want = _fields(b)
        # a tail the ranks do not divide repeats its images
        rows = np.resize(np.arange(b.batch_size),
                         -(-b.batch_size // world) * world)
        per = len(rows) // world
        for r, s in enumerate(shards):
            got = _fields(s[i])
            assert (s[i].max_nodes, s[i].max_edges) == (b.max_nodes,
                                                        b.max_edges)
            for k, v in want.items():
                np.testing.assert_array_equal(
                    got[k], v[rows[r * per:(r + 1) * per]], err_msg=k)


def test_a_batch_the_ranks_do_not_divide_raises():
    with pytest.raises(ValueError, match="not divisible"):
        _loaders(False, True, batch_size=3, shard=(0, 2))
