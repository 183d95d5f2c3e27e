"""The traffic generator is deterministic by seed, and a seed changes the
order of the work, not its amount."""

import hashlib
import os

import numpy as np

from benchmarks import traffic

MIX = dict(traffic.load_mix("vg_jpeg_b24"), pool_files=6,
           long_side=[48, 160])


def _digest(directory, names):
    h = hashlib.sha256()
    for n in names:
        with open(os.path.join(directory, n), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_pool_is_the_seeds(tmp_path):
    a = traffic.write_pool(MIX, 2 ** 33 + 5, str(tmp_path / "a"), 2)
    b = traffic.write_pool(MIX, 2 ** 33 + 5, str(tmp_path / "b"), 2)
    c = traffic.write_pool(MIX, 7, str(tmp_path / "c"), 2)
    assert a == b
    assert _digest(tmp_path / "a", a[0]) == _digest(tmp_path / "b", b[0])
    assert _digest(tmp_path / "a", a[0]) != _digest(tmp_path / "c", c[0])
    assert sorted(a[1]) == sorted(c[1])          # the same sizes


def test_annotations_are_the_seeds():
    mix = traffic.load_mix("vg_jpeg_b24")
    sizes = traffic.pool_sizes(mix, 11)
    one = traffic.annotations(mix, 11, sizes, 240, 151, 51)
    two = traffic.annotations(mix, 11, sizes, 240, 151, 51)
    other = traffic.annotations(mix, 12, traffic.pool_sizes(mix, 12), 240,
                                151, 51)
    for a, b in zip(one.relationships, two.relationships):
        assert np.array_equal(a, b)
    for a, b in zip(one.gt_boxes, two.gt_boxes):
        assert np.array_equal(a, b)
    counts = sorted(len(c) for c in one.gt_classes)
    assert counts == sorted(len(c) for c in other.gt_classes)
    assert any(len(a) != len(b) for a, b in zip(one.gt_classes,
                                                other.gt_classes))


def test_annotations_keep_their_laws():
    mix = traffic.load_mix("vg_jpeg_b24")
    sizes = traffic.pool_sizes(mix, 3)
    split = traffic.annotations(mix, 3, sizes, 480, 151, 51)
    obj = mix["objects"]
    for i, (b, c, r) in enumerate(zip(split.gt_boxes, split.gt_classes,
                                      split.relationships)):
        h, w = sizes[split.entry_file[i]]
        assert obj["min"] <= len(c) <= obj["max"]
        assert (c >= 1).all() and (c < 151).all()
        assert (b[:, 0] >= 0).all() and (b[:, 2] <= w + 1e-3).all()
        assert (b[:, 1] >= 0).all() and (b[:, 3] <= h + 1e-3).all()
        assert 1 <= len(r) <= len(c) * (len(c) - 1)
        assert (r[:, 0] != r[:, 1]).all()
        assert len({(s, o) for s, o, _ in r}) == len(r)
        assert (r[:, 2] >= 1).all() and (r[:, 2] < 51).all()


def test_graph_sizes_hold_the_source_means_and_a_long_tail():
    """The block's means are the source's (11.5 objects, 6.2 relations an
    image); some images fill the 576 edge slots (over 24 objects); any
    part of the block holds small and large images alike."""
    mix = traffic.load_mix("vg_jpeg_b24")
    n, m = traffic.graph_sizes(mix)
    assert len(n) == mix["block"]
    assert abs(n.mean() - mix["objects"]["mean"]) < 0.01
    assert abs(m.mean() - mix["relations"]["mean"]) < 0.01
    assert n.min() == mix["objects"]["min"] and n.max() <= mix["objects"]["max"]
    assert (m >= 1).all() and (m <= n * (n - 1)).all()
    assert 0.03 < (n * (n - 1) > 576).mean() < 0.1
    assert (n ** 2).mean() > 180
    assert abs(n[:mix["block"] // 3].mean() - n.mean()) < 0.5
    assert np.corrcoef(n, m)[0, 1] > 0.5        # crowded images relate more


def test_labels_are_long_tailed():
    mix = traffic.load_mix("vg_jpeg_b24")
    split = traffic.annotations(mix, 9, traffic.pool_sizes(mix, 9), 2400,
                                151, 51)
    classes = np.concatenate(split.gt_classes)
    preds = np.concatenate([r[:, 2] for r in split.relationships])
    assert abs((preds == 1).mean() - traffic.zipf(50, 1.2)[0]) < 0.02
    assert abs((classes == 1).mean() - traffic.zipf(150, 0.7)[0]) < 0.01
    assert (preds == 50).sum() < (preds == 1).sum() / 50


def test_a_grouped_split_gives_every_seed_the_same_batches():
    """A test split in groups of 16: every seed holds the same multiset of
    batches (each batch's object counts), in another order, with other
    images, boxes and labels; the same laws as the training mix."""
    mix = traffic.load_mix("vg_jpeg_eval_b16")
    train = traffic.load_mix("vg_jpeg_b24")
    for key in ("objects", "relations", "block", "class_zipf",
                "predicate_zipf", "pool_files", "long_side"):
        assert mix[key] == train[key]

    def batches(seed):
        split = traffic.annotations(mix, seed, traffic.pool_sizes(mix, seed),
                                    160, 151, 51, group=16)
        counts = [len(c) for c in split.gt_classes]
        return split, [tuple(sorted(counts[i:i + 16]))
                       for i in range(0, 160, 16)]

    one, a = batches(5)
    two, b = batches(2 ** 35 + 1)
    assert sorted(a) == sorted(b) and a != b
    assert not np.array_equal(one.gt_boxes[0], two.gt_boxes[0]) or \
        len(one.gt_boxes[0]) != len(two.gt_boxes[0])
    again, c = batches(5)
    assert a == c
    assert all(np.array_equal(x, y) for x, y in zip(one.relationships,
                                                    again.relationships))
