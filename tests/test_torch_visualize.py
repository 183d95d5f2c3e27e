"""The port's drawing helpers (``sgg_torch/utils/visualize.py``) against
``sgg_tpu``'s on seeded inputs: ``get_color`` in both formats,
``draw_boxes``' image byte for byte (with and without ``rels``), and
``show_nx``'s scene graph under matplotlib's Agg backend: the graph that
networkx draws (its nodes and labels, its edges in order with their
colours and widths: red and 8 wide for a zero-shot triplet, red and 2 for
one absent from training, blue and 1 otherwise, the reverse-edge rule),
the node and node-border colours, the edge labels, and the rendered
figure's pixels."""

import matplotlib
import numpy as np
import pytest

from sgg_tpu.utils import visualize as jvis
from sgg_torch.utils import visualize as tvis

CLASSES = ["__background__", "person", "surfboard", "wave", "dog", "hat"]
PREDICATES = ["__background__", "on", "near", "has", "riding"]


@pytest.fixture(autouse=True)
def agg():
    matplotlib.use("Agg")


def test_colors_are_sgg_tpus():
    for obj, name in enumerate(CLASSES * 3):
        for fmt in ("array", "string"):
            assert tvis.get_color(obj, name, fmt) \
                == jvis.get_color(obj, name, fmt)
    np.testing.assert_array_equal(tvis.NODE_COLORS, jvis.NODE_COLORS)


@pytest.mark.parametrize("with_rels", [False, True])
def test_draw_boxes_matches_sgg_tpu(with_rels):
    rng = np.random.RandomState(0)
    im = rng.randn(120, 160, 3).astype(np.float32)
    xy = rng.rand(6, 2) * [150, 110]
    boxes = np.concatenate([xy, xy + rng.rand(6, 2) * 60 + 5], 1)
    boxes[0] = [-20, -10, 300, 200]  # clipped to the image
    names = [CLASSES[c] for c in rng.randint(1, len(CLASSES), 6)]
    rels = np.asarray([[0, 1, 2], [3, 1, 1]]) if with_rels else None
    got = tvis.draw_boxes(im.copy(), names, boxes, rels=rels)
    want = jvis.draw_boxes(im.copy(), names, boxes, rels=rels)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != jvis.draw_boxes(im.copy(), [], boxes[:0])).any()


def _graph_case():
    classes = np.asarray([1, 2, 3, 4, 5])
    rels = np.asarray([[0, 1, 1],    # person on surfboard: zero-shot
                       [2, 3, 2],    # wave near dog
                       [3, 2, 3],    # its reverse after a 'near': skipped
                       [0, 4, 4],    # person riding hat
                       [4, 0, 1],    # hat on person, not in training: it
                       #               replaces its reverse
                       [0, 4, 1]])   # a duplicate pair: the first kept
    counts = {"3_2_4": 3, "1_4_5": 7}
    zs = {"1_1_2"}
    return classes, rels, counts, zs


def _drawn(vis, monkeypatch):
    """``show_nx``'s calls into networkx, recorded, and its figure's
    pixels."""
    import matplotlib.pyplot as plt
    import networkx as nx
    calls = {}

    def record(name, f):
        def call(G, *a, **kw):
            calls[name] = (G, kw)
            return f(G, *a, **kw)
        return call

    for name in ("draw", "draw_networkx_labels",
                 "draw_networkx_edge_labels"):
        monkeypatch.setattr(nx, name, record(name, getattr(nx, name)))
    classes, rels, counts, zs = _graph_case()
    fig = vis.show_nx(classes, rels, CLASSES, PREDICATES,
                      train_triplet_counts=counts, zeroshot_triplets=zs,
                      perturbed_nodes=[2])
    fig.canvas.draw()
    pixels = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    monkeypatch.undo()
    G, kw = calls["draw"]
    graph = {"nodes": list(G.nodes(data=True)),
             "edges": list(G.edges(data=True)),
             "node_color": np.asarray(kw["node_color"]).tolist(),
             "edgecolors": np.asarray(kw["edgecolors"]).tolist(),
             "linewidths": kw["linewidths"], "edge_color": kw["edge_color"],
             "width": kw["width"],
             "labels": calls["draw_networkx_labels"][1]["labels"],
             "edge_labels": calls["draw_networkx_edge_labels"][1][
                 "edge_labels"]}
    return graph, pixels


def test_show_nx_draws_sgg_tpus_graph(monkeypatch):
    got, got_px = _drawn(tvis, monkeypatch)
    want, want_px = _drawn(jvis, monkeypatch)
    assert got == want
    np.testing.assert_array_equal(got_px, want_px)
    edges = {(s, o): d for s, o, d in got["edges"]}
    assert edges == {(0, 1): {"color": "red", "weight": 8.0},
                     (2, 3): {"color": "blue", "weight": 1.0},
                     (4, 0): {"color": "red", "weight": 2.0}}
    assert got["edge_labels"] == {(0, 1): "on-0", (2, 3): "near-3",
                                  (4, 0): "on-0"}
    assert got["linewidths"] == [1, 1, 8, 1, 1]
