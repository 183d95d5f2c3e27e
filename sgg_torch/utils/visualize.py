"""Visualization: box rendering and scene-graph drawing.

The port's copy of ``sgg_tpu/utils/visualize.py``, a rebuild of the
reference's ``lib/visualize.py``: ``draw_boxes`` renders
labeled boxes onto images (cv2); ``show_nx`` draws the scene graph with a
circular layout, zero-shot edges highlighted red and bold, edge labels
``predicate-traincount``. Fixed per-node colors come from a seeded palette
with the paper's hand-picked colors for person/surfboard/wave. numpy
only at import: cv2, networkx and matplotlib are imported by the function
that draws with them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_rnd = np.random.RandomState(12345)
NODE_COLORS = _rnd.randint(1, 255, size=(1000, 3)).astype(np.uint8)
_SPECIAL = {"person": (30, 220, 0), "surfboard": (0, 250, 200),
            "wave": (220, 30, 0)}  # BGR (visualize.py:16-24)


def get_color(obj: int, obj_name: str, fmt: str = "array", alpha: int = 255):
    color = _SPECIAL.get(obj_name, NODE_COLORS[obj % 1000])
    if fmt == "string":
        return "#" + "".join("%02X" % c for c in color[::-1]) + "%02X" % alpha
    return tuple(int(c) for c in color)


def draw_boxes(im: np.ndarray, class_names: Sequence[str],
               boxes: np.ndarray, fontscale: float = 0.5, lw: int = 4,
               rels: Optional[np.ndarray] = None) -> np.ndarray:
    """Render labeled boxes; skips objects not touched by ``rels`` when
    given (visualize.py:34-59). ``boxes`` in image pixels."""
    import cv2
    im = ((im - im.min()) / max(im.max() - im.min(), 1e-6) * 255)
    im = im.astype(np.uint8).copy()
    H, W = im.shape[:2]
    for obj, (cls, box) in enumerate(zip(class_names, boxes)):
        if rels is not None and not (
                (rels[:, 0] == obj).any() or (rels[:, 1] == obj).any()):
            continue
        b = np.round(box).astype(int)
        b[0::2] = b[0::2].clip(1, W - 2)
        b[1::2] = b[1::2].clip(1, H - 2)
        color = get_color(obj, cls)[::-1]
        cv2.rectangle(im, (b[0], b[1]), (b[2], b[3]), color, lw)
        cv2.rectangle(im, (b[0], b[1]),
                      (b[0] + len(cls) * int(fontscale * 20),
                       b[1] + int(fontscale ** 0.5 * 30)), color, -1)
        cv2.putText(im, cls, (b[0], b[1] + 15), cv2.FONT_HERSHEY_SIMPLEX,
                    fontscale, (255, 255, 255), 2, cv2.LINE_AA)
    return im


def show_nx(classes: np.ndarray, rels: np.ndarray,
            ind_to_classes: Sequence[str],
            ind_to_predicates: Sequence[str],
            train_triplet_counts: Optional[dict] = None,
            zeroshot_triplets: Optional[set] = None,
            perturbed_nodes: Optional[Sequence[int]] = None,
            name: Optional[str] = None, fontsize: int = 22, ax=None):
    """Draw one scene graph (visualize.py:63-144).

    Edge colors: red = zero-shot (absent from training), blue otherwise;
    edge labels = ``predicate-traincount``. Returns the figure.
    """
    import matplotlib.pyplot as plt
    import networkx as nx

    counts = train_triplet_counts or {}
    zs = zeroshot_triplets or set()

    G = nx.DiGraph()
    node_labels, node_colors, edgecolors, widths = {}, [], [], []
    for obj, cls in enumerate(classes):
        obj_name = ind_to_classes[cls]
        G.add_node(obj, label=obj_name)
        node_labels[obj] = obj_name
        node_colors.append(get_color(obj, obj_name))
        if perturbed_nodes is not None and obj in perturbed_nodes:
            edgecolors.append([0, 0, 0, 255])
            widths.append(8)
        else:
            edgecolors.append([200, *node_colors[-1]])
            widths.append(1)

    # duplicate-(s,o) collapse keeping the first predicate
    # (reference filter_dups(random_edge=False), visualize.py:68)
    first = {}
    for s, o, p in rels:
        first.setdefault((int(s), int(o)), int(p))

    edge_labels = {}
    fwd_seen = set()
    for (s, o), p in first.items():
        key = f"{classes[s]}_{p}_{classes[o]}"
        is_zs = key in zs
        not_in_train = bool(counts) and key not in counts
        # single-edge-per-node-pair heuristic (visualize.py:104-111):
        # when the REVERSE edge is already drawn, remove it — unless this
        # edge is unremarkable and the reverse is labeled 'near'
        if (o, s) in fwd_seen:
            rev_label = edge_labels.get((o, s), "")
            if is_zs or rev_label.split("-")[0] != "near":
                G.remove_edge(o, s)
                del edge_labels[(o, s)]
                fwd_seen.discard((o, s))
            else:
                continue
        fwd_seen.add((s, o))
        # color: red = absent from training; width tiers 8 (zero-shot) /
        # 2 (not in train) / 1 (visualize.py:115-117)
        G.add_edge(s, o,
                   color="red" if not_in_train or is_zs else "blue",
                   weight=8.0 if is_zs else (2.0 if not_in_train else 1.0))
        edge_labels[(s, o)] = \
            f"{ind_to_predicates[p]}-{counts.get(key, 0)}"

    pos = nx.circular_layout(G)
    colors = [G[u][v]["color"] for u, v in G.edges()]
    weights = [G[u][v]["weight"] for u, v in G.edges()]
    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 5))
    else:
        fig = ax.figure
    nx.draw(G, pos=pos, with_labels=False, node_size=2000,
            node_color=np.asarray(node_colors)[:, ::-1] / 255.0, alpha=0.6,
            edge_color=colors, width=weights,
            edgecolors=np.asarray(edgecolors)[:, ::-1] / 255.0,
            linewidths=widths, arrowstyle="-|>", arrowsize=35, ax=ax)
    nx.draw_networkx_labels(G, pos=pos, labels=node_labels,
                            font_weight="bold",
                            font_size=max(fontsize,
                                          min(24, 50 // max(len(classes), 1))),
                            ax=ax)
    nx.draw_networkx_edge_labels(G, pos=pos, edge_labels=edge_labels,
                                 font_color="black",
                                 font_size=fontsize - 4, ax=ax)
    ax.set_xlim(-1.5, 2.5)
    ax.set_ylim(-1.2, 1.2)
    if name is not None:
        fig.savefig(f"{name}.png", transparent=True, bbox_inches="tight")
    return fig
