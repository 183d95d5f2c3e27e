"""The work a step needs, counted from the inputs: operations (2 x
multiply-adds) and bytes. Frozen here, so that a share of a peak reads the
same whatever implements the step.

What counts: the real boxes of each image and the edges that the step
samples for it, never a padded slot; the trunk over the whole canvas, as
the model defines it; for a kernel's bound, each input byte read once and
each output byte written once. A backward counts the weight gradient of
every layer that trains and the input gradient only where the input needs
one (the RoI pools and the rasterized pairs take none).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from benchmarks.reference import data as ref_data
from benchmarks.reference.model import FG_FRACTION, POOL, RECT, STRIDE, VGG16

RATIO = 2   # RoIAlign's samples a bin along each axis


def vgg16_convs(S: int) -> List[Tuple[int, int, int]]:
    """(c_in, c_out, side) of the trunk's 3x3 convolutions on an S x S
    canvas."""
    out, c_in, side = [], 3, S
    for v in VGG16:
        if v == "M":
            side //= 2
        else:
            out.append((c_in, v, side))
            c_in = v
    return out


def trunk_flops(B: int, S: int) -> int:
    return sum(2 * 9 * ci * co * s * s for ci, co, s in vgg16_convs(S)) * B


def rects_shapes() -> Tuple[int, int]:
    """(positions of conv1's output, of conv2's) of the rects branch."""
    o1 = (RECT + 2 * 3 - 7) // STRIDE + 1
    p1 = (o1 + 2 * 1 - 3) // 2 + 1
    o2 = (p1 + 2 * 1 - 3) // STRIDE + 1
    return o1 * o1, o2 * o2


def relation_flops(n: int, m: int, cfg: dict,
                   dense_incidence: Tuple[int, int] = None) -> int:
    """Forward and backward of the relation model (the trunk excluded) for
    ``n`` real boxes and ``m`` sampled edges in all. ``dense_incidence``
    ((edge slots, node slots) of one image, times the batch) counts IMP's
    pooling of edge states into nodes as a dense one-hot product, as the
    reference computes it, in place of the ``m`` x hidden sums it needs."""
    C, D, H = cfg["fmap_channels"], cfg["obj_dim"], cfg["hidden_dim"]
    it = cfg["mp_iter"]
    k = POOL * POOL * C
    pos1, pos2 = rects_shapes()
    f = 0
    # (forward flops, 1 + backward multiplier): weight grad always, input
    # grad where the input needs one
    f += 2 * n * k * D * 2              # node fc6: weight grad only
    f += 2 * n * D * D * 3              # node fc7
    f += 2 * m * k * D * 3              # edge fc6 (the rects need its input
    f += 2 * m * D * D * 3              # grad), edge fc7
    f += 2 * m * pos1 * 2 * 49 * (C // 2) * 2   # rects conv1: weight only
    f += 2 * m * pos2 * (C // 2) * 9 * C * 3    # rects conv2
    f += 2 * (n + m) * D * H * 3        # obj_unary, edge_unary
    gru = 2 * H * 3 * H                 # one product of a GRU, a row
    # first calls: the hidden product of a zero carry has no input grad
    f += (n + m) * gru * (3 + 2)
    f += (n + m) * it * gru * 2 * 3     # the iterations' two products
    f += it * 4 * 2 * m * 2 * H * 3     # the four gates
    if dense_incidence is None:
        f += it * 2 * 2 * m * H * 2     # edge states summed into nodes
    else:
        e_slots, n_slots = dense_incidence
        f += it * 2 * 2 * e_slots * n_slots * H * 2
    f += 2 * H * (n * cfg["num_classes"] + m * cfg["num_predicates"]) * 3
    return f


def conv_out(side: int, k: int, pad: int = 0) -> int:
    return side + 2 * pad - k + 1


def d_patch_flops(c_in: int) -> int:
    """One 7 x 7 patch through a class-conditional patch discriminator
    (valid 3x3, 3x3, 1x1, 3x3 convs) whose input has ``c_in`` channels."""
    f, side = 0, 7
    for ci, co, k in d_patch_convs(c_in):
        side = conv_out(side, k)
        f += 2 * side * side * ci * k * k * co
    return f


def spectral_norm_flops(convs) -> int:
    """One power iteration and sigma of each (c_in, c_out, kernel) conv,
    once a call of its discriminator: v = u W^T, u' = v W, sigma = v W
    u'^T."""
    return sum(6 * ci * k * k * co + 2 * co for ci, co, k in convs)


def d_patch_convs(c_in: int):
    C = 512
    return [(c_in, C // 2, 3), (C // 2, C // 4, 3), (C // 4, C // 8, 1),
            (C // 8, 1, 3)]


def d_global_convs(large: bool):
    C = 512
    convs = [(C, C // 2, 3), (C // 2, C // 2, 1), (C // 2, C // 2, 3),
             (C // 2, C // 2, 1), (C // 2, C // 4, 3), (C // 4, C // 4, 1),
             (C // 4, 1, 3)]
    return convs if large else [c for c in convs if c[2] != 1]


def d_global_flops(side: int, large: bool) -> int:
    """One map through the global discriminator (valid 3x3 convs, 1x1
    convs under ``large``, a ceil-mode pool after the first stage on maps
    over 24, floor-mode pools before the last two 3x3 convs)."""
    C = 512
    f = 0

    def conv(side, ci, co, k):
        pad = 0 if k == 1 or side >= 3 else 1
        out = conv_out(side, k, pad)
        return out, 2 * out * out * ci * k * k * co

    plan = [(C, C // 2, 3), (C // 2, C // 2, 1), "ceil", (C // 2, C // 2, 3),
            (C // 2, C // 2, 1), "floor", (C // 2, C // 4, 3),
            (C // 4, C // 4, 1), "floor", (C // 4, 1, 3)]
    first_pool = side > 24
    for step in plan:
        if step == "ceil":
            if first_pool and side >= 6:
                side = -(-side // 2)
            continue
        if step == "floor":
            if side >= 6:
                side //= 2
            continue
        ci, co, k = step
        if k == 1 and not large:
            continue
        side, add = conv(side, ci, co, k)
        f += add
    return f


def generator_flops(nodes: int, edges: int, images: int, side: int,
                    dense_nodes: int = None) -> Tuple[int, int]:
    """The generator's forward for ``nodes`` graph nodes (the real ones and
    each image's background node), ``edges`` graph edges (the annotated
    ones and two a real node to the background) and ``images`` maps of
    ``side``: (its products: the triple convolutions' dense layers, the
    nodes' 7 x 7 convolutions and the refinement network's; its sums: the
    pooling of triples onto nodes and the painting of the real nodes into
    the layout). ``dense_nodes`` (node slots an image) counts the pooling
    as a dense one-hot product, as the reference computes it."""
    E_, H, P_ = 200, 64, 7
    out = H // 2 * P_ * P_
    prod = sums = 0
    obj, pred = E_ + 4, E_
    for i in range(5):
        o = out if i == 4 else H
        prod += 2 * edges * ((2 * obj + pred) * H + H * (2 * H + o))
        sums += 2 * 2 * edges * H * (dense_nodes or 1)
        prod += 2 * nodes * (H * H + H * o)
        obj = pred = H
    real = nodes - images
    prod += 2 * real * P_ * P_ * (H // 2 * 9 * H + H * 9 * H + H * H)
    sums += 2 * real * (side * P_ * P_ * H + side * side * P_ * H)
    dims = (H, 128, 256, 512)
    cur, in_dim = side >> 3, 1
    for i in range(3):
        cur = side if i == 2 else cur * 2
        prod += 2 * cur * cur * 9 * ((dims[0] + in_dim) * dims[i + 1]
                                     + dims[i + 1] * dims[i + 1]) * images
        if cur != side:             # the layout pooled to the stage's size
            sums += 2 * images * H * (cur * side * side + cur * cur * side)
        in_dim = dims[i + 1]
    prod += 2 * side * side * 9 * 512 * 512 * images
    return prod, sums


def gan_step_flops(n: int, m: int, rels: int, images: int, cfg: dict) -> int:
    """A GAN step on top of the relation model's forward and backward:
    the generator's forward and backward (its products 3 x: weight and
    input gradients; its sums 2 x: the input gradient alone), the
    discriminators on the fake features with their input gradients in G
    (2 x), the reconstruction forward and backward on the fake map, and
    the discriminators' real and fake forwards with their weight
    gradients in D (2 x each)."""
    side = cfg["im_scale"] // STRIDE
    prod, sums = generator_flops(n + images, rels + 2 * n, images, side)
    dn = d_patch_flops(512 + cfg["num_classes"])
    de = d_patch_flops(512 + cfg["num_predicates"])
    dg = d_global_flops(side, cfg["largeD"])
    f = 3 * prod + 2 * sums
    f += 2 * (n * dn + m * de + images * dg)          # G: fake, input grads
    f += relation_flops(n, m, cfg)                     # rec
    f += 2 * 2 * (n * dn + m * de + images * dg)      # D: real and fake
    # the spectral norms: one power iteration a discriminator call (G: 1,
    # D: 2, and the update of the stored vectors: 1)
    f += 4 * (spectral_norm_flops(d_patch_convs(512 + cfg["num_classes"]))
              + spectral_norm_flops(d_patch_convs(512 + cfg["num_predicates"]))
              + spectral_norm_flops(d_global_convs(cfg["largeD"])))
    return f


def sampled_edges(n: int, rels: np.ndarray, cfg: dict) -> int:
    """Edges the sampler returns for an image of ``n`` boxes whose relations
    (after the loader's duplicate filter) are ``rels``: the annotated pairs
    up to the FG share, then the other ordered pairs, up to the budget."""
    max_out = min(cfg["max_edges"], cfg["rels_per_img"])
    n = min(n, cfg["max_nodes"])
    valid = [r for r in rels[:cfg["max_edges"]] if r[0] < n and r[1] < n]
    pairs = {(int(r[0]), int(r[1])) for r in valid}
    fg = min(len(valid), int(round(max_out * FG_FRACTION)))
    return min(max_out, fg + n * (n - 1) - len(pairs))


def step_images(n_entries: int, cfg: dict, seed: int, k: int) -> np.ndarray:
    """The entries of the ``k``-th step of a run (epochs follow each other)."""
    B = cfg["batch_size"]
    per_epoch = n_entries // B
    return ref_data.batch_indices(n_entries, B, seed, k // per_epoch,
                                  k % per_epoch)


def step_sizes(split, cfg: dict, seed: int, k: int):
    """([n_i], [m_i]) of the images of step ``k``. Duplicate pairs would
    be filtered by the loader first; the traffic has none."""
    idx = step_images(len(split), cfg, seed, k)
    ns = [min(len(split.gt_classes[i]), cfg["max_nodes"]) for i in idx]
    ms = [sampled_edges(len(split.gt_classes[i]), split.relationships[i],
                        cfg) for i in idx]
    return ns, ms


def step_flops(split, cfg: dict, seed: int, k: int) -> int:
    """The model's operations in training step ``k``."""
    ns, ms = step_sizes(split, cfg, seed, k)
    f = trunk_flops(cfg["batch_size"], cfg["im_scale"])
    f += relation_flops(sum(ns), sum(ms), cfg)
    if cfg.get("gan"):
        idx = step_images(len(split), cfg, seed, k)
        rels = sum(min(len(split.relationships[i]), cfg["max_edges"])
                   for i in idx)
        f += gan_step_flops(sum(ns), sum(ms), rels, len(idx), cfg)
    return f


# -- evaluation -------------------------------------------------------------

def eval_flops(n: int, cfg: dict,
               dense_incidence: Tuple[int, int] = None) -> int:
    """The eval forward of one image of ``n`` real boxes over its ``n(n-1)``
    ordered pairs, the trunk included: the work its valid pairs need,
    whatever rung of the ladder runs them. fc6 runs once on each unordered
    pair's union pool (``n(n-1)/2`` rows) and the rects, constant over the
    pool window, reach it through its spatially summed kernel (a C x D
    product an ordered pair), as the unions' dedup computes it.
    ``dense_incidence`` as in ``relation_flops``."""
    C, D, H = cfg["fmap_channels"], cfg["obj_dim"], cfg["hidden_dim"]
    it = cfg["mp_iter"]
    k = POOL * POOL * C
    m = n * (n - 1)
    pos1, pos2 = rects_shapes()
    if pos2 != 1:
        raise ValueError("the rects reach fc6 through its summed kernel only "
                         "where they are 1 x 1")
    f = trunk_flops(1, cfg["im_scale"])
    f += 2 * n * k * D + 2 * n * D * D          # node fc6, fc7
    f += 2 * (m // 2) * k * D + 2 * m * C * D   # union fc6, the rects
    f += 2 * m * D * D                          # edge fc7
    f += 2 * m * pos1 * 2 * 49 * (C // 2)       # rects conv1
    f += 2 * m * pos2 * (C // 2) * 9 * C        # rects conv2
    f += 2 * (n + m) * D * H                    # obj_unary, edge_unary
    gru = 2 * H * 3 * H
    f += (n + m) * gru * 2 * (1 + it)           # the GRUs' two products
    f += it * 4 * 2 * m * 2 * H                 # the four gates
    if dense_incidence is None:
        f += it * 2 * 2 * m * H                 # edge states into nodes
    else:
        e_slots, n_slots = dense_incidence
        f += it * 2 * 2 * e_slots * n_slots * H
    f += 2 * H * (n * cfg["num_classes"] + m * cfg["num_predicates"])
    return f


def eval_nodes(counts, cfg: dict) -> int:
    """The node slots of a test batch: the configuration's, or the split's
    largest graph rounded up to 8, as ``val_epoch`` sizes them."""
    return max(cfg["max_nodes"], -(-max(counts, default=2) // 8) * 8)


def ladder(cfg: dict, nodes: int) -> List[int]:
    """The rungs of the configuration's ``pair_ladder`` in pair slots an
    image (``null``: every ordered pair of the node slots), those under
    the dense count first, as ``val_epoch`` keeps them."""
    full = nodes * (nodes - 1)
    return [b for b in cfg["pair_ladder"] if b is not None and b < full] \
        + [full]


def rung(batch_counts, rungs: List[int]) -> int:
    """The pair slots an image of a test batch runs: the smallest rung that
    holds every image's valid pairs."""
    need = max(n * (n - 1) for n in batch_counts)
    return next(b for b in rungs if b >= need)


# -- the kernels' bounds ----------------------------------------------------

def roi_align_work(rois: int, B: int, S: int, C: int, elem: int
                   ) -> Tuple[int, int]:
    """(operations, bytes) of one RoIAlign (or its map gradient) over
    ``rois`` real boxes of a batch of B maps of stride 16 on an S canvas:
    4 taps a sample, ``RATIO``^2 samples a bin, a multiply-add each; the
    map read (or its gradient written) once, the boxes read once, the
    pools written (or their gradient read) once."""
    side = S // STRIDE
    out = rois * POOL * POOL * C
    flops = 2 * 4 * RATIO * RATIO * out
    nbytes = B * side * side * C * elem + rois * 16 + out * elem
    return flops, nbytes


def vgg_conv1_work(B: int, S: int, elem: int) -> Tuple[int, int]:
    """(operations, bytes) of the trunk's first convolution with its ReLU:
    3 -> 64 channels, 3 x 3."""
    px = B * S * S
    return 2 * px * 64 * 27, px * (3 + 64) * elem + (27 * 64 + 64) * elem


def bound_s(work: Tuple[int, int], flops_per_s: float,
            bytes_per_s: float) -> float:
    flops, nbytes = work
    return max(flops / flops_per_s, nbytes / bytes_per_s)

