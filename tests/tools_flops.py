"""Shared by the profiler tests (``tests/test_torch_tools_profile.py``,
``tests/test_torch_tools_gan.py``): the in-process runner, the CPU-run
checks and the analytic FLOP counts.

The analytic count is 2 x the multiply-adds of every product and
convolution a stage runs (every tap of a padded convolution counted, as
``torch.utils.flop_counter`` counts them), plus the hand-written kernels'
formula counts (``sgg_torch/utils/profiling.py``). It is not XLA's
``cost_analysis``, which leaves out the taps that fall on the padding. A
train step's count includes its backward, product by product: a weight's
gradient wherever the weight trains, an input's wherever the input needs
one.
"""

import contextlib
import io
import json
import math
import os

import pytest

from sgg_torch.models.backbone import VGG16_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-6
C_MAP, P = 512, 7  # VGG16 map channels, the RoIAlign pool
NC, NR = 151, 51  # VG-Stanford classes and predicates


def run(main, argv):
    """``main(argv)`` in process; its stdout and last line parsed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    return json.loads(out.strip().splitlines()[-1]), out


# ---------------------------------------------------------------- analytic

def trunk_flops(B, img):
    h, c, total = img, 3, 0
    for v in VGG16_CFG:
        if v == "M":
            h //= 2
            continue
        total += 2 * B * h * h * c * v * 9
        c = v
    return total


def k1_flops(rois):
    return 2 * rois * P * P * C_MAP * 16


def rects_fwd(rows):
    # conv 7x7/16 (2 -> 256) on 27 x 27 -> 2 x 2, then 3x3/16 (256 -> 512)
    return 2 * rows * 4 * 98 * 256 + 2 * rows * 2304 * 512


def head_fwd(rows, obj):
    return 2 * rows * (P * P * C_MAP * obj + obj * obj)


def gru(rows, H):
    return 2 * rows * H * 3 * H


def imp_fwd(B, N, E, obj, H):
    f = 2 * B * N * obj * H + 2 * B * E * obj * H
    f += 2 * gru(B * N, H) + 2 * gru(B * E, H)
    per = (4 * 2 * B * E * 2 * H + 2 * gru(B * E, H)
           + 2 * 2 * B * N * E * H + 2 * gru(B * N, H))
    return f + 3 * per + 2 * B * N * H * NC + 2 * B * E * H * NR


def imp_bwd(B, N, E, obj, H):
    f = 2 * (2 * B * N * obj * H + 2 * B * E * obj * H)
    # the first GRU calls run on zero carries: no carry gradient
    f += 3 * gru(B * N, H) + 3 * gru(B * E, H)
    per = (2 * 4 * 2 * B * E * 2 * H + 4 * gru(B * E, H)
           + 2 * 2 * B * N * E * H + 4 * gru(B * N, H))
    return f + 3 * per + 2 * (2 * B * N * H * NC + 2 * B * E * H * NR)


def relation_fwd(B, N, E, obj, H):
    """Everything of the relation model's forward after the trunk."""
    return (k1_flops(B * N) + k1_flops(B * E) + rects_fwd(B * E)
            + head_fwd(B * N, obj) + head_fwd(B * E, obj)
            + imp_fwd(B, N, E, obj, H))


def train_step(B, N, E, img, obj, H):
    fc6 = P * P * C_MAP * obj
    bwd = (2 * B * N * fc6 + 2 * 2 * B * N * obj * obj  # node head
           + 2 * 2 * B * E * fc6 + 2 * 2 * B * E * obj * obj  # edge head
           + 2 * 2 * B * E * 2304 * 512 + 2 * B * E * 4 * 98 * 256  # rects
           + imp_bwd(B, N, E, obj, H))
    return trunk_flops(B, img) + relation_fwd(B, N, E, obj, H) + bwd


def sn_conv(rows, hw_out, cin, cout, k):
    """One spectrally normalized conv: its power iteration and sigma, then
    the conv."""
    K = k * k * cin
    return 3 * 2 * K * cout + 2 * cout + 2 * rows * hw_out ** 2 * K * cout


def patch_disc(rows, cin, n_ch=512):
    return (sn_conv(rows, 5, cin, n_ch // 2, 3)
            + sn_conv(rows, 3, n_ch // 2, n_ch // 4, 3)
            + sn_conv(rows, 3, n_ch // 4, n_ch // 8, 1)
            + sn_conv(rows, 1, n_ch // 8, 1, 3))


def global_disc(B, s, fmap_sz, c=512):
    """GlobalDiscriminator(large=True) on an s x s map."""
    f = 0

    def conv3(s, cin, cout):
        out = s - 2 if s >= 3 else s
        return sn_conv(B, out, cin, cout, 3), out

    n, s = conv3(s, c, c // 2)
    f += n + sn_conv(B, s, c // 2, c // 2, 1)
    if fmap_sz > 24 and s >= 6:
        s = -(-s // 2)
    n, s = conv3(s, c // 2, c // 2)
    f += n + sn_conv(B, s, c // 2, c // 2, 1)
    s = s // 2 if s >= 6 else s
    n, s = conv3(s, c // 2, c // 4)
    f += n + sn_conv(B, s, c // 4, c // 4, 1)
    s = s // 2 if s >= 6 else s
    n, s = conv3(s, c // 4, 1)
    return f + n


def generator_fwd(B, N, E, fmap, h, n_layers, n_ch=512, emb=200):
    """G: the graph convs over the dummy-extended graph, the node convs,
    the projection, the layout's two products, the CRN."""
    Nd, Ed = N + 1, E + 2 * N
    out_last = h // 2 * P * P
    f, d_obj, d_pred = 0, emb + 4, emb
    for i in range(n_layers):
        out = out_last if i == n_layers - 1 else h
        f += 2 * B * Ed * ((2 * d_obj + d_pred) * h + h * (2 * h + out))
        f += 2 * 2 * B * Nd * Ed * h
        f += 2 * B * Nd * (h * h + h * out)
        d_obj = d_pred = h
    rows = B * N * P * P
    f += 2 * rows * (h // 2 * 9) * h + 2 * rows * h * 9 * h + 2 * rows * h * h
    f += 2 * B * N * fmap * P * P * h + 2 * B * fmap * fmap * N * P * h
    dims = (h, n_ch // 4, n_ch // 2, n_ch)
    s, cin = fmap >> 3, 1
    for i in range(3):
        s = fmap if i == 2 else 2 * s
        if s != fmap:  # the layout's adaptive pool: rows, then columns
            f += 2 * B * h * s * fmap * fmap + 2 * B * h * s * s * fmap
        f += 2 * B * s * s * (h + cin) * 9 * dims[i + 1]
        f += 2 * B * s * s * dims[i + 1] * 9 * dims[i + 1]
        cin = dims[i + 1]
    return f + 2 * B * fmap * fmap * n_ch * 9 * n_ch


def close(got, want):
    return got == pytest.approx(want, rel=REL)


def no_card_numbers(line):
    """CPU runs: no card time, no MFU, no kernel launch (the wrappers run
    their plain versions on CPU tensors)."""
    for name, st in line["stages"].items():
        assert st["card_ms"] is None and st["mfu"] is None, name
        assert not any(st["launches"].values()), name
        assert st["wall_ms"] > 0 and math.isfinite(st["wall_ms"]), name


def jax_names_exist(tool, names):
    src = open(os.path.join(REPO, "tools", tool)).read()
    missing = [n for n in names if n not in src]
    assert not missing, missing


TINY = ["-device", "cpu", "--tiny", "--iters", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread: the suite runs several files at once, each
    on a worker, and full thread pools would oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
