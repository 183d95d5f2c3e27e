"""Time several sources of the port's CUDA kernels against each other on
one card, in bfloat16 (K1-bwd-fmap in float32 too).

    python3 bench_kernels.py \\
        --k1 new=sgg_torch/csrc/roi_align.cu --k1 old=<other>/roi_align.cu \\
        --k2 new=sgg_torch/csrc/vgg_stem.cu --k2 old=<other>/vgg_stem.cu \\
        --k1bwd new=sgg_torch/csrc/roi_align_bwd.cu \\
        --k1bwd old=<other>/roi_align_bwd.cu

Run from the root of a checkout, beside ``chip_smoke.py``, whose timer and
boxes it shares. Each ``label=path`` is a source with the C interface of
``csrc/roi_align.cu`` (``--k1``), ``csrc/vgg_stem.cu`` (``--k2``) or
``csrc/roi_align_bwd.cu``'s ``sgg_roi_align_bwd_fmap`` (``--k1bwd``: the
gather's, or the earlier scatter's, which took an f32 scratch map in place
of the workspace; told apart by the gather's layout function). Only the
kernels named are timed; without any option, the package's own sources of
all three. All sources are built at once (one ``nvcc`` each), each is held
against the plain version (the error is reported, not judged: a source
with its loads or stores cut out for a limit study is wrong by design), and
the labels are timed in turns, forward then backward (a b b a), twice, so
that a drift of the card's clocks falls on all alike. Times are CUDA events
over 20 launches after a warm-up. K1 is timed as one forward's two launches
(nodes R=64 + unions R=256 over a 16x37x37x512 map) and each alone; K2 on
16x592x592x3; K1-bwd-fmap in bf16 at the detector pretraining shape (g
3x512x7x7x512 over a 3x37x37x512 map, spatial scale 1/16), at the FPN
stride-4 level's (3x148x148x256, scale 1/4) with the same boxes, and with
512 ROIs an image crowded around one point (a few tiles of each image
hold them all); and in f32 at the GAN cell's shape (24x37x37x512, the
fake map's two launches a step: 64 node slots and 576 edge slots an
image, filled as the cell fills them, ``gan_cell_boxes``). Boxes:
``eval_boxes`` on a 592-pixel canvas.

Prints the card's name and power limit, one line per label, the time
PyTorch's fill takes for the outputs' bytes (what the card needs to write
them and do nothing else), and a JSON object with every reading; needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

from chip_smoke import eval_boxes, time_ms
from sgg_torch.ops import _cuda, roi_align, vgg_stem

ROUNDS = 2  # a b b a, twice


def _variants(module, specs: List[str],
              own=None) -> Dict[str, _cuda.CudaKernel]:
    own = own or module.KERNEL
    if not specs:
        return {"package": own}
    out = {}
    for spec in specs:
        label, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"expected label=path, got {spec!r}")
        out[label] = _cuda.CudaKernel(os.path.abspath(path), own.symbol,
                                      own.argtypes)
    return out


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


def _turns(labels: List[str]) -> List[str]:
    return (labels + labels[::-1]) * ROUNDS


def bench(module, variants, cases, want):
    """cases: name -> zero-argument call of the module's wrapper; want:
    name -> plain f32 result (or absent). Returns label -> readings."""
    own = module.KERNEL
    res = {label: {"ms": {name: [] for name in cases}, "rel_err": {}}
           for label in variants}
    try:
        for label, kernel in variants.items():
            module.KERNEL = kernel
            for name, ref in want.items():
                res[label]["rel_err"][name] = _rel_err(cases[name](), ref)
        for label in _turns(list(variants)):
            module.KERNEL = variants[label]
            for name, fn in cases.items():
                res[label]["ms"][name].append(time_ms(fn))
    finally:
        module.KERNEL = own
    return res


# the earlier scatter's interface: (g, boxes, f32 scratch map, grad, B, H,
# W, C, R, scale, pooled, ratio, dtype, stream)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SCATTER_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]


def _is_gather(kernel: _cuda.CudaKernel) -> bool:
    return hasattr(ctypes.CDLL(str(kernel.library)),
                   "sgg_roi_align_bwd_fmap_layout")


def _fmap_bwd_call(kernel, gather: bool, g, boxes, shape, scale):
    """One launch of a K1-bwd-fmap source as its wrapper makes it (its
    workspace or scratch allocated per call); returns the gradient."""
    B, H, W, C = shape
    R = boxes.shape[1]
    grad = torch.empty(shape, dtype=g.dtype, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream
    if gather:
        out = (ctypes.c_longlong * 7)()
        kernel.helper("sgg_roi_align_bwd_fmap_layout",
                      [_I, _I, _I, _I, _I,
                       ctypes.POINTER(ctypes.c_longlong)])(B, H, W, R, 7, out)
        nbytes = out[4]  # the source's own layout: its tile may differ
        work = torch.empty(-(-nbytes // 4), dtype=torch.int32,
                           device=g.device)
        dtype = 1 if g.dtype == torch.bfloat16 else 0
        kernel.launch(g.data_ptr(), boxes.data_ptr(), work.data_ptr(),
                      work.numel() * 4, grad.data_ptr(), B, H, W, C, R,
                      float(scale), 7, 2, dtype, stream,
                      route=str(g.dtype))
    else:
        work = torch.empty(shape, dtype=torch.float32, device=g.device)
        kernel.launch(g.data_ptr(), boxes.data_ptr(), work.data_ptr(),
                      grad.data_ptr(), B, H, W, C, R, float(scale), 7, 2,
                      1, stream, route="bf16")
    return grad


def gan_cell_boxes(seed: int, B: int = 24):
    """The boxes of the GAN cell's (``benchmarks/``, ``gan_train_jpeg``)
    two K1 launches on the fake map, for one batch of its traffic: the
    nodes (B, 64) of ``vg_jpeg_b24``'s first B entries of ``seed`` on the
    592-pixel canvas (zeros in the empty slots), and the union boxes of the
    576 edge slots that ``sample_edges`` fills from them (every ordered
    pair up to the budget, the annotated ones first; the empty slots
    repeat pairs of the first nodes)."""
    from benchmarks import traffic
    from sgg_torch.ops.boxes import union_boxes
    from sgg_torch.train.assign import sample_edges
    N, E, canvas = 64, 576, 592
    mix = traffic.load_mix("vg_jpeg_b24")
    sizes = traffic.pool_sizes(mix, seed)
    split = traffic.annotations(mix, seed, sizes, B, 151, 51)
    boxes = np.zeros((B, N, 4), np.float32)
    rels = np.zeros((B, E, 3), np.int64)
    n_nodes, n_rels = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for i in range(B):
        h, w = sizes[split.entry_file[i]]
        n = min(len(split.gt_boxes[i]), N)
        boxes[i, :n] = split.gt_boxes[i][:n] * (canvas / max(h, w))
        r = split.relationships[i]
        r = r[(r[:, 0] < n) & (r[:, 1] < n)][:E]
        rels[i, :len(r)] = r
        n_nodes[i], n_rels[i] = n, len(r)
    node_mask = torch.arange(N)[None] < torch.from_numpy(n_nodes)[:, None]
    rel_mask = torch.arange(E)[None] < torch.from_numpy(n_rels)[:, None]
    pairs, _ = sample_edges(torch.Generator().manual_seed(seed),
                            torch.from_numpy(rels), rel_mask, node_mask,
                            max_out=E)
    nodes = torch.from_numpy(boxes)
    return nodes, union_boxes(nodes, pairs[..., 0], pairs[..., 1])


def bench_fmap_bwd(variants, gen, dev):
    """K1-bwd-fmap's sources in turns at five cases; label -> readings."""
    gather = {label: _is_gather(k) for label, k in variants.items()}
    for label, k in variants.items():
        if not gather[label]:
            k.argtypes = SCATTER_ARGTYPES
    B, R = 3, 512
    boxes = eval_boxes(gen, B, R, 592)
    centre = torch.rand(B, 1, 2, generator=gen) * 400 + 96
    half = torch.rand(B, R, 2, generator=gen) * 40 + 8
    crowd = torch.cat([centre - half, centre + half], -1)
    bf16 = torch.bfloat16
    cases = {"pretrain": (boxes, (B, 37, 37, 512), 1 / 16, bf16),
             "fpn_stride4": (boxes, (B, 148, 148, 256), 1 / 4, bf16),
             "crowded": (crowd, (B, 37, 37, 512), 1 / 16, bf16)}
    gan_nodes, gan_unions = gan_cell_boxes(2026)
    for name, bx in (("gan_f32_nodes", gan_nodes),
                     ("gan_f32_unions", gan_unions)):
        cases[name] = (bx, (24, 37, 37, 512), 1 / 16, torch.float32)
    res = {label: {"gather": gather[label], "ms": {n: [] for n in cases},
                   "rel_err": {}} for label in variants}
    calls = {}
    for name, (bx, shape, scale, dtype) in cases.items():
        bx = bx.contiguous().to(dev)
        g = torch.randn(*bx.shape[:2], 7, 7, shape[-1], generator=gen).to(
            dev, dtype)
        want = roi_align.roi_align_backward_reference(
            g, bx, shape[1:3], torch.float32, spatial_scale=scale)
        for label, k in variants.items():
            calls[name, label] = (lambda k=k, gt=gather[label], g=g, bx=bx,
                                  shape=shape, scale=scale:
                                  _fmap_bwd_call(k, gt, g, bx, shape, scale))
            res[label]["rel_err"][name] = _rel_err(calls[name, label](), want)
        del want
    for label in _turns(list(variants)):
        for name in cases:
            res[label]["ms"][name].append(time_ms(calls[name, label]))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1", action="append", default=[])
    ap.add_argument("--k2", action="append", default=[])
    ap.add_argument("--k1bwd", action="append", default=[])
    args = ap.parse_args()
    everything = not (args.k1 or args.k2 or args.k1bwd)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA card visible to torch")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    k1s = _variants(roi_align, args.k1) if args.k1 or everything else {}
    k2s = _variants(vgg_stem, args.k2) if args.k2 or everything else {}
    kbs = (_variants(roi_align, args.k1bwd, roi_align.KERNEL_BWD_FMAP)
           if args.k1bwd or everything else {})
    every = list(k1s.items()) + list(k2s.items()) + list(kbs.items())
    _cuda.build_all([k for _, k in every])
    for label, k in every:
        for line in k.resource_lines():
            print(f"  {label} ({k.source.name}): {line}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    report = {"card": card, "torch": torch.__version__}
    if kbs:
        report["roi_align_bwd_fmap"] = bench_fmap_bwd(kbs, g, dev)
    if k1s or k2s:
        report.update(bench_forward(k1s, k2s, g, dev))
    for kernel, per in report.items():
        if not isinstance(per, dict):
            continue
        for label, r in per.items():
            if not isinstance(r, dict) or "ms" not in r:
                continue
            ms = {n: f"min {min(v):.4f} mean {sum(v) / len(v):.4f}"
                  for n, v in r["ms"].items()}
            print(f"{kernel} {label}: ms {ms}; rel err vs plain "
                  f"{r['rel_err']}", flush=True)
    print(json.dumps(report), flush=True)


def bench_forward(k1s, k2s, g, dev):
    """K1 and K2 forward sources in turns at the eval shapes."""
    B, H, C, canvas = 16, 37, 512, 592
    fmap = torch.rand(B, H, H, C, generator=g).to(dev)
    nodes = eval_boxes(g, B, 64, canvas).to(dev)
    unions = eval_boxes(g, B, 256, canvas).to(dev)
    f16 = fmap.bfloat16()

    def k1_nodes():
        return roi_align.roi_align(f16, nodes, spatial_scale=1 / 16)

    def k1_unions():
        return roi_align.roi_align(f16, unions, spatial_scale=1 / 16)

    def k1_forward():
        k1_nodes()
        k1_unions()

    out = {}
    if k1s:
        want1 = {"unions": roi_align.roi_align_reference(
            fmap, unions, spatial_scale=1 / 16)}
        out["roi_align"] = bench(roi_align, k1s,
                                 {"forward": k1_forward, "nodes": k1_nodes,
                                  "unions": k1_unions}, want1)
        del want1
    del fmap
    x = torch.randn(B, canvas, canvas, 3, generator=g).to(dev)
    w = (torch.randn(3, 3, 3, 64, generator=g) * math.sqrt(2 / 27)).to(dev)
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    if k2s:
        want2 = {"conv": vgg_stem.vgg_conv1_reference(x, w, b)}
        x16 = x.bfloat16()
        out["vgg_conv1"] = bench(vgg_stem, k2s,
                                 {"conv": lambda: vgg_stem.vgg_conv1(
                                     x16, w, b)}, want2)
    del x
    # what the card takes to write the kernels' outputs and nothing else
    # (PyTorch's fill of as many bytes): the practical floor of a kernel
    # that is bound by its output write
    out1 = torch.empty(B * (64 + 256) * 49 * C, dtype=torch.bfloat16,
                       device=dev)
    out2 = torch.empty(B * canvas * canvas * 64, dtype=torch.bfloat16,
                       device=dev)
    out["fill_ms"] = {"roi_align": time_ms(out1.zero_),
                      "vgg_conv1": time_ms(out2.zero_)}
    print(f"fill of the outputs' bytes: ms {out['fill_ms']}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
