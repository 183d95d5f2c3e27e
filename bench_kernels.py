"""Time several sources of the port's CUDA kernels against each other on
one card, at the evaluation path's shapes in bfloat16.

    python3 bench_kernels.py \\
        --k1 new=sgg_torch/csrc/roi_align.cu --k1 old=<other>/roi_align.cu \\
        --k2 new=sgg_torch/csrc/vgg_stem.cu --k2 old=<other>/vgg_stem.cu

Run from the root of a checkout, beside ``chip_smoke.py``, whose timer and
boxes it shares. Each ``label=path`` is a source with the C interface of
``csrc/roi_align.cu`` (``--k1``) or ``csrc/vgg_stem.cu`` (``--k2``); without
any, the package's own sources are timed. All sources are built at once
(one ``nvcc`` each), each is held against the plain version (the error is
reported, not judged: a source with its loads or stores cut out for a limit
study is wrong by design), and the labels are timed in turns, forward then
backward (a b b a), twice, so that a drift of the card's clocks falls on
all alike. Times are CUDA events over 20 launches after a warm-up. K1 is
timed as one forward's two launches (nodes R=64 + unions R=256 over a
16x37x37x512 map) and each alone; K2 on 16x592x592x3.

Prints the card's name and power limit, one line per label, the time
PyTorch's fill takes for the outputs' bytes (what the card needs to write
them and do nothing else), and a JSON object with every reading; needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from typing import Dict, List

import torch

from chip_smoke import eval_boxes, time_ms
from sgg_torch.ops import _cuda, roi_align, vgg_stem

ROUNDS = 2  # a b b a, twice


def _variants(module, specs: List[str]) -> Dict[str, _cuda.CudaKernel]:
    own = module.KERNEL
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1", action="append", default=[])
    ap.add_argument("--k2", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: no CUDA card visible to torch")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    k1s = _variants(roi_align, args.k1)
    k2s = _variants(vgg_stem, args.k2)
    _cuda.build_all(list(k1s.values()) + list(k2s.values()))
    for label, k in list(k1s.items()) + list(k2s.items()):
        for line in k.resource_lines():
            print(f"  {label} ({k.source.name}): {line}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
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

    want1 = {"unions": roi_align.roi_align_reference(fmap, unions,
                                                     spatial_scale=1 / 16)}
    res1 = bench(roi_align, k1s,
                 {"forward": k1_forward, "nodes": k1_nodes,
                  "unions": k1_unions}, want1)
    del want1, fmap
    x = torch.randn(B, canvas, canvas, 3, generator=g).to(dev)
    w = (torch.randn(3, 3, 3, 64, generator=g) * math.sqrt(2 / 27)).to(dev)
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    want2 = {"conv": vgg_stem.vgg_conv1_reference(x, w, b)}
    x16 = x.bfloat16()
    del x
    res2 = bench(vgg_stem, k2s,
                 {"conv": lambda: vgg_stem.vgg_conv1(x16, w, b)}, want2)
    # what the card takes to write the kernels' outputs and nothing else
    # (PyTorch's fill of as many bytes): the practical floor of a kernel
    # that is bound by its output write
    out1 = torch.empty(B * (64 + 256) * 49 * C, dtype=torch.bfloat16,
                       device=dev)
    out2 = torch.empty(B * canvas * canvas * 64, dtype=torch.bfloat16,
                       device=dev)
    fill = {"roi_align": time_ms(out1.zero_),
            "vgg_conv1": time_ms(out2.zero_)}
    print(f"fill of the outputs' bytes: ms {fill}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "roi_align": res1, "vgg_conv1": res2, "fill_ms": fill}
    for kernel in ("roi_align", "vgg_conv1"):
        for label, r in report[kernel].items():
            ms = {n: f"min {min(v):.4f} mean {sum(v) / len(v):.4f}"
                  for n, v in r["ms"].items()}
            print(f"{kernel} {label}: ms {ms}; bf16 rel err vs plain "
                  f"{r['rel_err']}", flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    sys.exit(main())
