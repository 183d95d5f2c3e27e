"""K2 (csrc/vgg_stem.cu, the trunk's first convolution and ReLU): the least
time its work could take on the card (the canvases read once, the
activations written once, the products at the dense bf16 peak) over its
kernel time in the traced steps; its launches as the configuration's
family counts them (``kernel_work``; the IMP family: one a step)."""

import re

from benchmarks import work

K2 = re.compile(r"vgg_conv1_(bf16|f32)_kernel")


def read(run):
    tr = run.trace
    if tr is None or run.rec.trace_steps == 0:
        return None
    ns = sum(e - s for name, s, e in tr.kernels if K2.search(name))
    if ns == 0:
        return None
    launches = run.cell.family.kernel_work(run, "k2")
    if launches is None:
        return None
    pk = run.peaks
    pct = 0.0
    for w, n in launches:
        pct += 100.0 * work.bound_s(w, pk["bf16"], pk["hbm_bytes_per_s"]) * n
    return pct / (ns / 1e9)
