"""K2 (csrc/vgg_stem.cu, the trunk's first convolution and ReLU): the least
time its work could take on the card (the canvases read once, the
activations written once, the products at the dense bf16 peak) over its
kernel time in the traced steps."""

import re

from benchmarks import work

ELEM = {"bfloat16": 2, "float32": 4}
K2 = re.compile(r"vgg_conv1_(bf16|f32)_kernel")


def read(run):
    tr = run.trace
    if tr is None or run.rec.trace_steps == 0:
        return None
    ns = sum(e - s for name, s, e in tr.kernels if K2.search(name))
    if ns == 0:
        return None
    cfg, pk = run.cfg, run.peaks
    one = work.bound_s(work.vgg_conv1_work(cfg["batch_size"], cfg["im_scale"],
                                           ELEM[cfg["compute_dtype"]]),
                       pk["bf16"], pk["hbm_bytes_per_s"])
    return 100.0 * one * run.rec.trace_steps / (ns / 1e9)
