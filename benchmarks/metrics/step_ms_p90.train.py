"""The 90th percentile of the intervals between consecutive step-end CUDA
events over every step of the window (the first from the window's start):
the device's timeline, on which a loader stall, a host sync or an
allocator hiccup lengthens a step. The 90th, the highest percentile with
ten steps beyond it in a window of the slowest cell (some 150 steps). A
per-layer metric of the trainer's loop: on a loop held by the host its
runs spread too widely (PERF.md section 2) for a bound."""

import numpy as np


def read(run):
    ms = run.rec.step_ms
    if not ms:
        return None
    return float(np.percentile(np.asarray(ms), 90))
