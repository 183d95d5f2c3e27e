"""The share of the traced steps' wall time in which no kernel, copy or
memset ran on the device (torch.profiler's CUDA activity alone)."""


def read(run):
    tr = run.trace
    if tr is None or run.rec.trace_steps == 0 or tr.window_s <= 0 \
            or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
