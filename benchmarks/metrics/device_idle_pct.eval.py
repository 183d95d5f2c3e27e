"""The share of the traced window's wall time (the whole replay of the
set) in which no kernel, copy or memset ran on the device
(torch.profiler's CUDA activity)."""


def read(run):
    tr = run.trace
    if run.ev is None or tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
