"""The share of the traced steps' wall time in which no kernel runs on the
device (torch.profiler's CUDA activity) while the trainer's thread is
inside ``step``: the device idle because the host has not yet issued the
work."""

from benchmarks import spans


def read(run):
    return spans.idle_share_inside(run, "step")
