"""The share of the traced steps' wall time in which no kernel runs on the
device (torch.profiler's CUDA activity) while the trainer's thread is
inside ``batch.wait``: the device idle because the step waits for its
batch."""

from benchmarks import spans


def read(run):
    return spans.idle_share_inside(run, "batch.wait")
