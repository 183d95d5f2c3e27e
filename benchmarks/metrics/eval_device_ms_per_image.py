"""The device's time per test image: the seconds of the window in which a
kernel, a copy or a memset ran on the card (the union of their intervals
in the profiler's CUDA activity over the whole replay of the set, both
regimes), over the set's images, each counted once though both regimes
evaluate it. The time the card stands idle while the host loads, ranks
or matches is left out, so a change on the host does not move it."""


def read(run):
    ev = run.ev
    if ev is None or not ev.images or not run.window_busy_s:
        return None
    return run.window_busy_s * 1e3 / ev.images
