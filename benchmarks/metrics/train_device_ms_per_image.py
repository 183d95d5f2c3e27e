"""The device's time per training image: the seconds of the window in which
a kernel, a copy or a memset ran on the card (the union of their intervals
in the profiler's CUDA activity over the whole window), over the images of
the window's steps. Every step of the window counts, all of its work on
the card; the time the card stands idle while the host dispatches or
waits is left out, so a change on the host does not move it."""


def read(run):
    rec = run.rec
    if rec.window_steps == 0 or not run.window_busy_s:
        return None
    return (run.window_busy_s * 1e3
            / (rec.window_steps * run.cfg["batch_size"]))
