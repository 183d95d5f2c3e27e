"""The share of the step's issue during which its thread was not running:
100 x (1 - the thread's CPU time / the wall time), summed over the
``step`` spans that start in the untraced window. Off the CPU is waiting
for the interpreter lock (shared with the loader's and the GAN's
threads), or blocked in a CUDA runtime call or the allocator."""

from benchmarks import spans


def read(run):
    steps = spans.starting_in("step", *spans.measured_window(run),
                              main=True)
    steps = [s for s in steps or () if s.cpu_ns is not None]
    wall = sum(s.end_ns - s.start_ns for s in steps)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s.cpu_ns for s in steps) / wall)
