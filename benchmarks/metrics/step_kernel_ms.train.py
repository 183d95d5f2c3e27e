"""Device kernel time a step: every kernel of the traced steps, summed,
over their number (copies and memsets left out)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or run.rec.trace_steps == 0:
        return None
    ns = sum(e - s for _, s, e in tr.kernels)
    return ns / 1e6 / run.rec.trace_steps
