"""Images of the steps launched in the window over the window's seconds on
the host's clock, the device synchronised at both ends: every step of the
window, its loader stalls and syncs included. What a user's epoch costs;
a per-layer metric, read in the untraced window of the ``--trace 1`` run,
because on a loop held by the host its runs spread with the host's speed
(PERF.md section 2) beyond any bound."""


def read(run):
    rec = run.rec
    if rec.window_steps == 0:
        return None
    return rec.window_steps * run.cfg["batch_size"] / rec.window_s
