"""The set's images over the window's seconds on the host's clock, the
device synchronised at both ends: both regimes, the loader, the copies,
the forward and the evaluators. The user's rate of a test split; a
per-layer metric, since the host sets its pace."""


def read(run):
    ev = run.ev
    if ev is None or not ev.images or ev.window_s <= 0:
        return None
    return ev.images / ev.window_s
