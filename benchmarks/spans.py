"""What the readers of the program's spans share
(``sgg_torch.utils.counters``: the loader's, the GAN thread's and the
trainer's stages, each a span on ``time.time_ns``).

Two windows: the untraced measurement window (``rec.t_start`` to
``rec.t_end``, on ``perf_counter``, put on ``time_ns`` by the offset
between the two clocks when the reader runs), which the span readers
read; and the traced steps (``rec.trace_t``, on ``time_ns`` as the
profiler's kernels are), which the idle readers read. A reader finds
nothing, and returns None, where the program has no recorder (a commit
before it), where the recorder's ring starts after the window's start
(it has dropped part of the window), or where the window holds no span
of the reader's kind.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from sgg_torch.utils import counters
    except ImportError:
        return None
    if not (hasattr(counters, "spans") and hasattr(counters, "earliest_ns")):
        return None
    return counters


def measured_window(run) -> Tuple[int, int]:
    """The untraced window, ``[rec.t_start, rec.t_end]``, in ``time_ns``."""
    offset = time.time_ns() - time.perf_counter() * 1e9
    return (int(run.rec.t_start * 1e9 + offset),
            int(run.rec.t_end * 1e9 + offset))


def starting_in(name: str, t0: int, t1: int, main: bool = False
                ) -> Optional[list]:
    """The spans called ``name`` (of the main thread alone with ``main``)
    that start in ``[t0, t1)``; None where there are none or the recorder
    cannot say (see the module's text)."""
    return _spans(name, t0, t1, main, lambda s: t0 <= s.start_ns < t1)


def overlapping(name: str, t0: int, t1: int, main: bool = False
                ) -> Optional[list]:
    """The spans called ``name`` that overlap ``[t0, t1]``; None as
    ``starting_in``."""
    return _spans(name, t0, t1, main,
                  lambda s: s.start_ns < t1 and s.end_ns > t0)


def _spans(name, t0, t1, main, keep):
    rec = recorder()
    if rec is None or t1 <= t0:
        return None
    first = rec.earliest_ns()
    if first is None or first > t0:
        return None
    me = threading.main_thread().ident
    got = [s for s in rec.spans()
           if s.name == name and keep(s) and (not main or s.thread == me)]
    return got or None


def mean_ms(spans) -> Optional[float]:
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6


def merge(intervals) -> List[list]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_share_inside(run, name: str) -> Optional[float]:
    """The share (%) of the traced steps' wall time in which no kernel
    (``run.trace.kernels``) runs on the device while the main thread is
    inside a span called ``name``."""
    tr = run.trace
    if tr is None:
        return None
    t0, t1 = run.rec.trace_t
    inside = overlapping(name, t0, t1, main=True)
    if inside is None:
        return None
    busy = merge((max(s, t0), min(e, t1)) for _, s, e in tr.kernels
                 if e > t0 and s < t1)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    held = merge((max(s.start_ns, t0), min(s.end_ns, t1)) for s in inside)
    both, i = 0, 0
    for a, b in idle:  # both lists sorted: one sweep
        while i < len(held) and held[i][1] <= a:
            i += 1
        j = i
        while j < len(held) and held[j][0] < b:
            both += min(b, held[j][1]) - max(a, held[j][0])
            j += 1
    return 100.0 * both / (t1 - t0)
