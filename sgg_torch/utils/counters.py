"""Process-wide recorder: event counters and the host threads' spans.

**Counters.** The framework replaces several of the reference's
data-dependent-shape protocols with fixed-shape fast paths guarded by
exact fallbacks: the sgdet candidate-pair budget
(``models/sgdet.py:SGDET_EVAL_MAX_PAIRS``), the predcls/sgcls eval
pair-budget ladder (``eval/driver.py``), and the top-M NMS candidate caps
(``models/detector.py``). Each fast path is exact whenever its cap covers
the data — these counters record how often each cap is hit vs
overflowed, so a run on real data (reference protocol:
``lib/eval.py:125-133``) can report whether the measured speedups
actually applied or the run silently went dense.

**Spans.** ``span(name)`` times a block on the host: the training loop's
stages (the loader's assembly and decode, the GAN's host inputs, the
copies to the device, the wait for a batch, the step and its F, G and D
phases) each open one where the work happens. A closed span is one
record in a ring of the last ``RING`` spans, appended without a lock:
its name, its parent (the innermost span open on the same thread when it
opened), the thread, the batch's ``(epoch, index in epoch)`` or None, its
start and end on ``time.time_ns`` (the clock of torch.profiler's device
timestamps, so spans and kernels lie on one timeline) and, with
``cpu=True``, the thread's CPU time over it. No span waits for the
device. The trainer's interval line reads them; so can anyone,
with ``spans()``.

Usage::

    from sgg_torch.utils import counters
    counters.bump("sgdet_pair_overflow")
    counters.snapshot()   # {"sgdet_pair_overflow": 1, ...}
    counters.rate("sgdet_pair_overflow", "sgdet_batches")
    with counters.span("step", cpu=True):
        ...
    counters.spans(t0_ns, t1_ns)   # [Span(name="step", ...), ...]
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

_lock = threading.Lock()
_counts: Dict[str, int] = {}

RING = 65536
# Only for measuring what the spans cost: off, ``span`` records nothing.
enabled = True
_ring: collections.deque = collections.deque(maxlen=RING)
_local = threading.local()


def bump(name: str, n: int = 1) -> None:
    """Increment counter ``name`` by ``n``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def get(name: str) -> int:
    with _lock:
        return _counts.get(name, 0)


def snapshot() -> Dict[str, int]:
    """Copy of all counters."""
    with _lock:
        return dict(_counts)


def reset() -> None:
    """Zero every counter and empty the ring of spans (tests / per-epoch
    reporting)."""
    with _lock:
        _counts.clear()
    _ring.clear()


def rate(numerator: str, denominator: str) -> float:
    """numerator/denominator as a float; 0.0 when denominator is 0."""
    with _lock:
        d = _counts.get(denominator, 0)
        return (_counts.get(numerator, 0) / d) if d else 0.0


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """Counters accumulated since ``before`` (a prior ``snapshot()``)."""
    now = snapshot()
    out = {k: v - before.get(k, 0) for k, v in now.items()}
    return {k: v for k, v in out.items() if v}


class Span(NamedTuple):
    """One closed span (times in ``time.time_ns``)."""

    name: str
    parent: Optional[str]
    thread: int
    batch: Optional[Tuple[int, int]]
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _open_spans() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


class span:
    """``with span(name, batch=None, cpu=False):`` records the block as
    one span. ``batch`` None takes the thread's batch (``set_batch``);
    the attribute may be changed inside the block. ``cpu``: also the
    thread's CPU nanoseconds (``time.thread_time_ns``)."""

    __slots__ = ("name", "batch", "cpu", "parent", "t0", "c0")

    def __init__(self, name: str, batch: Optional[Tuple[int, int]] = None,
                 cpu: bool = False):
        self.name, self.batch, self.cpu = name, batch, cpu
        self.t0 = None

    def __enter__(self) -> "span":
        if not enabled:
            return self
        stack = _open_spans()
        self.parent = stack[-1].name if stack else None
        if self.batch is None:
            self.batch = getattr(_local, "batch", None)
        stack.append(self)
        self.c0 = time.thread_time_ns() if self.cpu else None
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        if self.t0 is None:
            return False
        cpu = time.thread_time_ns() - self.c0 if self.cpu else None
        _local.open.pop()
        # deque.append is atomic under the interpreter lock
        _ring.append((self.name, self.parent, threading.get_ident(),
                      self.batch, self.t0, t1, cpu))
        return False


def set_batch(ident: Optional[Tuple[int, int]]) -> None:
    """The ``(epoch, index)`` of the batch this thread now works on: the
    spans it opens without a batch carry it (None: no batch)."""
    _local.batch = ident


def spans(t0_ns: Optional[int] = None,
          t1_ns: Optional[int] = None) -> List[Span]:
    """The spans in the ring that lie inside ``[t0_ns, t1_ns]`` (an end
    left None is open), in the order they closed."""
    # one C call under the interpreter lock: no append interleaves
    ring = list(_ring)
    return [Span(*s) for s in ring
            if (t0_ns is None or s[4] >= t0_ns)
            and (t1_ns is None or s[5] <= t1_ns)]


def earliest_ns() -> Optional[int]:
    """The start of the oldest span still in the ring (None when it is
    empty). The ring keeps the last ``RING`` spans: a reader whose window
    starts before this may have lost part of it."""
    return min((s[4] for s in list(_ring)), default=None)
