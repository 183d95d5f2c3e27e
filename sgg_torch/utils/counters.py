"""Process-wide event counters for exactness-cap instrumentation.

The framework replaces several of the reference's data-dependent-shape
protocols with fixed-shape fast paths guarded by exact fallbacks: the
sgdet candidate-pair budget (``models/sgdet.py:SGDET_EVAL_MAX_PAIRS``),
the predcls/sgcls eval pair-budget ladder (``eval/driver.py``), and the
top-M NMS candidate caps (``models/detector.py``). Each fast path is
exact whenever its cap covers the data — these counters record how often
each cap is hit vs overflowed, so a run on real data (reference protocol:
``lib/eval.py:125-133``) can report whether the measured
speedups actually applied or the run silently went dense.

Usage::

    from sgg_torch.utils import counters
    counters.bump("sgdet_pair_overflow")
    ...
    counters.snapshot()   # {"sgdet_pair_overflow": 1, ...}
    counters.rate("sgdet_pair_overflow", "sgdet_batches")
"""

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_counts: Dict[str, int] = {}


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
    """Zero every counter (tests / per-epoch reporting)."""
    with _lock:
        _counts.clear()


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
