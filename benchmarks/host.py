"""This process's CPU time over a window, by thread: read at the window's
open and close and printed on standard error. The same work done in less
time on the same CPU seconds says the host's cores ran faster, not that
the program changed (``PERF.md`` §2). Linux only; elsewhere a reading is
empty.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _cpu_s(stat_path: str) -> float:
    """User plus system seconds from a ``/proc/.../stat`` file."""
    with open(stat_path) as f:
        rest = f.read().rsplit(")", 1)[1].split()
    return (int(rest[11]) + int(rest[12])) / TICK


def reading() -> dict:
    try:
        threads = {}
        for tid in os.listdir("/proc/self/task"):
            try:
                threads[int(tid)] = _cpu_s(f"/proc/self/task/{tid}/stat")
            except OSError:
                continue
        return {"t": time.perf_counter(),
                "process": _cpu_s("/proc/self/stat"), "threads": threads}
    except OSError:
        return {}


def report(a: dict, b: dict, images: int) -> str:
    """One line: the process's CPU seconds over the window and per image,
    by thread (Python threads by name, the others as ``native``, threads
    that ended in the window as ``ended``)."""
    if not a or not b:
        return "host: not read"
    names = {t.native_id: t.name for t in threading.enumerate()}
    mine: Dict[str, float] = {}
    for tid, s in b["threads"].items():
        name = names.get(tid, "native")
        mine[name] = mine.get(name, 0.0) + s - a["threads"].get(tid, 0.0)
    own = b["process"] - a["process"]
    mine["ended"] = own - sum(mine.values())
    top = sorted(mine.items(), key=lambda kv: -kv[1])[:6]
    return (f"host: {own:.2f} CPU s over {b['t'] - a['t']:.2f} s, "
            f"{own / max(images, 1) * 1e3:.2f} ms an image; by thread: "
            + ", ".join(f"{k} {v:.2f}" for k, v in top))
