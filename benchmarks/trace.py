"""The traced steps: ``torch.profiler`` with its CUDA activity alone (the
device's kernels, copies and memsets, and the host's CUDA runtime calls;
recording every host operator as well slowed the GAN cell's steps, whose
dispatch on the host holds them, by 85%) over ``trace_steps`` steps after
the window, reduced to what the per-layer readers and the ``breakdown``
need. In the runs that report the end-to-end metrics the same profiler
covers the whole window, and only its device's busy time is read
(``busy_s``).

- ``kernels``: (name, start_ns, end_ns) of every kernel on the device;
- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device; ``window_s``: the traced steps' wall time,
  from the profiler's start to the device's synchronisation after the
  last step;
- ``device_ops``: the ten kernels that took the most device time, summed
  by name;
- ``idle_gaps``: the device's idle time, summed by what the host was doing
  at each gap's middle: ``step`` where the main thread was inside the
  trainer's step (dispatching its work; an evaluating cell names its own
  intervals, such as ``eval_step`` and ``evaluator``), ``loop`` where it
  was outside (waiting for the next batch, copying it, the epoch's
  interval sync), with the CUDA runtime call running there, if any; the
  ten largest.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    kernels: List[Tuple[str, int, int]]
    busy_s: float
    window_s: float
    device_ops: List[list]
    idle_gaps: List[list]


def start():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else \
        [ProfilerActivity.CPU]
    prof = profile(activities=acts, record_shapes=False, with_stack=False)
    prof.start()
    return prof


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covering(intervals, points):
    """For each of the sorted ``points``, the name of the shortest interval
    (start, end, name) that covers it, or None; one sweep."""
    intervals = sorted(intervals)
    out, i, live = [], 0, []
    for p in points:
        while i < len(intervals) and intervals[i][0] <= p:
            live.append(intervals[i])
            i += 1
        live = [x for x in live if x[1] > p]
        out.append(min(live, key=lambda x: x[1] - x[0])[2] if live else None)
    return out


def _device(prof):
    """(name, start_ns, end_ns) of every kernel, copy and memset that ran
    on the device, and (start_ns, end_ns, name) of the host's CUDA runtime
    calls."""
    device, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name().startswith("cuda"):
            runtime.append((e.start_ns(), e.end_ns(), e.name()))
    return device, runtime


def busy_s(prof) -> float:
    """Seconds in which a kernel, a copy or a memset ran on the device."""
    busy = _merge([(s, e) for _, s, e in _device(prof)[0]])
    return sum(e - s for s, e in busy) / 1e9


def reduce(prof, t0_ns: int, t1_ns: int,
           steps: List[Tuple[int, int]]) -> Trace:
    """The trace of a stopped profiler whose window ran from ``t0_ns`` to
    ``t1_ns`` (``time.time_ns``); ``steps`` are the (start, end) of the
    trainer's step calls on the host in that window, or (start, end,
    name) of what the host was doing."""
    device, runtime = _device(prof)
    kernels = [d for d in device
               if not d[0].lower().startswith(("memcpy", "memset"))]
    busy = _merge([(s, e) for _, s, e in device])
    by_name = {}
    for name, s, e in kernels:
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0) + (e - s)
    device_ops = [[n, ns / 1e9] for n, ns in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) // 2 for a, b in gaps]
    where = _covering([iv if len(iv) == 3 else (*iv, "step")
                       for iv in steps], mids)
    calls = _covering(runtime, mids)
    idle = {}
    for (a, b), w, c in zip(gaps, where, calls):
        key = (w or "loop") + (f" > {c}" if c else "")
        idle[key] = idle.get(key, 0) + (b - a)
    idle_gaps = [[n, ns / 1e9] for n, ns in
                 sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    return Trace(kernels=kernels, busy_s=sum(e - s for s, e in busy) / 1e9,
                 window_s=(t1_ns - t0_ns) / 1e9, device_ops=device_ops,
                 idle_gaps=idle_gaps)
