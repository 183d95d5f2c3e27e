"""Profiling and metric-logging utilities (``sgg_tpu/utils/profiling.py``).

Counterpart of the reference's wall-clock instrumentation
(``time_per_batch`` in ``main.py:216-232``) and of the torchvision
tutorial's ``MetricLogger``/``SmoothedValue``
(``detector/utils.py:31-232``): a numpy smoothed-metric logger, and trace
capture with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, Optional

import numpy as np
import torch


class SmoothedValue:
    """Windowed median/avg tracker (detector/utils.py:31-74, without the
    cross-process sync)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} "
                 "({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg)


class MetricLogger:
    """log_every-style iteration logger (detector/utils.py:146-232)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}"
                                   for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int,
                  header: str = "") -> Iterator:
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0:
                print(f"{header} [{i}]  {self}  time: {iter_time}  "
                      f"data: {data_time}")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = "sgg_step"):
    """Capture a ``torch.profiler`` trace of the block (host, and the card
    where there is one) into ``log_dir`` as a Chrome trace (view it with
    Perfetto or TensorBoard); the block's queued card work is waited for
    before the capture ends. Without ``log_dir`` the block runs bare.

    Usage::
        with trace("/tmp/sgg_trace"):
            metrics = train_step(batch, generator)
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir)):
        with record_function(name):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace."""
    with torch.profiler.record_function(name):
        yield
