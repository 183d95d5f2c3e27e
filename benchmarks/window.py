"""The measured window: ``Trainer.train_epoch`` driven through a wrapper
of its step, from the benchmark's side.

The wrapper replaces the trainer's ``train_step`` (or ``gan_step``)
attribute. Its calls, in order:

1. the check steps: after the first, the optimizers' state is copied to
   the host, after the last the parameters, and each step's losses are
   kept (the comparison that decides ``correct`` reads them once the
   window has closed);
2. the warm-up steps, which fill the loader's queues and the allocator;
3. the window: the device is synchronised, the host clock read and a
   CUDA event recorded; after every step another event; before the first
   step past ``seconds`` the device is synchronised and the clock read
   again. With ``trace_window`` (the runs that report the end-to-end
   metrics) the whole window runs under ``torch.profiler``'s CUDA
   activity, started after the first synchronisation and stopped after
   the last, so that every kernel of the window's steps is in it;
4. with ``--trace 1``, ``trace_steps`` more steps under ``torch.profiler``
   (``trace.py``), the device synchronised before and after, each step's
   call timed on the host's clock.

Then the wrapper raises ``WindowClosed``, which ends the epoch.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Callable, Dict, List, Optional

import torch


class WindowClosed(Exception):
    """Raised from inside the epoch once the window has closed."""


class Clock:
    """Step-end marks on the device's timeline: CUDA events on a card; on
    the CPU (the tests' rehearsal only) the host's clock stands in."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


@dataclasses.dataclass
class Record:
    """What a run keeps of the program's steps."""

    losses: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    opt_state: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    window_first_step: int = 0
    window_steps: int = 0
    t_start: float = 0.0
    t_end: float = 0.0
    step_ms: List[float] = dataclasses.field(default_factory=list)
    window_profile: object = None
    trace_first_step: int = 0
    trace_steps: int = 0
    profile: object = None
    trace_t: tuple = (0.0, 0.0)
    trace_spans: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start


class Stepper:
    """Wraps one step function of the trainer; see the module's text."""

    def __init__(self, step_fn: Callable, *, check_steps: int,
                 warmup_steps: int, seconds: float, trace_steps: int,
                 clock: Clock, opt_state: Callable[[], Dict],
                 params: Callable[[], Dict], trace_window: bool = False):
        self.fn = step_fn
        self.trace_window = trace_window
        self.n_check, self.n_warm = check_steps, warmup_steps
        self.seconds = seconds
        self.n_trace = trace_steps
        self.clock = clock
        self.opt_state, self.params = opt_state, params
        self.start_profile = self.stop_profile = None
        self.rec = Record()
        self.k = 0
        self.phase = "setup"
        self.marks: list = []
        self.on_first_step: Optional[Callable] = None
        self.on_window: Optional[Callable[[str], None]] = None

    def __call__(self, *args, **kw):
        self._before()
        t0 = time.time_ns()
        out = self.fn(*args, **kw)
        if self.phase == "trace":
            self.rec.trace_spans.append((t0, time.time_ns()))
        self._after(out)
        self.k += 1
        return out

    def _before(self) -> None:
        rec = self.rec
        if self.phase == "setup" and self.k == self.n_check + self.n_warm:
            self.clock.sync()
            if self.trace_window:
                self.start_profile()
            rec.t_start = time.perf_counter()
            rec.window_first_step = self.k
            self.marks = [self.clock.mark()]
            self.phase = "window"
            if self.on_window is not None:
                self.on_window("open")
        if self.phase == "window" and \
                time.perf_counter() - rec.t_start >= self.seconds:
            self.clock.sync()
            rec.t_end = time.perf_counter()
            rec.window_steps = self.k - rec.window_first_step
            rec.step_ms = [self.clock.ms(a, b) for a, b in
                           zip(self.marks[:-1], self.marks[1:])]
            if self.on_window is not None:
                self.on_window("close")
            if self.trace_window:
                rec.window_profile = self.stop_profile()
            if self.n_trace <= 0:
                raise WindowClosed
            self.phase = "trace"
            rec.trace_first_step = self.k
            self.start_profile()
            rec.trace_t = (time.time_ns(), 0)
        if self.phase == "trace" and \
                self.k - rec.trace_first_step >= self.n_trace:
            self.clock.sync()
            rec.trace_t = (rec.trace_t[0], time.time_ns())
            rec.profile = self.stop_profile()
            rec.trace_steps = self.k - rec.trace_first_step
            raise WindowClosed

    def _after(self, out) -> None:
        rec = self.rec
        if self.phase == "setup" and self.k < self.n_check:
            rec.losses.append({k: v for k, v in out.items()
                               if not k.startswith("grad")
                               and k != "total"})
            if self.k == 0:
                rec.opt_state = self.opt_state()
                if self.on_first_step is not None:
                    self.on_first_step()
            if self.k == self.n_check - 1:
                rec.params = self.params()
                rec.losses = [{k: float(v) for k, v in d.items()}
                              for d in rec.losses]
        elif self.phase == "window":
            self.marks.append(self.clock.mark())


def run_epochs(trainer, attr: str, stepper: Stepper) -> Record:
    """Drive ``trainer.train_epoch`` with ``stepper`` in place of the
    trainer's ``attr`` until the window has closed. An epoch that ends
    first (a program faster than the split was sized for) is followed by
    the next."""
    setattr(trainer, attr, stepper)
    epoch = 0
    try:
        while True:
            try:
                trainer.train_epoch(epoch)
            except WindowClosed:
                break
            epoch += 1
    finally:
        gc.collect()
    return stepper.rec


def wait_threads(timeout_s: float = 60.0) -> List[str]:
    """Wait for every thread but this one to end; the names of those that
    did not."""
    deadline = time.time() + timeout_s
    main = threading.current_thread()
    while True:
        gc.collect()
        left = [t for t in threading.enumerate()
                if t is not main and t.is_alive()]
        if not left or time.time() > deadline:
            return [t.name for t in left]
        time.sleep(0.05)
