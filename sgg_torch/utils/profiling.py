"""Profiling utilities (``sgg_tpu/utils/profiling.py``).

Trace capture with ``torch.profiler`` and named regions in it (the
reference's wall-clock instrumentation, ``time_per_batch`` in
``main.py:216-232``, is the trainer's interval line, read from
``utils/counters.py``'s spans); and the stage profiling of the tools
(``sgg_torch/tools/profile_*.py``): the card's published peaks, card and
wall times of a stage, FLOP counts that include the hand-written kernels,
and each tool's JSON line.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional, Tuple

import torch

from sgg_torch.utils import counters


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
    """A span of the program's recorder (``counters.span``) and, while a
    torch profiler records, a named region in its trace."""
    with counters.span(name):
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield


# ---------------------------------------------------------------------------
# Stage profiling on the card (``sgg_torch/tools/profile_*.py``)

# Published dense peaks (NVIDIA data sheets): HBM bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores, TF32 tensor FLOP/s. The rates
# assume the card's full power limit; the tools print the limit beside
# every number.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12, 378e12),
         "H100 NVL": (3.9e12, 835e12, 60e12, 418e12),
         "H200": (4.8e12, 989e12, 67e12, 495e12),
         "H100": (3.35e12, 989e12, 67e12, 495e12)}


def card_peaks(name: str):
    """(table key, (bytes/s, bf16 FLOP/s, f32 FLOP/s, tf32 FLOP/s)) of the
    card named ``name`` (``torch.cuda.get_device_name``); an unknown name
    reads as the H100 SXM."""
    for key, peaks in PEAKS.items():
        if all(part in name for part in key.split()):
            return key, peaks
    return "H100", PEAKS["H100"]


def device_info(device: torch.device) -> Dict[str, Optional[str]]:
    """The device's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the CPU: its type)."""
    if device.type != "cuda":
        return {"type": "cpu", "name": "cpu", "power_limit": None}
    import subprocess
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, limit = (s.strip() for s in smi.strip().splitlines()[0].split(","))
    return {"type": "cuda", "name": name, "power_limit": limit,
            "torch_name": torch.cuda.get_device_name(device)}


# -- flop counts of the hand-written kernels, by formula ---------------------
# The kernels are loaded with ctypes (``ops/_cuda.py``): their launches never
# pass through the dispatcher, so ``FlopCounterMode`` counts them as zero.
# Each wrapper reports its formula count here instead, and what its plain
# version dispatches on the CPU is left out, so a stage counts the same on
# both devices. The counts are 2 x the multiply-adds of the dense algorithm:
# RoIAlign: every output element averages ratio^2 samples of 4 bilinear
# taps; its map gradient spreads the same taps back; its box gradient takes
# each sample's derivative along both axes (4 taps each); the VGG stem: a
# 27-deep product a pixel and channel; its weight and bias gradient: the
# 28-deep product of the masked gradient with the patches and a 1.

def roi_align_flops(n_out: int, ratio: int) -> int:
    """K1 (and K1-bwd-fmap) on ``n_out`` = B R P P C output elements."""
    return 2 * n_out * ratio * ratio * 4


def roi_align_boxes_grad_flops(n_out: int, ratio: int) -> int:
    """K1-bwd-boxes on ``n_out`` = B R P P C gradient elements."""
    return 2 * roi_align_flops(n_out, ratio)


def vgg_conv1_flops(n_px: int) -> int:
    """K2 on ``n_px`` = B H W pixels (3 -> 64 channels, 3 x 3)."""
    return 2 * n_px * 64 * 27


def vgg_conv1_bwd_flops(n_px: int) -> int:
    """K2-bwd on ``n_px`` pixels: the weight's 27 taps and the bias."""
    return 2 * n_px * 64 * 28


class _Tally:
    def __init__(self, mode):
        self.mode = mode
        self.kernels = 0
        self.excluded = 0


_TALLIES: list = []  # the active ``count_flops`` calls, innermost last


@contextlib.contextmanager
def kernel_flops(n: int):
    """The region of one hand-written kernel's wrapper (the kernel on the
    card, its plain version on the CPU): under ``count_flops`` it adds the
    kernel's formula count ``n`` and leaves out what the region dispatches.
    Costs a list check otherwise."""
    if not _TALLIES:
        yield
        return
    tally = _TALLIES[-1]
    before = tally.mode.get_total_flops()
    try:
        yield
    finally:
        tally.excluded += tally.mode.get_total_flops() - before
        tally.kernels += n


def count_flops(fn) -> Tuple[object, int]:
    """(fn(), its FLOPs): the products and convolutions that
    ``torch.utils.flop_counter.FlopCounterMode`` counts (2 x multiply-adds,
    every tap of a padded convolution included) plus the hand-written
    kernels' formula counts (``kernel_flops``), on either device."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    tally = _Tally(mode)
    with mode:
        _TALLIES.append(tally)
        try:
            out = fn()
        finally:
            _TALLIES.pop()
    return out, mode.get_total_flops() - tally.excluded + tally.kernels


def stage_ms(fn, device: torch.device, iters: int = 10,
             warmup: int = 2) -> Dict[str, Optional[float]]:
    """Mean milliseconds of ``fn`` over ``iters`` calls after ``warmup``:
    ``card_ms`` by CUDA events around the calls (None on the CPU: no card
    time was measured), ``wall_ms`` by the host's clock around the calls
    and the wait for the card. A stage whose wall time far exceeds its card
    time is held by the host (launches, syncs, Python)."""
    for _ in range(warmup):
        fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if cuda:
        start.record()
    for _ in range(iters):
        fn()
    if cuda:
        end.record()
        torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return {"card_ms": start.elapsed_time(end) / iters if cuda else None,
            "wall_ms": wall}


def hand_written_kernels() -> Dict:
    """Every CUDA kernel of the port by its row name in ``chip_smoke.py``'s
    ``kernels`` line."""
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    return {"roi_align": K1.KERNEL, "roi_align_bwd_fmap": K1.KERNEL_BWD_FMAP,
            "roi_align_bwd_boxes": K1.KERNEL_BWD_BOXES,
            "vgg_conv1": K2.KERNEL, "vgg_conv1_bwd": K2.KERNEL_BWD}


def launch_counts() -> Dict[str, Dict[str, int]]:
    """Every hand-written kernel's launches in this process, by kernel, in
    all and by route."""
    return {n: {"launches": k.launches, **k.routes}
            for n, k in hand_written_kernels().items()}


def _launch_delta(after, before) -> Dict[str, int]:
    return {n: after[n]["launches"] - before[n]["launches"] for n in after}


class StageProfiler:
    """Times a tool's stages and prints them, one line a stage, then the
    JSON line (``line``): per stage card ms, wall ms, FLOPs, TF/s and MFU
    against ``card_peaks`` of the card that ran it (None on the CPU), and
    the kernels' launches in one call; the kernels' launches in the whole
    run; the device's name and power limit.

    ``peak`` picks the rate an MFU is read against: ``bf16`` (the tensor
    cores' bf16 rate) or ``f32`` (the TF32 rate where PyTorch lets cuDNN or
    cuBLAS use TF32, as it does cuDNN's by default, else the CUDA cores'
    f32 rate).
    """

    def __init__(self, tool: str, device: torch.device, peak: str = "bf16",
                 iters: int = 10, warmup: int = 2, batch: int = 1):
        self.tool, self.device = tool, device
        self.iters, self.warmup, self.batch = iters, warmup, batch
        self.info = device_info(device)
        self.stages: Dict[str, Dict] = {}
        self.peak = peak
        self.peaks = None
        if device.type == "cuda":
            key, self.peaks = card_peaks(torch.cuda.get_device_name(device))
            self.info["peaks"] = key
            self.info["peak_tflops"] = {p: self.peak_flops(p) / 1e12
                                        for p in ("bf16", "f32")}
        print(f"{tool} on {self.info['name']} "
              f"({self.info['power_limit'] or 'no card'})", flush=True)

    def peak_flops(self, peak: str) -> float:
        _, bf16, f32, tf32 = self.peaks
        tf = torch.backends.cudnn.allow_tf32 \
            or torch.backends.cuda.matmul.allow_tf32
        return bf16 if peak == "bf16" else (tf32 if tf else f32)

    def stage(self, name: str, fn, *, iters: Optional[int] = None,
              flops: bool = True, peak: Optional[str] = None):
        """Count ``fn``'s FLOPs and launches in one call, then time it;
        returns the counted call's output. ``peak`` overrides the
        profiler's for this stage's MFU."""
        before = launch_counts()
        if flops:
            out, n = count_flops(fn)
        else:
            out, n = fn(), None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        launches = _launch_delta(launch_counts(), before)
        times = stage_ms(fn, self.device, iters or self.iters, self.warmup)
        self.record(name, times, n, launches, peak=peak)
        return out

    def once(self, name: str, fn):
        """Run ``fn`` once (an epoch, a run), its wall ms (the card waited
        for) and the kernels' launches recorded; no card time or FLOPs."""
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = (time.perf_counter() - t0) * 1e3
        self.record(name, {"card_ms": None, "wall_ms": wall}, None,
                    _launch_delta(launch_counts(), before))
        return out

    def record(self, name: str, times: Dict, flops: Optional[int],
               launches: Dict[str, int], peak: Optional[str] = None
               ) -> Dict:
        card = times["card_ms"]
        peak = peak or self.peak
        row = {"card_ms": card, "wall_ms": times["wall_ms"],
               "flops": flops, "tflops": None, "mfu": None, "peak": peak,
               "launches": launches}
        if card and flops is not None:
            row["tflops"] = flops / (card / 1e3) / 1e12
            row["mfu"] = flops / (card / 1e3) / self.peak_flops(peak)
        self.stages[name] = row
        card_s = "not measured" if card is None else f"{card:9.3f} ms"
        rate = ("" if row["mfu"] is None else
                f"  {row['tflops']:7.1f} TF/s  MFU {100 * row['mfu']:5.1f}%")
        per = card or times["wall_ms"]
        print(f"{name:44s} card {card_s}  wall {times['wall_ms']:9.3f} ms "
              f"({self.batch / per * 1e3:8.1f} img/s){rate}", flush=True)
        return row

    def line(self, **extra) -> Dict:
        """The tool's JSON line (printed last)."""
        out = {"tool": self.tool, "device": self.info,
               "stages": self.stages, "launches": launch_counts(), **extra}
        print(json.dumps(out), flush=True)
        return out
