"""One run of one cell of the benchmark of the PyTorch port.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The run generates its traffic from ``--seed`` (JPEG files under
``TMPDIR``, deleted at the end) and builds the program's ``Trainer`` with
weights drawn on the card from the seed. A cell that trains drives
``Trainer.train_epoch`` through a wrapper of its step (``window.py``):
the check steps, the warm-up, then ``--seconds`` of measured steps, and
with ``--trace 1`` the traced steps. A cell that evaluates (its traffic's
``drive``) drives ``Trainer.evaluate`` (``evaluation.py``): a warm-up
split, then the window, one replay of a set sized to ``--seconds``. The
run then frees the program's state, runs the plain reference
(``check.py``, ``check_eval.py``) and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted`` (steps, or
images) and ``failed``, the cell's end-to-end metrics (``--trace 0``, the
window under the profiler's CUDA activity) or per-layer metrics and
``breakdown`` (``--trace 1``: training's window untraced and the traced
steps after it; evaluation's window traced as with ``--trace 0``), the
``device``, and last the numbers compared with their limits (also the
last lines of standard error).

It fails (no result, a non-zero exit) without the cards the cell needs,
for a card the peak table does not know, and when the process has loaded
JAX or the JAX package. ``setup_s`` runs from the start of this module's
import to the first measured step.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's CUDA kernels build into its own ``sgg_torch/build``)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def stage(what: str) -> None:
    log(f"[{time.perf_counter() - T0:8.3f} s] {what}")


def seeds(seed: int):
    """(the program's ``-seed``, the weights' seed) from the run's seed."""
    return seed % (2 ** 31 - 1), (seed * 0x9E3779B97F4A7C15 + 1) % (2 ** 63)


class Run:
    """What the metric readers read (``benchmarks/metrics``)."""

    def __init__(self, cell, cfg, split, cfg_seed, rec, trace, peaks,
                 setup_s, window_busy_s=None, ev=None):
        self.cell, self.cfg, self.split = cell, cfg, split
        self.cfg_seed, self.rec, self.trace = cfg_seed, rec, trace
        self.peaks, self.setup_s = peaks, setup_s
        self.window_busy_s = window_busy_s
        self.ev = ev   # an evaluating cell's window (evaluation.EvalRecord)

    def step_sizes(self, first: int, count: int):
        family = self.cell.family
        return [family.step_sizes(self.split, self.cfg, self.cfg_seed, k)
                for k in range(first, first + count)]

    def window_flops(self) -> int:
        family = self.cell.family
        return sum(family.step_flops(self.split, self.cfg, self.cfg_seed, k)
                   for k in range(self.rec.window_first_step,
                                  self.rec.window_first_step
                                  + self.rec.window_steps))


def execute(cell, seed: int, seconds: float, trace: bool, dev,
            workers: int = 8) -> dict:
    """The run on ``dev``: the result's fields, the numbers compared and
    the threads left behind."""
    from benchmarks import spec
    if spec.drive(cell.traffic) == "evaluate":
        return execute_eval(cell, seed, seconds, trace, dev, workers)
    return execute_train(cell, seed, seconds, trace, dev, workers)


def free_cuda(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def execute_train(cell, seed: int, seconds: float, trace: bool, dev,
                  workers: int = 8) -> dict:
    import torch

    from benchmarks import check, host, program, traffic
    from benchmarks import trace as tracing
    from benchmarks import window

    cfg, mix = cell.config, cell.traffic
    program.set_canvas(cfg)
    cfg_seed, weight_seed = seeds(seed)
    stage("imported")
    scratch = tempfile.mkdtemp(prefix="sgg-bench-")
    try:
        names, sizes = traffic.write_pool(mix, seed, scratch, workers, dev)
        stage("pool of JPEGs written")
        split = traffic.annotations(
            mix, seed, sizes,
            traffic.num_entries(mix, cfg["batch_size"], seconds),
            cfg["num_classes"], cfg["num_predicates"])
        stage(f"{len(split)} entries annotated")
        built = program.build(cfg, dev, weight_seed, split, scratch, names,
                              cfg_seed, log=stage)
        stage("trainer built")
        clock = window.Clock(dev)
        stepper = window.Stepper(
            getattr(built.trainer, built.attr),
            check_steps=mix["check_steps"],
            warmup_steps=mix["warmup_steps"], seconds=seconds,
            trace_steps=mix["trace_steps"] if trace else 0, clock=clock,
            opt_state=built.opt_state, params=built.params,
            trace_window=not trace)
        prof = {}

        def stop_profile():
            prof["p"].stop()
            return prof["p"]

        stepper.start_profile = lambda: prof.update(p=tracing.start())
        stepper.stop_profile = stop_profile
        stepper.on_first_step = lambda: stage("first step taken")
        seen = {}
        stepper.on_window = lambda at: seen.update({at: host.reading()})
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rec = window.run_epochs(built.trainer, built.attr, stepper)
        setup_s = rec.t_start - T0
        stage("window closed")
        log(host.report(seen.get("open", {}), seen.get("close", {}),
                        rec.window_steps * cfg["batch_size"]))
        left = window.wait_threads()
        mem_peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                    else 0)
        tr = (tracing.reduce(rec.profile, *rec.trace_t, rec.trace_spans)
              if trace else None)
        window_busy_s = (tracing.busy_s(rec.window_profile)
                         if rec.window_profile is not None else None)
        rec.profile = rec.window_profile = None
        prof.clear()
        del built, stepper
        free_cuda(dev)
        t_ref = time.perf_counter()
        ref = check.reference_steps(
            cfg, split, [os.path.join(scratch, n) for n in names], cfg_seed,
            weight_seed, dev, "bf16", mix["check_steps"], workers)
        numbers = check.compare(
            rec.losses, check.program_first(rec.opt_state, ref, dev),
            check.program_change(rec.params, ref["init"], dev), ref)
        ref_s = time.perf_counter() - t_ref
        del ref
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    busy = ("untraced" if window_busy_s is None
            else f"{window_busy_s:.3f} s")
    return {"rec": rec, "trace": tr, "window_busy_s": window_busy_s,
            "split": split, "cfg_seed": cfg_seed,
            "setup_s": setup_s, "mem_peak": mem_peak, "numbers": numbers,
            "left": left, "attempted": rec.window_steps, "info": [
                f"window {rec.window_s:.3f} s, {rec.window_steps} steps, "
                f"device busy {busy}, reference {ref_s:.1f} s, "
                f"{len(numbers['quiet_leaves'])} quiet leaves"]}


def execute_eval(cell, seed: int, seconds: float, trace: bool, dev,
                 workers: int = 8) -> dict:
    """``execute`` for a cell that evaluates (``evaluation.py``)."""
    import torch

    from benchmarks import check_eval, evaluation, host, program, traffic
    from benchmarks import trace as tracing
    from benchmarks import window

    cfg, mix, family = cell.config, cell.traffic, cell.family
    program.set_canvas(cfg)
    cfg_seed, weight_seed = seeds(seed)
    stage("imported")
    scratch = tempfile.mkdtemp(prefix="sgg-bench-")
    try:
        names, sizes = traffic.write_pool(mix, seed, scratch, workers, dev)
        stage("pool of JPEGs written")
        test, train = evaluation.splits(mix, seed, sizes, cfg, seconds)
        stage(f"{len(test)} test and {len(train)} training entries "
              f"annotated")
        built, test_ds, warm_ds = evaluation.build(
            cell, dev, weight_seed, cfg_seed, test, train, scratch, names,
            log=stage)
        stage(f"trainer built; warm-up over {len(warm_ds)} entries")
        ev = evaluation.EvalRecord(
            images=len(test), batches=len(test) // cfg["eval_batch_size"])
        probe = evaluation.Probe(ev, mix["check_batches"], family)
        seen = {}

        def on_open():
            stage("warm-up done, window open")
            seen["open"] = host.reading()

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        undo = probe.install()
        try:
            evaluation.run_window(built.trainer, mix["split"], test_ds,
                                  warm_ds, probe, window.Clock(dev),
                                  profile=tracing.start, on_open=on_open)
        finally:
            undo()
        setup_s = ev.t_start - T0
        seen["close"] = host.reading()
        stage("window closed")
        log(host.report(seen["open"], seen["close"], ev.images))
        left = window.wait_threads()
        mem_peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                    else 0)
        tr = (tracing.reduce(ev.profile, *ev.trace_t,
                             ev.steps + ev.evaluator) if trace else None)
        window_busy_s = tracing.busy_s(ev.profile)
        ev.profile = None
        del built, test_ds, warm_ds
        free_cuda(dev)
        t_ref = time.perf_counter()
        entries = check_eval.check_entries(mix, cfg)
        ref = check_eval.reference_outputs(
            cfg, test, [os.path.join(scratch, n) for n in names],
            weight_seed, dev, "bf16", entries, workers)
        prog = family.eval_program(ev.outputs, test, cfg)
        numbers = family.eval_compare(prog, ref, test, cfg)
        gaps = check_eval.recalls(prog, family.eval_as_program(ref, test),
                                  test, family.eval_regimes(cfg))
        ref_s = time.perf_counter() - t_ref
        del ref
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    rule = evaluation.rungs(test, cfg)
    rule_slots = 2 * cfg["eval_batch_size"] * sum(rule)
    rule_valid = 2 * sum(len(c) * (len(c) - 1) for c in test.gt_classes)
    info = [f"window {ev.window_s:.3f} s, {ev.images} images, "
            f"{ev.batches} batches a regime, device busy "
            f"{window_busy_s:.3f} s, evaluators {ev.evaluator_s():.3f} s, "
            f"reference {ref_s:.1f} s over {len(entries)} images",
            f"rungs run (regime, pair slots an image: batches) {ev.rungs}; "
            f"pair slots {ev.slots}, valid {ev.valid}; the ladder rule "
            f"over the split: {rule_slots}, {rule_valid}",
            "recall, program less reference (not judged): " + ", ".join(
                f"{k} {v:+.4f}" for k, v in gaps.items())]
    info += [f"{k} {v:.6g} (not judged: {cell.limits[k]['not_compared']}; "
             f"{where})" for k, (v, where) in numbers.items()
             if "not_compared" in cell.limits.get(k, {})]
    return {"rec": window.Record(), "ev": ev, "trace": tr,
            "window_busy_s": window_busy_s, "split": test,
            "cfg_seed": cfg_seed, "setup_s": setup_s, "mem_peak": mem_peak,
            "numbers": numbers, "left": left, "attempted": ev.images,
            "info": info}


def result(cell, out: dict, trace: bool, card: str, peaks) -> dict:
    from benchmarks import check, spec
    rec, tr = out["rec"], out["trace"]
    run = Run(cell, cell.config, out["split"], out["cfg_seed"], rec, tr,
              peaks, out["setup_s"], out["window_busy_s"], out.get("ev"))
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                run)
    numbers = out["numbers"]
    correct = check.judge(numbers, cell.limits) and not out["left"]
    device = {"platform": "gpu", "kind": card, "count": 1,
              "memory_peak_bytes": out["mem_peak"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": 0,
            "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.device_ops,
                             "idle_gaps": tr.idle_gaps}
    line["check"] = {k: {"value": numbers[k][0],
                         "limit": cell.limits[k]["limit"]}
                     for k in check.judged(cell.limits)}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    from benchmarks import device, peaks, spec
    cell = spec.load_cell(args.workload)
    try:
        device.require_cards(cell.chips)
    except device.NoCard as e:
        log(f"refused: {e}")
        return 2
    import torch
    card = torch.cuda.get_device_name(0)
    try:
        card_peaks = peaks.peaks(card)
    except peaks.UnknownCard as e:
        log(f"refused: {e}")
        return 2
    log(f"card: {device.smi()}")
    log(f"cell {cell.name}: config {cell.config_name}, traffic "
        f"{cell.traffic_name}, seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}")
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    if out["left"]:
        log(f"threads left running: {out['left']}")
    line = result(cell, out, bool(args.trace), card, card_peaks)
    bad = device.forbidden_modules()
    if bad:
        log(f"refused: the process loaded {bad}")
        return 3
    for s in out["info"]:
        log(s)
    from benchmarks import check
    for s in check.lines(out["numbers"], cell.limits):
        log(s)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
