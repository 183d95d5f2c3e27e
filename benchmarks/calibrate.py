"""The readings that the limits of ``correct`` are set from, at a cell's
own size, many seeds in one process:

    python3 -m benchmarks.calibrate --workload <cell> --seeds 1,2,3 \
        [--controls 1,2,3]

A cell that trains: for each seed of ``--seeds``, the program's check
steps through ``Trainer.train_epoch`` (as a run takes them, with no
window), then the reference; the three numbers of ``check.py`` (the
lower readings). For each seed of ``--controls`` also the reference put
in the program's place and computed in the precision below the
configuration's (``control``), and with each fault of the family's
``TRAIN_FAULTS`` planted in its batches (the IMP family's
``fault_half``: half of each batch left out, the means taken over the
rest). A step that leaves the state unchanged reads 1 on ``update_gap``
by construction and needs no run.

A cell that evaluates: for each seed of ``--seeds``, the warm-up and a
window over the check batches alone (``evaluation.run_window``), then
the reference; the numbers of ``check_eval.py``. For each seed of
``--controls`` also the reference in the lower precision in the
program's place (``control``), and the program with each fault of the
family's ``EVAL_FAULTS`` planted (the IMP family's ``fault_half_pairs``,
``fault_dedup_map``).

One JSON line a seed and kind on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile

import torch

from benchmarks import check, program, spec, traffic, window
from benchmarks.run import fixed_caches, seeds


def eval_outputs(trainer, cell, test_ds, warm_ds, dev) -> dict:
    """The host outputs that a window over ``test_ds`` keeps."""
    from benchmarks import evaluation
    probe = evaluation.Probe(evaluation.EvalRecord(),
                             cell.traffic["check_batches"], cell.family)
    undo = probe.install()
    try:
        evaluation.run_window(trainer, cell.traffic["split"], test_ds,
                              warm_ds, probe, window.Clock(dev))
    finally:
        undo()
    return probe.rec.outputs


def eval_readings(cell, seed: int, dev, sound: bool, controls: bool
                  ) -> dict:
    """The eval cell's numbers of one seed by kind (see the module's
    text)."""
    from benchmarks import check_eval, evaluation
    cfg, mix, family = cell.config, cell.traffic, cell.family
    cfg_seed, weight_seed = seeds(seed)
    scratch = tempfile.mkdtemp(prefix="sgg-calib-")
    try:
        names, sizes = traffic.write_pool(mix, seed, scratch, device=dev)
        test, train = evaluation.splits(mix, seed, sizes, cfg, 0.0)
        paths = [os.path.join(scratch, n) for n in names]
        entries = check_eval.check_entries(mix, cfg)
        built, test_ds, warm_ds = evaluation.build(
            cell, dev, weight_seed, cfg_seed, test, train, scratch, names)
        runs = {"program": contextlib.nullcontext} if sound else {}
        if controls:
            runs.update(family.EVAL_FAULTS)
        kept = {}
        for kind, fault in runs.items():
            with fault():
                kept[kind] = family.eval_program(
                    eval_outputs(built.trainer, cell, test_ds, warm_ds, dev),
                    test, cfg)
        del built, test_ds, warm_ds
        window.wait_threads()
        gc.collect()
        torch.cuda.empty_cache()
        ref = check_eval.reference_outputs(cfg, test, paths, weight_seed,
                                           dev, "bf16", entries)
        if controls:
            kept["control"] = family.eval_as_program(
                check_eval.reference_outputs(
                    cfg, test, paths, weight_seed, dev,
                    cfg["precision"]["control"], entries), test)
        readings = {kind: family.eval_compare(prog, ref, test, cfg)
                    for kind, prog in kept.items()}
        del ref, kept
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return readings


def program_steps(cell, split, scratch, names, cfg_seed, weight_seed, dev):
    """The program's check steps through ``Trainer.train_epoch``."""
    mix = cell.traffic
    built = program.build(cell.config, dev, weight_seed, split, scratch,
                          names, cfg_seed)
    stepper = window.Stepper(
        getattr(built.trainer, built.attr), check_steps=mix["check_steps"],
        warmup_steps=0, seconds=0.0, trace_steps=0, clock=window.Clock(dev),
        opt_state=built.opt_state, params=built.params)
    rec = window.run_epochs(built.trainer, built.attr, stepper)
    del built, stepper
    window.wait_threads()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def numbers_line(kind, seed, numbers):
    keys = [k for k in numbers if k != "quiet_leaves"]
    line = {"kind": kind, "seed": seed, **{k: numbers[k][0] for k in keys},
            "at": {k: numbers[k][1] for k in keys}}
    if "quiet_leaves" in numbers:
        line["quiet_leaves"] = len(numbers["quiet_leaves"])
    return json.dumps(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)
    fixed_caches()
    cell = spec.load_cell(args.workload)
    cfg, mix = cell.config, cell.traffic
    program.set_canvas(cfg)
    dev = torch.device("cuda", 0)
    runs = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.controls.split(",") if s}
    order = sorted(set(runs) | controls, key=lambda s: (
        s not in runs, runs.index(s) if s in runs else 0))
    if spec.drive(mix) == "evaluate":
        for seed in order:
            for kind, numbers in eval_readings(cell, seed, dev, seed in runs,
                                               seed in controls).items():
                print(numbers_line(kind, seed, numbers), flush=True)
        return 0
    for seed in order:
        cfg_seed, weight_seed = seeds(seed)
        scratch = tempfile.mkdtemp(prefix="sgg-calib-")
        try:
            names, sizes = traffic.write_pool(mix, seed, scratch, device=dev)
            split = traffic.annotations(
                mix, seed, sizes,
                traffic.num_entries(mix, cfg["batch_size"], 0.0),
                cfg["num_classes"], cfg["num_predicates"])
            paths = [os.path.join(scratch, n) for n in names]

            def ref(low="bf16", hook=None):
                return check.reference_steps(
                    cfg, split, paths, cfg_seed, weight_seed, dev, low,
                    mix["check_steps"], batch_hook=hook)

            base = ref()
            if seed in runs:
                rec = program_steps(cell, split, scratch, names, cfg_seed,
                                    weight_seed, dev)
                print(numbers_line("program", seed, check.compare(
                    rec.losses, check.program_first(rec.opt_state, base, dev),
                    check.program_change(rec.params, base["init"], dev),
                    base)), flush=True)
            if seed in controls:
                faults = [("control", {"low": cfg["precision"]["control"]})]
                faults += [(kind, {"hook": hook})
                           for kind, hook in cell.family.TRAIN_FAULTS.items()]
                for kind, kw in faults:
                    other = ref(**kw)
                    print(numbers_line(kind, seed, check.compare(
                        other["losses"], other["first"], other["change"],
                        base)), flush=True)
                    del other
            del base
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
