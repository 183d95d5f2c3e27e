"""On the card, at each cell's own size: the program reads correct and the
control (the reference put in the program's place, computed in the
precision below the configuration's) reads not correct, on three seeds.
A split of a few batches stands in for the window's: the check steps are
the first three; in the eval cell the check batches, after the warm-up,
and the program with each fault of the family's ``EVAL_FAULTS`` planted
reads not correct as well. Run on the card with
``python -m pytest benchmarks/tests -m "cuda and not held_out"`` (the
cells of BENCHMARK.json, ~5 min); the held-out eval cell's test with
``-m held_out`` (~3 min)."""

import os
import shutil
import tempfile

import pytest

from benchmarks.tests.conftest import load_cell

CELLS = ("sgcls_train_jpeg", "gan_train_jpeg")
SEEDS = (3000000301, 3000000302, 3000000303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_where_the_program_passes(cuda, name, seed):
    from benchmarks import calibrate, check, program, traffic
    from benchmarks.run import seeds
    cell = load_cell(name)
    cfg, mix = cell.config, cell.traffic
    program.set_canvas(cfg)
    cfg_seed, weight_seed = seeds(seed)
    scratch = tempfile.mkdtemp(prefix="sgg-test-")
    try:
        names, sizes = traffic.write_pool(mix, seed, scratch, 8, cuda)
        split = traffic.annotations(mix, seed, sizes, 8 * cfg["batch_size"],
                                    cfg["num_classes"],
                                    cfg["num_predicates"])
        paths = [os.path.join(scratch, n) for n in names]

        def reference(low):
            return check.reference_steps(cfg, split, paths, cfg_seed,
                                         weight_seed, cuda, low,
                                         mix["check_steps"])

        base = reference("bf16")
        rec = calibrate.program_steps(cell, split, scratch, names, cfg_seed,
                                      weight_seed, cuda)
        prog = check.compare(
            rec.losses, check.program_first(rec.opt_state, base, cuda),
            check.program_change(rec.params, base["init"], cuda), base)
        ctrl = reference(cfg["precision"]["control"])
        ctrl = check.compare(ctrl["losses"], ctrl["first"], ctrl["change"],
                             base)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    assert check.judge(prog, cell.limits), prog
    assert not check.judge(ctrl, cell.limits), ctrl


@pytest.mark.cuda
@pytest.mark.held_out
@pytest.mark.parametrize("seed", SEEDS)
def test_eval_control_and_faults_fail_where_the_program_passes(cuda, seed):
    from benchmarks import calibrate, check, program
    cell = load_cell("sgcls_eval_jpeg")
    program.set_canvas(cell.config)
    got = calibrate.eval_readings(cell, seed, cuda, sound=True,
                                  controls=True)
    assert check.judge(got.pop("program"), cell.limits)
    for kind, numbers in got.items():
        assert not check.judge(numbers, cell.limits), (kind, numbers)
