"""The harness reads what it read before its model-specific parts moved
behind ``benchmarks/families``, bit for bit (``pins.json``, recorded on
the CPU at one seed): in each cell, the work counts at the cell's own
size, each roofline and MFU reader on a run with fixed windows and
kernel times, and the tiny rehearsal's numbers compared with the plain
reference. The rehearsal sums in the thread count it was recorded at."""

import json
import types
from pathlib import Path

import pytest
import torch

from benchmarks.tests.conftest import load_cell, tiny_cell

PINS = json.loads((Path(__file__).with_name("pins.json")).read_text())
SEED = PINS["seed"]
PEAKS = {"bf16": 989e12, "f32": 67e12, "hbm_bytes_per_s": 3.35e12}
TRAIN = ("sgcls_train_jpeg", "gan_train_jpeg")
EVAL = "sgcls_eval_jpeg"
READERS = ("k1_roofline", "k1_bwd_fmap_roofline", "k2_roofline",
           "mfu.train", "k1_roofline.eval", "mfu.eval")


def kernels():
    ms = 10 ** 6
    return [("roi_align_kernel<bf16>", 0, 7 * ms + 123),
            ("roi_align_kernel<f32>", 0, 3 * ms + 7),
            ("vgg_conv1_bf16_kernel", 0, 11 * ms + 5),
            ("staged_fmap_gather_kernel", 0, 5 * ms + 9),
            ("tile_lists_kernel", 0, 333_333)]


def readings(run):
    from benchmarks import spec
    return {m: spec.reader(m)(run) for m in READERS}


@pytest.mark.parametrize("name", TRAIN)
def test_train_work_and_readers(name):
    from benchmarks import run, traffic
    from benchmarks.window import Record
    pin = PINS["cells"][name]
    cell = load_cell(name)
    cfg, mix, family = cell.config, cell.traffic, cell.family
    cfg_seed, _ = run.seeds(SEED)
    split = traffic.annotations(
        mix, SEED, traffic.pool_sizes(mix, SEED),
        traffic.num_entries(mix, cfg["batch_size"], 50.0),
        cfg["num_classes"], cfg["num_predicates"])
    assert [family.step_flops(split, cfg, cfg_seed, k)
            for k in pin["steps"]] == pin["step_flops"]
    assert [[list(x) for x in family.step_sizes(split, cfg, cfg_seed, k)]
            for k in pin["steps"][:5]] == pin["step_sizes"]
    rec = Record(window_first_step=13, window_steps=180, t_start=100.0,
                 t_end=150.25, trace_first_step=193, trace_steps=24)
    trace = types.SimpleNamespace(kernels=kernels(), busy_s=1.0,
                                  window_s=2.0)
    r = run.Run(cell, cfg, split, cfg_seed, rec, trace, PEAKS, 40.0, 3.0)
    assert r.window_flops() == pin["window_flops"]
    assert readings(r) == pin["readers"]


def test_eval_work_and_readers():
    from benchmarks import evaluation, run, traffic
    from benchmarks.window import Record
    pin = PINS["cells"][EVAL]
    cell = load_cell(EVAL)
    cfg, mix = cell.config, cell.traffic
    cfg_seed, _ = run.seeds(SEED)
    test, _ = evaluation.splits(mix, SEED, traffic.pool_sizes(mix, SEED),
                                cfg, 50.0)
    assert cell.family.eval_flops(test, cfg) == pin["eval_flops"]
    ev = evaluation.EvalRecord(images=len(test), batches=len(test) // 16,
                               t_start=1.0, t_end=47.5, slots=1000,
                               valid=104)
    trace = types.SimpleNamespace(kernels=kernels(), busy_s=1.0,
                                  window_s=2.0)
    r = run.Run(cell, cfg, test, cfg_seed, Record(), trace, PEAKS, 30.0,
                3.0, ev)
    assert readings(r) == pin["readers"]


@pytest.fixture
def pinned_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(PINS["threads"])
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", TRAIN + (EVAL,))
def test_rehearsal_numbers(monkeypatch, pinned_threads, name):
    from benchmarks import program, run
    from sgg_torch import constants
    cell = tiny_cell(name)
    program.set_canvas(cell.config)
    monkeypatch.setattr(constants, "IM_SCALE", cell.config["im_scale"])
    out = run.execute(cell, SEED, 1.0, False, torch.device("cpu"), workers=2)
    got = {k: list(v) if isinstance(v, tuple) else v
           for k, v in out["numbers"].items()}
    assert got == PINS["cells"][name]["check"]
