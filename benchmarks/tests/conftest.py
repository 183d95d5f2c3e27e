"""Shared helpers of the benchmark's tests: a cell cut to a size the CPU
runs in seconds (the same code path, tiny widths and canvas)."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


# The program's RoIAlign on the CPU is its plain version, which
# interpolates in bfloat16 where the kernel (and the reference) sums in
# float32: at the rehearsal's size the SGCls gradients read up to ~0.03
# from the reference (the card's kernels: under 0.0062 at the cell's own
# size). The rehearsal checks the path and its faults, with limits of its
# own; the card's limits are held on the card (test_bench_card.py).
REHEARSAL_LIMIT = 0.1
# The eval cell's numbers at the rehearsal's size: sound runs read gaps of
# 0.0027-0.0045 (predicate) and 0.0031-0.0064 (object score); the unions'
# dedup with its row map rolled by one reads 0.027-0.047 and 0.013-0.10
# (four seeds), its 4 x 4 map's unions being alike. Half of the pairs left
# out reads 1.
EVAL_REHEARSAL_LIMITS = {"rel_score_gap": 0.015, "obj_score_gap": 0.015}


# ``sgcls_eval_jpeg`` is held out of BENCHMARK.json: its card time per image
# spreads 0.66-0.90% between runs, past half of the 1% bound, because a few
# of val_epoch's copies to pageable host memory stall with the host
# (PERF.md section 7). Its traffic, limits and readers stay under
# benchmarks/, and the tests keep its path working.
EVAL = ["sgcls_eval_jpeg"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "held_out: a card test of a cell held out of "
        "BENCHMARK.json; the card run of its cells leaves it out (-m \"cuda "
        "and not held_out\")")


def _eval_metric(name, unit, better, source, layer):
    return {"name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "eval_device_ms_per_image",
            "workloads": EVAL}


HELD_OUT = {
    "workloads": [{
        "name": "sgcls_eval_jpeg", "config": "vgg16_imp_sgcls",
        "traffic": "vg_jpeg_eval_b16", "chips": 1,
        "why": "the final test: Trainer.evaluate over a fixed set of the "
               "same laws, predcls then sgcls at batch 16, the pair ladder, "
               "the union dedup and the host evaluators (mean recall, per "
               "triplet)"}],
    "end_to_end": [{"name": "eval_device_ms_per_image", "unit": "ms",
                    "better": "lower", "bound": 0.01,
                    "source": "device_trace", "workloads": EVAL}],
    "per_layer": [
        _eval_metric("images_per_s.eval", "images/s", "higher",
                     "host_clock", "eval driver"),
        _eval_metric("evaluator_ms.eval", "ms", "lower", "host_clock",
                     "evaluator"),
        _eval_metric("device_idle_pct.eval", "%", "lower", "device_trace",
                     "device"),
        _eval_metric("pair_fill_pct.eval", "%", "higher", "program_counter",
                     "eval driver"),
        _eval_metric("mfu.eval", "%", "higher", "host_clock", "whole step"),
        _eval_metric("k1_roofline.eval", "%", "higher", "device_trace",
                     "kernels")],
}


def benchmark():
    """BENCHMARK.json with the held-out cell and its metrics."""
    from benchmarks import spec
    bench = spec.load_benchmark()
    for kind, entries in HELD_OUT.items():
        known = {e["name"] for e in bench[kind]}
        bench[kind] = bench[kind] + [e for e in entries
                                     if e["name"] not in known]
    return bench


def load_cell(name: str):
    """``spec.load_cell`` over BENCHMARK.json and the held-out cell."""
    from benchmarks import spec
    return spec.load_cell(name, benchmark())


def tiny_cell(name: str, card_limits: bool = False):
    """The cell ``name`` at a CPU size: a 64 px canvas (128 for the GAN,
    whose refinement network needs an 8 x 8 map), narrow relation heads, a
    pool of six small files; in training batch 2, 8 node and 32 edge
    slots; in evaluation ``val_epoch``'s batch of 16, 16 node slots (its
    ladder then has the rungs 128 and dense) and two batches a regime. Its
    limits are ``REHEARSAL_LIMIT`` unless ``card_limits``."""
    cell = load_cell(name)
    side = 128 if cell.config.get("gan") else 64
    evaluates = cell.traffic.get("drive") == "evaluate"
    cell.config = dict(cell.config, im_scale=side, obj_dim=64, hidden_dim=32,
                       batch_size=2, num_workers=1, print_interval=3,
                       max_nodes=16 if evaluates else 8, max_edges=32)
    cell.traffic = dict(cell.traffic, pool_files=6, long_side=[48, 160],
                        block=24, images_per_s_cap=4,
                        objects=dict(min=2, max=14 if evaluates else 6,
                                     mean=4, dispersion=2),
                        relations=dict(mean=3, dispersion=2),
                        epoch_margin_s=10, warmup_steps=1, trace_steps=2,
                        batches=2, batches_at_s=1, check_batches=1,
                        train_entries=24)
    if not card_limits:
        cell.limits = {k: dict(v, limit=EVAL_REHEARSAL_LIMITS.get(
                           k, REHEARSAL_LIMIT))
                       for k, v in cell.limits.items()
                       if isinstance(v, dict) and "limit" in v}
    return cell


@pytest.fixture
def cuda():
    """Skip a test that needs the card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card: python -m "
                    "pytest benchmarks/tests -m cuda)")
    return torch.device("cuda", 0)
