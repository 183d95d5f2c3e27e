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


# ``sgcls_train_jpeg`` is held out of BENCHMARK.json: on the card's host its
# runs spread past any bound the contract allows (PERF.md section 7). Its
# configuration and limits stay under benchmarks/, and the tests keep its
# path working.
HELD_OUT = {
    "configs": [{"name": "vgg16_imp_sgcls",
                 "file": "benchmarks/configs/vgg16_imp_sgcls.json"}],
    "workloads": [{"name": "sgcls_train_jpeg", "config": "vgg16_imp_sgcls",
                   "traffic": "vg_jpeg_b24", "chips": 1}],
}


def load_cell(name: str):
    """``spec.load_cell`` over BENCHMARK.json and the held-out cells."""
    from benchmarks import spec
    bench = spec.load_benchmark()
    for kind, entries in HELD_OUT.items():
        known = {e["name"] for e in bench[kind]}
        bench[kind] = bench[kind] + [e for e in entries
                                     if e["name"] not in known]
    return spec.load_cell(name, bench)


def tiny_cell(name: str, card_limits: bool = False):
    """The cell ``name`` at a CPU size: a 64 px canvas (128 for the GAN,
    whose refinement network needs an 8 x 8 map), batch 2, 8 node and 32
    edge slots, narrow relation heads, a pool of six small files. Its
    limits are ``REHEARSAL_LIMIT`` unless ``card_limits``."""
    cell = load_cell(name)
    side = 128 if cell.config.get("gan") else 64
    cell.config = dict(cell.config, im_scale=side, obj_dim=64, hidden_dim=32,
                       batch_size=2, num_workers=1, print_interval=3,
                       max_nodes=8, max_edges=32)
    cell.traffic = dict(cell.traffic, pool_files=6, long_side=[48, 160],
                        block=24, images_per_s_cap=4,
                        objects=dict(min=2, max=6, mean=4, dispersion=2),
                        relations=dict(mean=3, dispersion=2),
                        epoch_margin_s=10, warmup_steps=1, trace_steps=2)
    if not card_limits:
        cell.limits = {k: dict(v, limit=REHEARSAL_LIMIT)
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
