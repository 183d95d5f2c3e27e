"""A/B: the accuracy cost of ``-cache_orientations 1`` (flip augmentation
off).

    python -m sgg_torch.tools.ab_cache_orientations [OUT_DIR] [EPOCHS=8]
        [N_SEEDS=2] [DEVICE=cuda]

Counterpart of ``tools/ab_cache_orientations.py`` through ``python -m
sgg_torch.main``. ``-cache_orientations 1`` halves the feature cache's
disk by storing only the unflipped trunk map, which pins the horizontal
flip off for cached train splits; the reference always flips at random in
training. The tool prices that with a measured R@K difference: the same
fixture and seeds, two real ``-feature_cache`` CLI runs a seed (A: 2
orientations, flips live; B: ``-cache_orientations 1``), then the test
recalls compared. Fixture scale (a 40-image VG tree; 160 px canvases
unless ``SGG_IM_SCALE`` says otherwise): it bounds the flag's effect on
this workload's shape, not on full VG. The cache is HDF5, which needs
``h5py`` (the card's machine lacks it), so the runs go on a host with
``h5py``, on its card or, with DEVICE ``cpu``, its CPU. Writes
``OUT_DIR/ab_cache_orientations.json`` and prints the differences; the
last line is the summary as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

KEYS = ["predcls/test_alls_R@50_GC", "predcls/test_alls_R@100_GC",
        "predcls/test_alls_R@100_NOGC", "predcls/test_alls_mR@100_GC"]
ARMS = (("A_flip_on", []), ("B_flip_off", ["-cache_orientations", "1"]))


def arm_argv(data_dir: str, run: str, epochs: int, seed: int, device: str,
             extra: List[str]) -> List[str]:
    """One arm's CLI arguments (after the interpreter)."""
    return (["-m", "sgg_torch.main", "-m", "predcls", "-split", "stanford",
             "-data", data_dir, "-val_size", "4", "-b", "4",
             "-nepoch", str(epochs), "-p", "100", "-nwork", "1",
             "-device", device, "-seed", str(seed), "-use_bias",
             "-save_dir", run, "-feature_cache", os.path.join(run, "fcache")]
            + extra)


def _run(args: List[str], env: Dict[str, str], timeout: int = 2400) -> None:
    proc = subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"CLI failed: {' '.join(args)}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")


def summarize(results: Dict[str, list], epochs: int, n_seeds: int,
              im_scale: str) -> Dict:
    """Each key's mean over the seeds in both arms and their difference."""
    summary = {"epochs": epochs, "n_seeds": n_seeds, "im_scale": im_scale,
               "delta": {}}
    for k in KEYS:
        a = [r[k] for r in results["A_flip_on"] if k in r]
        b = [r[k] for r in results["B_flip_off"] if k in r]
        if a and b:
            ma, mb = sum(a) / len(a), sum(b) / len(b)
            summary["delta"][k] = {"flip_on": round(ma, 4),
                                   "flip_off": round(mb, 4),
                                   "cost_of_no_flip": round(ma - mb, 4)}
    summary["runs"] = results
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_dir = argv[0] if len(argv) > 0 else os.path.join(
        tempfile.gettempdir(), "ab_orient")
    epochs = int(argv[1]) if len(argv) > 1 else 8
    n_seeds = int(argv[2]) if len(argv) > 2 else 2
    device = argv[3] if len(argv) > 3 else "cuda"
    os.makedirs(out_dir, exist_ok=True)

    data_dir = os.path.join(out_dir, "data")
    if not os.path.isdir(os.path.join(data_dir, "VG")):
        from sgg_torch.data import fixtures
        # a larger train split than the CLI tests' fixture: augmentation
        # needs some generalization gap to act on
        fixtures.write_vg_fixture(data_dir, n_train=40, n_test=12,
                                  n_classes=12, n_preds=8, seed=7)

    env = dict(os.environ)
    env.setdefault("SGG_IM_SCALE", "160")
    env["SGG_CHECK_SIZES"] = "0"

    results = {"A_flip_on": [], "B_flip_off": []}
    for seed in range(n_seeds):
        for arm, extra in ARMS:
            run = os.path.join(out_dir, f"{arm}_s{seed}")
            _run(arm_argv(data_dir, run, epochs, seed, device, extra), env)
            with open(os.path.join(run, "test_results.json")) as f:
                res = json.load(f)
            results[arm].append({k: res[k] for k in KEYS if k in res})
            print(f"{arm} seed {seed}: " + "  ".join(
                f"{k.split('/')[-1]}={res[k]:.4f}" for k in KEYS
                if k in res), flush=True)

    summary = summarize(results, epochs, n_seeds, env["SGG_IM_SCALE"])
    path = os.path.join(out_dir, "ab_cache_orientations.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary["delta"], indent=1))
    print(f"written: {path}")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
