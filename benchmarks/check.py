"""The comparison that decides ``correct``.

The program's trainer, built once in set-up, takes its first
``check_steps`` steps through the window's own call and loader; the
window then runs on that same object. Once the window has closed and the
program's state is freed, the plain reference (the configuration's
family's, ``benchmarks/families``) starts from the same weights, decodes the same files itself, draws the
same edges and dropout masks from the same seeds, and takes the same steps.
The numbers that ``benchmarks/limits/<config>.json`` names are compared,
each against its limit there:

- ``loss_gap``: over the steps and the loss terms, the largest
  |program - reference| / |reference|; ``loss_gap_step0`` the same over
  the first step's terms only;
- ``grad_gap``: the first gradient as each optimizer got it, worked out
  from its state after one step (SGD: the momentum less the decay term;
  Adam: the first moment over 1 - beta1), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and the median leaf's;
- ``update_gap``: the same of each leaf's change over the check steps,
  leaving out the leaves whose reference gradient norm is under a
  thousandth of the median leaf's (they move by rounding alone).

A leaf that one side leaves unmoved and the other moves reads about 1.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from benchmarks import families

QUIET = 1e-3   # a leaf's gradient under this share of the median leaf's


def batch_tensors(nb: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in nb.items()}


class _Exact:
    """TF32 off for the reference's float32 products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def reference_steps(cfg: dict, split, paths: List[str], cfg_seed: int,
                    weight_seed: int, device, low: str, n_steps: int,
                    workers: int = 8, batch_hook=None) -> dict:
    """The reference's ``n_steps`` steps from the benchmark's weights, in
    the precision ``low`` ("bf16" as the configuration states, or its
    ``precision.control``), by the configuration's family
    (``benchmarks/families``), with TF32 off: the losses of each step, the
    first gradient of each leaf, each leaf's change, the starting weights
    and each leaf's L2 term. ``batch_hook``, if given, edits each numpy
    batch first (``benchmarks/calibrate.py`` plants faults there)."""
    with _Exact():
        return families.of(cfg).reference_steps(
            cfg, split, paths, cfg_seed, weight_seed, device, low, n_steps,
            workers, batch_hook)


def program_first(opt_state: Dict[str, torch.Tensor], ref: dict, device):
    """The first gradient from the program's optimizer states (SGD's
    momentum, Adam's first moment over 1 - beta1: see ``program.Built``)
    less each leaf's L2 term, ``ref["decay"]`` times its starting weight."""
    init, decay = ref["init"], ref["decay"]
    return {n: opt_state[n].to(device) - decay[n] * init[n] for n in init}


def program_change(params: Dict[str, torch.Tensor],
                   init: Dict[str, torch.Tensor], device):
    return {n: params[n].to(device).float() - init[n].float() for n in init}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.float().norm()) for n, t in d.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of the reference leaf's norm
    and the median leaf's (NaN read as infinite)."""
    rn, pn = _norms(ref), _norms(prog)
    med = statistics.median(rn.values())
    out = {}
    for n in ref:
        if keep is not None and n not in keep:
            continue
        g = abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
        out[n] = float("inf") if g != g else g
    return out


def worst(gaps: Dict[str, float]):
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median(gaps: Dict[str, float]):
    return statistics.median(gaps.values()), "the median leaf"


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]]):
    worst, at = 0.0, None
    for k, (p, r) in enumerate(zip(prog, ref)):
        for key, rv in r.items():
            g = abs(p[key] - rv) / max(abs(rv), 1e-30)
            if g != g:
                return float("inf"), f"step {k} {key}"
            if g >= worst:
                worst, at = g, f"step {k} {key}"
    if len(prog) != len(ref) or any(set(p) != set(r)
                                    for p, r in zip(prog, ref)):
        return float("inf"), "the program's losses are not the reference's"
    return worst, at


def compare(prog_losses, prog_first, prog_change, ref: dict) -> dict:
    """Every number the limits may name, each with where it was read:
    ``loss_gap`` (every step), ``loss_gap_step0`` (the first step's),
    ``grad_gap``, ``update_gap`` (worst leaf), ``update_gap_median`` (the
    median leaf), and the quiet leaves left out of the updates."""
    first_norms = _norms(ref["first"])
    med = statistics.median(first_norms.values())
    moving = {n for n, v in first_norms.items() if v >= QUIET * med}
    updates = leaf_gaps(prog_change, ref["change"], keep=moving)
    return {"loss_gap": loss_gap(prog_losses, ref["losses"]),
            "loss_gap_step0": loss_gap(prog_losses[:1], ref["losses"][:1]),
            "grad_gap": worst(leaf_gaps(prog_first, ref["first"])),
            "update_gap": worst(updates),
            "update_gap_median": median(updates),
            "quiet_leaves": sorted(set(first_norms) - moving)}


def judged(limits: dict) -> List[str]:
    """The numbers a configuration's limits hold (its file names them)."""
    return [k for k, v in limits.items() if isinstance(v, dict)
            and "limit" in v]


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k][0] <= limits[k]["limit"] for k in judged(limits))


def lines(numbers: dict, limits: dict) -> List[str]:
    return [f"{k} {numbers[k][0]:.6g} limit {limits[k]['limit']:.6g} "
            f"(worst at {numbers[k][1]})" for k in judged(limits)]
