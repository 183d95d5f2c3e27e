"""The comparison that decides ``correct``.

The program's trainer, built once in set-up, takes its first
``check_steps`` steps through the window's own call and loader; the
window then runs on that same object. Once the window has closed and the
program's state is freed, the plain reference (``benchmarks/reference``)
starts from the same weights, decodes the same files itself, draws the
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

from benchmarks.reference import data as ref_data
from benchmarks.reference import gan as ref_gan
from benchmarks.reference import model as ref_model
from benchmarks.reference import perturb as ref_perturb
from benchmarks.traffic import vocabulary

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
    the precision ``low`` ("bf16" as the configuration states for the
    relation model, "fp8" for the control, which also computes the GAN in
    bfloat16). Returns the losses of each step, the first gradient of
    each leaf, each leaf's change and the starting weights.
    ``batch_hook``, if given, edits each numpy batch first
    (``benchmarks/calibrate.py`` plants faults there)."""
    with _Exact():
        return _reference_steps(cfg, split, paths, cfg_seed, weight_seed,
                                device, low, n_steps, workers, batch_hook)


def _reference_steps(cfg, split, paths, cfg_seed, weight_seed, device, low,
                     n_steps, workers, batch_hook):
    num = ref_model.Numerics(low)
    P = ref_model.make_weights(ref_model.param_spec(cfg), weight_seed,
                               device, stored=ref_model.stored_types(cfg))
    gan = cfg.get("gan", False)
    if gan:
        P.update(ref_gan.make(ref_gan.param_spec(cfg), weight_seed + 1,
                              device))
        S = ref_gan.make(ref_gan.sn_spec(cfg), weight_seed + 2, device)
        names, _ = vocabulary(cfg["num_classes"], cfg["num_predicates"])
        graphn = ref_perturb.GraphN(
            ref_perturb.class_embeddings(names),
            *ref_perturb.pair_counts(split.gt_classes, split.relationships),
            L=cfg["L"], topk=cfg["topk"], alpha=cfg["graphn_a"])
    for n, t in P.items():
        t.requires_grad_(not ref_model.frozen(n))
    rel_names = [n for n, _, _ in ref_model.param_spec(cfg)
                 if not ref_model.frozen(n)]
    sgd = ref_model.ClippedSGD({n: P[n] for n in
                                [n for n, _, _ in ref_model.param_spec(cfg)]},
                               lr=cfg["lr"] * cfg["batch_size"],
                               l2=cfg["l2"], clip=cfg["clip"])
    opts = [sgd]
    if gan:
        opts += [ref_gan.Adam(P, [n for n in P if n.startswith(prefix)], lr,
                              cfg["beta1"], cfg["beta2"])
                 for prefix, lr in (("G.", cfg["lrG"]), ("D_", cfg["lrD"]))]
    init = {n: P[n].detach().clone() for n in P if not ref_model.frozen(n)}
    gen = torch.Generator(device=device).manual_seed(cfg_seed * 100003)
    losses, first = [], {}
    entry_paths = [paths[i] for i in split.entry_file]
    for k in range(n_steps):
        idx = ref_data.batch_indices(len(split), cfg["batch_size"], cfg_seed,
                                     0, k)
        nb = ref_data.batch(entry_paths, split.gt_boxes, split.gt_classes,
                            split.relationships, idx, cfg_seed, 0,
                            cfg["im_scale"], cfg["max_nodes"],
                            cfg["max_edges"], workers)
        if batch_hook is not None:
            nb = batch_hook(nb)
        tb = batch_tensors(nb, device)
        if gan:
            fake = graphn.batch(nb["classes"], nb["boxes"], nb["rels"],
                                nb["node_mask"], nb["rel_mask"], 0, cfg_seed)
            losses.append(ref_gan.gan_step(
                P, S, opts, tb, torch.from_numpy(fake).to(device), gen, cfg,
                num))
        else:
            losses.append(ref_model.train_step(P, sgd, tb, gen, cfg, num))
        if k == 0:
            first = {n: sgd.momentum[n] - cfg["l2"] * init[n]
                     for n in rel_names}
            for opt in opts[1:]:
                first.update({n: opt.mu[n] / (1 - opt.b1)
                              for n in opt.names})
    change = {n: P[n].detach() - init[n] for n in init}
    return {"losses": losses, "first": first, "change": change,
            "init": init}


def program_first(opt_state: Dict[str, torch.Tensor],
                  init: Dict[str, torch.Tensor], l2: float, device):
    """The first gradient from the program's optimizer states: SGD's
    momentum less the decay term (names without a prefix), Adam's first
    moment over 1 - beta1 (already divided, see ``program.py``)."""
    return {n: opt_state[n].to(device) - (0.0 if n.startswith(("G.", "D_"))
                                          else l2) * init[n]
            for n in init}


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
