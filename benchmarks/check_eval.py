"""The comparison that decides ``correct`` in a cell that evaluates.

The window keeps the host outputs of the first ``check_batches`` batches
of each regime as the program's eval path got them (``evaluation.Probe``
and the family's ``eval_probe``). Once the window has closed and the
program's state is freed, the plain reference (the configuration's
family's ``eval_reference``) retakes those batches' images from the same
weights and files. The family's ``eval_compare`` gives the numbers,
each compared against its limit in
``benchmarks/limits/<config>.evaluate.json``; for a relation model's
outputs (``compare``):

- ``rel_score_gap``: over every regime's images and every pair valid on
  either side, the largest |program - reference| of a predicate's
  probability (a pair missing on one side reads 0 there), over the
  reference's largest probability;
- ``obj_score_gap``: the object scores (the best non-background class's
  probability) of the regimes that predict them, the largest gap over
  the reference's largest;
- ``obj_label_disagree``: the share of those objects whose label the two
  sides predict differently.

Recall@K of both sides through one ``SGGEvaluator`` is printed beside
them and not judged: rankings swap on rounding.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmarks import families
from benchmarks.check import _Exact

INF = float("inf")


def reference_outputs(cfg: dict, split, paths: List[str], weight_seed: int,
                      device, low: str, entries, workers: int = 8) -> dict:
    """``{entry: outputs}`` of the configuration's family's reference
    (``eval_reference``) in the precision ``low`` (``bf16`` as the
    configuration states, or its ``precision.control``), with TF32 off and
    no gradients."""
    with _Exact(), torch.no_grad():
        return families.of(cfg).eval_reference(
            cfg, split, paths, weight_seed, device, low, entries, workers)


def check_entries(mix: dict, cfg: dict) -> List[int]:
    """The entries of the first ``check_batches`` batches."""
    return list(range(mix["check_batches"] * cfg["eval_batch_size"]))


def _dense(o: dict, n: int):
    """(n, n, R) distributions, (n, n) where a pair is held, and the
    largest probability of a pair outside the image's objects."""
    pairs, rel = np.asarray(o["pairs"]), np.asarray(o["rel_dists"])
    inside = ((pairs >= 0) & (pairs < n)).all(1) & (pairs[:, 0] != pairs[:, 1])
    D = np.zeros((n, n, rel.shape[-1]), np.float64)
    H = np.zeros((n, n), bool)
    D[pairs[inside, 0], pairs[inside, 1]] = rel[inside]
    H[pairs[inside, 0], pairs[inside, 1]] = True
    outside = float(rel[~inside].max()) if (~inside).any() else 0.0
    return D, H, outside


def _finite(x: float) -> float:
    return INF if x != x else x


def compare(prog: dict, ref: dict, split, regimes, scored) -> dict:
    """The three numbers of the module's text, each with where it was
    worst, over the reference's entries and the ``regimes``, the object
    scores and labels in those of ``scored``."""
    rel, rel_at, rel_top = 0.0, None, 0.0
    obj, obj_at, obj_top = 0.0, None, 0.0
    wrong, total = 0, 0
    for e, r in sorted(ref.items()):
        n = len(split.gt_classes[e])
        Dr, Hr, _ = _dense(r, n)
        rel_top = max(rel_top, float(Dr[Hr].max()) if Hr.any() else 0.0)
        for mode in regimes:
            p = prog.get((mode, e))
            if p is None:
                missing = (INF, f"no output of {mode} entry {e}")
                return {"rel_score_gap": missing, "obj_score_gap": missing,
                        "obj_label_disagree": missing}
            Dp, Hp, outside = _dense(p, n)
            held = Hp | Hr
            gap = np.abs(np.where(Hp[..., None], Dp, 0.0)
                         - np.where(Hr[..., None], Dr, 0.0))[held]
            g = _finite(max(float(gap.max()) if gap.size else 0.0, outside))
            if g >= rel:
                s, o = np.argwhere(held)[int(gap.max(1).argmax())] \
                    if gap.size else (-1, -1)
                rel, rel_at = g, f"{mode} entry {e} pair ({s}, {o})"
            if mode not in scored:
                continue
            sp = np.asarray(p["obj_scores"], np.float64)
            sr = np.asarray(r["obj_scores"], np.float64)
            obj_top = max(obj_top, float(sr.max()))
            d = np.abs(sp - sr)
            g = _finite(float(d.max()))
            if g >= obj:
                obj, obj_at = g, f"{mode} entry {e} object {int(d.argmax())}"
            wrong += int((np.asarray(p["obj_preds"]) != r["obj_preds"]).sum())
            total += n
    return {"rel_score_gap": (rel / max(rel_top, 1e-30), rel_at),
            "obj_score_gap": (obj / max(obj_top, 1e-30), obj_at),
            "obj_label_disagree": (wrong / max(total, 1),
                                   f"{wrong} of {total} objects")}


def recalls(prog: dict, ref: dict, split, regimes) -> Dict[str, float]:
    """Recall@K of each regime, the program's less the reference's (``ref``
    as the family's ``eval_as_program`` gives it), both through the
    program's ``SGGEvaluator`` over the compared images (information: not
    judged)."""
    from sgg_torch.eval.sgg_eval import SGGEvaluator
    from sgg_torch.eval.surgery import filter_dets
    sides = {"program": prog, "reference": ref}
    entries = sorted({e for _, e in ref})
    got = {}
    for mode in regimes:
        for side, outs in sides.items():
            ev = SGGEvaluator(mode)
            for e in entries:
                o = outs.get((mode, e))
                if o is None:
                    continue
                boxes = split.gt_boxes[e]
                gt = {"gt_classes": split.gt_classes[e],
                      "gt_relations": split.relationships[e],
                      "gt_boxes": boxes}
                ev.add_image(gt, filter_dets(
                    boxes, o["obj_scores"], o["obj_preds"], o["pairs"],
                    o["rel_dists"], np.ones(len(o["pairs"]), bool)))
            got[(mode, side)] = ev.results()
    return {f"{mode} {k}": got[(mode, "program")][k]
            - got[(mode, "reference")][k]
            for mode in regimes for k in got[(mode, "reference")]
            if k.startswith("R@")}
