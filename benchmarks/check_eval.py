"""The comparison that decides ``correct`` in a cell that evaluates.

The window keeps the host outputs of the first ``check_batches`` batches
of each regime as ``val_epoch`` got them (``evaluation.Probe``). Once the
window has closed and the program's state is freed, the plain reference
(``benchmarks/reference``) retakes those batches' images from the same
weights and files: each image alone, decoded and resized by the
reference, every ordered pair of its distinct objects, no ladder, no
dedup, no dropout. Compared, each against its limit in
``benchmarks/limits/<config>.evaluate.json``:

- ``rel_score_gap``: over both regimes' images and every pair valid on
  either side, the largest |program - reference| of a predicate's
  probability (a pair missing on one side reads 0 there), over the
  reference's largest probability;
- ``obj_score_gap``: sgcls's object scores (the best non-background
  class's probability), the largest gap over the reference's largest;
- ``obj_label_disagree``: the share of sgcls's objects whose label the
  two sides predict differently.

Recall@K of both sides through one ``SGGEvaluator`` is printed beside
them and not judged: rankings swap on rounding.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmarks.check import _Exact
from benchmarks.reference import data as ref_data
from benchmarks.reference import model as ref_model

MODES = ("predcls", "sgcls")
INF = float("inf")


def ordered_pairs(n: int) -> np.ndarray:
    """(n(n-1), 2) every ordered pair of distinct objects, subject-major."""
    s, o = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = s != o
    return np.stack([s[keep], o[keep]], 1)


def image_outputs(P, canvas: np.ndarray, boxes: np.ndarray, cfg: dict,
                  num, device) -> Dict[str, np.ndarray]:
    """The reference's eval forward of one image: sgcls's object scores
    and labels, every ordered pair and its predicate distribution."""
    pairs = ordered_pairs(len(boxes))
    pt = torch.from_numpy(pairs).to(device)[None]
    batch = {"images": torch.from_numpy(canvas).to(device)[None],
             "boxes": torch.from_numpy(boxes).to(device)[None]}
    out = ref_model.relation_model(P, batch, pt, torch.ones(
        pt.shape[:2], dtype=torch.bool, device=device), None, cfg, num)
    probs = torch.softmax(out["obj_logits"][0].float(), -1)
    scores, preds = probs[:, 1:].max(-1)
    return {"obj_scores": scores.cpu().numpy(),
            "obj_preds": (preds + 1).cpu().numpy(), "pairs": pairs,
            "rel_dists": torch.softmax(out["rel_logits"][0].float(), -1)
            .cpu().numpy()}


def reference_outputs(cfg: dict, split, paths: List[str], weight_seed: int,
                      device, low: str, entries, workers: int = 8) -> dict:
    """``{entry: outputs}`` of the reference in the precision ``low``
    (``bf16`` as the configuration states, ``fp8`` for the control)."""
    num = ref_model.Numerics(low)
    out = {}
    with _Exact(), torch.no_grad():
        P = ref_model.make_weights(ref_model.param_spec(cfg), weight_seed,
                                   device, ref_model.stored_types(cfg))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            examples = pool.map(
                lambda i: ref_data.test_example(
                    paths[split.entry_file[i]], split.gt_boxes[i],
                    cfg["im_scale"]), entries)
            for i, (canvas, boxes) in zip(entries, examples):
                out[i] = image_outputs(P, canvas, boxes, cfg, num, device)
    return out


def check_entries(mix: dict, cfg: dict) -> List[int]:
    """The entries of the first ``check_batches`` batches."""
    return list(range(mix["check_batches"] * cfg["eval_batch_size"]))


def program_outputs(kept: dict, split, cfg: dict) -> dict:
    """``{(mode, entry): outputs}`` from the host outputs the window kept,
    ``{(mode, batch): val_epoch's arrays}``: each image's real objects and
    its valid pairs."""
    B = cfg["eval_batch_size"]
    out = {}
    for (mode, k), host in kept.items():
        for i, mask in enumerate(host["pair_mask"]):
            e = k * B + i
            if e >= len(split):
                break
            n = len(split.gt_classes[e])
            out[(mode, e)] = {"obj_scores": host["obj_scores"][i][:n],
                              "obj_preds": host["obj_preds"][i][:n],
                              "pairs": host["pairs"][i][mask],
                              "rel_dists": host["rel_dists"][i][mask]}
    return out


def in_place_of_program(ref: dict, split) -> dict:
    """The reference's outputs as the program's of both regimes (predcls:
    the annotated labels, scores 1)."""
    out = {}
    for e, r in ref.items():
        out[("sgcls", e)] = r
        out[("predcls", e)] = dict(
            r, obj_preds=np.asarray(split.gt_classes[e]),
            obj_scores=np.ones(len(r["obj_scores"]), np.float32))
    return out


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


def compare(prog: dict, ref: dict, split) -> dict:
    """The three numbers of the module's text, each with where it was
    worst, over the reference's entries and both regimes."""
    rel, rel_at, rel_top = 0.0, None, 0.0
    obj, obj_at, obj_top = 0.0, None, 0.0
    wrong, total = 0, 0
    for e, r in sorted(ref.items()):
        n = len(split.gt_classes[e])
        Dr, Hr, _ = _dense(r, n)
        rel_top = max(rel_top, float(Dr[Hr].max()) if Hr.any() else 0.0)
        for mode in MODES:
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
            if mode != "sgcls":
                continue
            sp = np.asarray(p["obj_scores"], np.float64)
            sr = np.asarray(r["obj_scores"], np.float64)
            obj_top = max(obj_top, float(sr.max()))
            d = np.abs(sp - sr)
            g = _finite(float(d.max()))
            if g >= obj:
                obj, obj_at = g, f"sgcls entry {e} object {int(d.argmax())}"
            wrong += int((np.asarray(p["obj_preds"]) != r["obj_preds"]).sum())
            total += n
    return {"rel_score_gap": (rel / max(rel_top, 1e-30), rel_at),
            "obj_score_gap": (obj / max(obj_top, 1e-30), obj_at),
            "obj_label_disagree": (wrong / max(total, 1),
                                   f"{wrong} of {total} objects")}


def recalls(prog: dict, ref: dict, split) -> Dict[str, float]:
    """Recall@K of each regime, the program's less the reference's, both
    through the program's ``SGGEvaluator`` over the compared images
    (information: not judged)."""
    from sgg_torch.eval.sgg_eval import SGGEvaluator
    from sgg_torch.eval.surgery import filter_dets
    sides = {"program": prog, "reference": in_place_of_program(ref, split)}
    got = {}
    for mode in MODES:
        for side, outs in sides.items():
            ev = SGGEvaluator(mode)
            for e in sorted(ref):
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
            for mode in MODES for k in got[(mode, "reference")]
            if k.startswith("R@")}
