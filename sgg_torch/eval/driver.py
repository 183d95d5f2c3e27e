"""Evaluation loop: run a model over an eval split and compute all metrics.

Counterpart of ``sgg_tpu/eval/driver.py`` (reference ``lib/eval.py``
``val_epoch``/``val_batch``):

* sgcls runs both the predcls and sgcls evaluators (``eval.py:21``);
* sgdet runs the sgdet evaluators only, and not on ``val_`` splits
  (``eval.py:34-35``), through the detector's box-threshold retry
  0.2 -> 0.05 -> 0.01 (``eval.py:125-133``, ``models/sgdet.py``);
* GC + no-GC evaluators, per-predicate mean-recall lists (skipped for
  zero-shot and val splits, ``eval.py:46-53``), per-triplet statistics for
  all-shot splits (``eval.py:41``);
* optional predicate down-weighting by frequency^pred_weight
  (``eval.py:24-29,164-168``).

Eval batches are padded to fixed shapes; the per-batch pair budget comes
from a ladder, with the unordered-union dedup and its exact fall-back.
Matching runs in the numpy evaluator on the host.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from sgg_torch import constants
from sgg_torch.config import Config
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.pipeline import BatchLoader
from sgg_torch.device import resolve_device
from sgg_torch.eval.sgg_eval import MeanRecallEvaluator, SGGEvaluator
from sgg_torch.eval.surgery import filter_dets
from sgg_torch.models.frequency_bias import count_matrices
from sgg_torch.models.sgdet import sgdet_eval_with_retry
from sgg_torch.parallel import Group, all_agree, gather_rows, shard_rows
from sgg_torch.train.step import make_eval_step
from sgg_torch.utils import counters

ALL_SHOT_SPLITS = ("val_alls", "test_alls")


def predicate_reweighting(train: SGGDataset, pred_weight: float) -> np.ndarray:
    """Per-predicate weights from dataset frequency (eval.py:24-29)."""
    fg, bg = count_matrices(train.gt_boxes, train.gt_classes,
                            train.relationships, train.num_classes,
                            train.num_predicates, must_overlap=True)
    fg[:, :, 0] = bg + 1
    fg = fg + 1
    return fg.mean(axis=(0, 1)) ** pred_weight


def apply_predicate_weights(rel_scores: np.ndarray,
                            weights: np.ndarray) -> np.ndarray:
    """Down-weight frequent predicates and renormalize (eval.py:164-168)."""
    out = rel_scores.copy()
    out[:, 1:] = out[:, 1:] * (1.0 / weights[1:])
    out = out / out.sum(axis=1, keepdims=True)
    return out


def _to_numpy(out) -> Dict[str, np.ndarray]:
    host = {
        "obj_scores": out["obj_scores"].float().cpu().numpy(),
        "obj_preds": out["obj_preds"].cpu().numpy(),
        "rel_dists": out["rel_dists"].float().cpu().numpy(),
        "pairs": out["pairs"].cpu().numpy(),
        "pair_mask": out["pair_mask"].cpu().numpy(),
    }
    if "dedup_ok" in out:
        host["dedup_ok"] = out["dedup_ok"].cpu().numpy()
    return host


def val_epoch(model, dataset: SGGDataset, config: Config, name: str, *,
              train: Optional[SGGDataset] = None, n_batches: int = -1,
              eval_batch_size: Optional[int] = None,
              with_images: bool = True, collect_entries: bool = False,
              log_fn=None, verbose: bool = True, pair_ladder=None,
              detector=None, device="cuda",
              feature_cache=None, group: Optional[Group] = None
              ) -> Dict[str, float]:
    """Evaluate one split of ``model`` (a ``RelModelIMP``) on ``device``
    (the card unless the caller asks for the CPU). In mode sgdet pass the
    frozen ``detector`` (a ``FasterRCNNVGG`` or ``FasterRCNNFPN``).

    Returns a flat results dict ``{eval_m}/{name}_R@K_{GC|NOGC}`` etc., as
    the JAX package's ``val_epoch``. Non-scalar extras: ``_counters`` (the
    ladder, dedup and sgdet cap events of this call), ``_throughput`` (per
    regime, the images evaluated and the wall seconds of the regime's loop,
    host evaluator included) and, in mode sgdet, ``_detections`` (per
    image: ``n_det`` detections and the selected threshold
    ``sel_thresh``; the detections' ``boxes``, ``labels`` and ``scores``
    beside the image's ``gt_boxes`` and ``gt_classes``, in the canvas frame,
    for ``eval.det_eval.DetectionEvaluator``).

    ``feature_cache``: the split's frozen-trunk cache
    (``data/feature_cache.py``): its batches carry the trunk's maps, and
    its canvas scale is the loader's.

    ``pair_ladder``: candidate-pair budgets (ascending, ``None`` = dense
    N*(N-1)); default ``[128, 512, 2048, None]``. Per batch the smallest
    rung covering every image's valid pairs is used (exact).

    ``group``: a data-parallel group (``sgg_torch.parallel``). Every rank
    loads the whole eval batch; when the ranks divide it, each runs its
    rows and the host outputs are gathered over the group's host link
    (otherwise each runs the whole batch). The pair budget is chosen from
    the whole batch and the dedup fall-back is decided on the gathered
    outputs (or agreed over the ranks), so every rank takes the same
    branch, runs the same collectives and computes the same metrics. SGDet
    batches are not split, as in the JAX package.
    """
    dev = resolve_device(device)
    sgdet = config.mode == "sgdet"
    if sgdet and detector is None:
        raise ValueError("sgdet evaluation needs the detector")
    eval_modes = ["sgdet"] if sgdet else ["predcls", "sgcls"]

    pred_weights = None
    if config.pred_weight != 0 and train is not None:
        pred_weights = predicate_reweighting(train, config.pred_weight)

    per_triplet = name in ALL_SHOT_SPLITS
    with_mr = not name.startswith("val_") and "zs" not in name

    evaluators = {}
    mr_lists = {}
    tc = train.triplet_counts if train is not None else dataset.triplet_counts
    for m in eval_modes:
        if m == "sgdet" and name.startswith("val_"):
            continue  # skipped for validation (eval.py:34-35)
        evaluators[m] = SGGEvaluator(m)
        # per-triplet metrics weight GT triplets by their TRAINING-set
        # frequency (reference main.py:260-261)
        evaluators[m + "_nogc"] = SGGEvaluator(
            m, multiple_preds=True, per_triplet=per_triplet,
            triplet_counts=tc if per_triplet else None)
        if with_mr:
            mr_lists[m] = MeanRecallEvaluator(m, dataset.ind_to_predicates)
            mr_lists[m + "_nogc"] = MeanRecallEvaluator(
                m, dataset.ind_to_predicates, multiple_preds=True)

    # size the eval bucket to the split's largest graph so no GT relation
    # is dropped from the recall denominator (the reference evaluates every
    # GT object at batch size 1, lib/eval.py:144-170)
    n_obj_max = max((len(c) for c in dataset.gt_classes), default=2)
    eval_nodes = max(config.max_nodes, -(-n_obj_max // 8) * 8)

    entries = []
    n_evaluated = 0
    counters_before = counters.snapshot()
    full_pairs = eval_nodes * (eval_nodes - 1)
    if pair_ladder is None:
        pair_ladder = [b for b in (128, 512, 2048) if b < full_pairs] + [None]
    step_cache: Dict = {}
    throughput = {}
    detections = {k: [] for k in ("n_det", "sel_thresh", "boxes", "labels",
                                  "scores", "gt_boxes", "gt_classes")}

    def get_eval_step(m, budget, dedup=True):
        key = (m, budget, dedup)
        if key not in step_cache:
            step_cache[key] = make_eval_step(model, mode=m, max_pairs=budget,
                                             dedup=dedup, device=dev)
        return step_cache[key]

    for m in eval_modes:
        if m not in evaluators:
            continue
        t0 = time.perf_counter()
        n_mode = 0
        # the sgdet step is the detector's too: 8 images a batch
        bs = eval_batch_size or (8 if m == "sgdet" else 16)
        loader = BatchLoader(dataset, batch_size=bs, max_nodes=eval_nodes,
                             max_edges=config.max_edges, shuffle=False,
                             drop_last=False, with_images=with_images,
                             feature_cache=feature_cache,
                             im_scale=(feature_cache.im_scale
                                       if feature_cache is not None
                                       else constants.IM_SCALE))
        img_base = 0
        for b_i, batch in enumerate(loader):
            if n_batches > -1 and b_i >= n_batches:
                break
            gt_node_mask = batch.node_mask
            gt_boxes_b = batch.boxes
            if m == "sgdet":
                out = sgdet_eval_with_retry(detector, model, batch,
                                            device=dev)
                node_mask, boxes = out["det_mask"], out["det_boxes"]
                n_real = min(batch.batch_size, len(dataset) - img_base)
                detections["n_det"] += out["n_det"][:n_real].tolist()
                detections["sel_thresh"] += \
                    out["sel_thresh"][:n_real].tolist()
                for i in range(n_real):  # valid slots come first
                    n, n_gt = int(out["n_det"][i]), int(gt_node_mask[i].sum())
                    for k, src in (("boxes", "det_boxes"),
                                   ("labels", "det_labels"),
                                   ("scores", "det_scores")):
                        detections[k].append(out[src][i][:n])
                    detections["gt_boxes"].append(gt_boxes_b[i][:n_gt])
                    detections["gt_classes"].append(
                        np.asarray(batch.classes[i][:n_gt]))
            else:
                n_i = gt_node_mask.sum(axis=1)
                need = int((n_i * (n_i - 1)).max()) if len(n_i) else 0
                budget = next((b for b in pair_ladder
                               if b is None or b >= need), None)
                counters.bump("eval_ladder_batches")
                counters.bump("eval_ladder_dense" if budget is None
                              else f"eval_ladder_rung_{budget}")
                sharded = (group is not None
                           and batch.batch_size % group.world == 0)
                dev_batch = (shard_rows(batch, group.rank, group.world)
                             if sharded else batch).to(dev)
                for dedup in (True, False):
                    out = _to_numpy(get_eval_step(m, budget, dedup)(
                        dev_batch))
                    if sharded:
                        out = gather_rows(out)
                    # the all-pairs enumerations are swap-closed, so this
                    # never fires in practice; the fall-back keeps eval
                    # exact anyway
                    ok = not dedup or bool(out["dedup_ok"].all())
                    if group is not None and not sharded:
                        ok = all_agree(ok)
                    if not ok:
                        counters.bump("eval_dedup_fallback")
                        continue
                    break
                node_mask, boxes = gt_node_mask, gt_boxes_b
            obj_scores, obj_preds = out["obj_scores"], out["obj_preds"]
            rel_dists, pairs = out["rel_dists"], out["pairs"]
            pair_mask = out["pair_mask"]
            for i in range(batch.batch_size):
                idx = img_base + i
                if idx >= len(dataset):
                    break
                n = int(node_mask[i].sum())
                gt_rels = dataset.relationships[idx]
                if len(gt_rels) == 0 or n == 0:
                    continue
                if m == "sgdet" and n < 2:
                    # fewer than 2 detections at every threshold: the
                    # reference raises and the image never reaches the
                    # evaluator (rel_model_base.py:234-235, eval.py:227-228)
                    continue
                entry = filter_dets(boxes[i][:n], obj_scores[i][:n],
                                    obj_preds[i][:n], pairs[i], rel_dists[i],
                                    pair_mask[i])
                if pred_weights is not None:
                    entry["rel_scores"] = apply_predicate_weights(
                        entry["rel_scores"], pred_weights)
                n_gt = int(gt_node_mask[i].sum())
                if n_gt != len(dataset.gt_classes[idx]):
                    raise RuntimeError(
                        f"eval graph truncated: image {idx} has "
                        f"{len(dataset.gt_classes[idx])} GT objects but the "
                        f"batch carries {n_gt} (bucket {eval_nodes})")
                gt_entry = {
                    "gt_classes": dataset.gt_classes[idx][:n_gt],
                    "gt_relations": gt_rels,
                    "gt_boxes": gt_boxes_b[i][:n_gt],
                }
                if collect_entries and m == eval_modes[0]:
                    # boxes in ORIGINAL image pixels (reference
                    # rel_model_base.py:237-240)
                    export = dict(entry)
                    if batch.im_scale_org is not None:
                        export["pred_boxes"] = (entry["pred_boxes"]
                                                * float(batch.im_scale_org[i]))
                    entries.append(export)
                evaluators[m].add_image(gt_entry, entry)
                evaluators[m + "_nogc"].add_image(gt_entry, entry)
                n_evaluated += 1
                n_mode += 1
                if with_mr:
                    mr_lists[m].add_image(gt_entry, entry)
                    mr_lists[m + "_nogc"].add_image(gt_entry, entry)
            img_base += batch.batch_size
        throughput[m] = {"images": n_mode,
                         "seconds": time.perf_counter() - t0}

    if n_evaluated == 0 and len(dataset) > 0 and evaluators and \
            n_batches != 0:
        raise RuntimeError(
            f"val_epoch evaluated zero images over '{name}' "
            f"({len(dataset)} available) — broken input pipeline?")

    results: Dict[str, float] = {}
    for m in eval_modes:
        if m not in evaluators:
            continue
        for key, sfx in ((m, "GC"), (m + "_nogc", "NOGC")):
            res = evaluators[key].results(verbose=verbose)
            for rk, v in res.items():
                if rk.startswith("R@"):
                    results[f"{m}/{name}_{rk}_{sfx}"] = v
                else:
                    results[f"{m}/{name}_{rk}"] = v
            if with_mr:
                for rk, v in mr_lists[key].results().items():
                    results[f"{m}/{name}_{rk}_{sfx}"] = v
    # headline scalar: mean of every R@K over all regimes and GC settings
    # (reference 'avg/%s_R', lib/eval.py:91,114)
    r_vals = [v for k, v in results.items()
              if "_R@" in k and np.isfinite(v)]
    if r_vals:
        results[f"avg/{name}_R"] = float(np.mean(r_vals))

    if log_fn is not None:
        log_fn(results)
    cap_events = counters.delta(counters_before)
    if cap_events:
        results["_counters"] = cap_events  # type: ignore
        if verbose:
            print(f"[val_epoch {name}] exactness-cap counters: {cap_events}")
    results["_throughput"] = throughput  # type: ignore
    if sgdet:
        results["_detections"] = detections  # type: ignore
    if collect_entries:
        results["_entries"] = entries  # type: ignore
    return results
