"""Training loop: model construction, the epoch loop, checkpoints,
validation and the test sweep.

Counterpart of ``sgg_tpu/train/trainer.py`` (reference ``main.py``): the
epoch loop with interval loss averaging and s/batch reporting
(``main.py:196-236``), per-epoch checkpoints with auto-resume
(``main.py:249-254``), validation after the first epoch and then every
``VAL_EVERY`` epochs, and the final test sweep over all eval splits
(``main.py:256-288``). One process on one device (``config.device``).
In mode sgdet the relation model trains on the detections of a frozen,
pretrained detector (``main.py:62-63``; ``sgg_torch/pretrain_detector.py``
writes one), which also serves validation and the test sweep. Batches
reach the step in the config's ``image_format`` (uint8 canvases are
normalized on the device), float canvases in bfloat16 when the model
computes in it, their copies to the device issued ahead on a stream of
their own while the previous steps run (``device_prefetch``). Not ported yet, each raising
``NotImplementedError`` that names it: the feature cache, GAN training and
multi-device training.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from sgg_torch import constants
from sgg_torch.config import Config
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.pipeline import (BatchLoader, device_prefetch,
                                     to_image_dtype)
from sgg_torch.device import resolve_device
from sgg_torch.eval.driver import val_epoch
from sgg_torch.models.frequency_bias import (count_matrices,
                                             log_predicate_distribution)
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.models.sgdet import make_sgdet_train_step
from sgg_torch.train import checkpoint as ckpt
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step


def build_model(config: Config, train_data: SGGDataset, *,
                device="cuda", seed: int = 0) -> RelModelIMP:
    """Flagship IMP model from config + dataset vocabulary (main.py:54-60),
    with seeded random weights, computing in the config's type over
    float32 master weights (the frozen trunk stored in that type), in eval
    mode on ``device`` (the card unless the caller asks for the CPU). In
    mode sgdet it has no trunk: the detector's feature map feeds it."""
    dev = resolve_device(device)
    freq_table = None
    if config.use_bias:
        fg, bg = count_matrices(train_data.gt_boxes, train_data.gt_classes,
                                train_data.relationships,
                                train_data.num_classes,
                                train_data.num_predicates, must_overlap=True)
        freq_table = log_predicate_distribution(fg, bg)
    obj_dim = 1024 if config.backbone == "resnet50" else 4096
    model = RelModelIMP(
        num_classes=train_data.num_classes,
        num_predicates=train_data.num_predicates,
        mode=config.mode, use_bias=config.use_bias,
        test_bias=config.test_bias, obj_dim=obj_dim,
        backbone=config.backbone, edge_model=config.edge_model,
        freq_table=freq_table)
    init_weights(model, seed)  # the bias table keeps its counts
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" \
        else torch.float32
    return model.to_compute_dtype(dtype).to(dev).eval()


# the reference evaluates every 5 epochs: evaluation is slow and noisy
# (main.py:258-259)
VAL_EVERY = 5


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to sgg_torch yet "
                               f"(ROADMAP Queue A)")


class Trainer:
    """Owns the model, the optimizer, the train step and the epoch, val
    and test loops, on ``config.device``.

    Mode sgdet needs ``detector`` (a ``FasterRCNNVGG`` or
    ``FasterRCNNFPN``, of the config's backbone); ``det_state``, a
    detector payload (``checkpoint.load_detector``), is loaded into it
    with ``strict=True``. The detector is frozen and is not part of the
    run's checkpoints: they hold the relation model and its optimizer."""

    def __init__(self, config: Config, splits: Dict[str, SGGDataset],
                 model: Optional[RelModelIMP] = None, detector=None,
                 det_state: Optional[Dict] = None):
        if config.mode == "sgdet" and detector is None:
            raise ValueError("sgdet training needs a (pretrained) detector")
        if config.feature_cache:
            raise _not_ported("the feature cache")
        if config.gan:
            raise _not_ported("GAN training")
        if config.num_devices > 1:
            raise _not_ported("multi-device training")
        self.config = config
        self.splits = splits
        self.train_data = splits["train"]
        self.device = resolve_device(config.device)
        self.model = (model.to(self.device) if model is not None else
                      build_model(config, self.train_data,
                                  device=self.device, seed=config.seed))
        self.detector = None
        if detector is not None:
            if det_state is not None:
                ckpt.load_detector_state(detector, det_state)
            dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" \
                else torch.float32
            self.detector = detector.requires_grad_(False).to_compute_dtype(
                dtype).to(self.device).eval()
        if config.mode != "sgdet" and config.max_edges < config.rels_per_img:
            # the padded edge bucket bounds the per-image relation budget;
            # only images with more candidate pairs than the bucket are
            # affected (reference budget: rels_per_img)
            print(f"[trainer] edge budget = min(max_edges "
                  f"{config.max_edges}, rels_per_img "
                  f"{config.rels_per_img}) — raise -max_edges for full "
                  f"budget parity on graphs with > {config.max_edges} "
                  f"candidate pairs")
        self.steps_per_epoch = max(len(self.train_data) // config.batch_size,
                                   1)
        self.optimizer = Optimizer(config, self.model, self.steps_per_epoch)
        if config.mode == "sgdet":
            self.train_step = make_sgdet_train_step(
                self.detector, self.model, config, self.optimizer)
        else:
            self.train_step = make_train_step(self.model, config,
                                              self.optimizer)
        self.start_epoch = 0
        self.global_iter = 0
        if config.save_dir:
            os.makedirs(config.save_dir, exist_ok=True)
            self._restore()

    # ------------------------------------------------------------------
    def _payload(self, epoch: int) -> Dict:
        params = dict(self.model.named_parameters())
        return {
            "step": torch.tensor(self.optimizer.count),
            "params": {k: v.detach() for k, v in params.items()},
            "batch_stats": dict(self.model.named_buffers()),
            "opt_state": self.optimizer.state_dict(),
            "epoch": torch.tensor(epoch),
        }

    def save(self, epoch: int) -> None:
        ckpt.save_payload(self.config.save_dir, self._payload(epoch), epoch)

    def _restore(self) -> None:
        # the payload is the relation model's alone: a frozen detector's
        # leaves are never counted as the run's own
        restored, last, _, stats = ckpt.optimistic_restore_payload(
            self.config.save_dir, self._payload(0),
            map_location=self.device)
        if last < 0:
            return
        # the run's own save_dir: a partial match usually means config
        # drift (e.g. a changed hidden_dim), and resuming part random-init
        # at a saved epoch would corrupt the run, so say which leaves kept
        # their init values
        if stats["missing"] or stats["unused"]:
            print(f"[resume] WARNING: checkpoint epoch {last} in "
                  f"{self.config.save_dir} only partially matches this "
                  f"run's state — {len(stats['missing'])} leaves kept "
                  f"their fresh-init values "
                  f"(first: {stats['missing'][:5]}), "
                  f"{len(stats['unused'])} on-disk leaves had no home "
                  f"(first: {stats['unused'][:5]}).")
        with torch.no_grad():
            for coll in ("params", "batch_stats"):
                live = dict(self.model.named_parameters()) \
                    if coll == "params" else dict(self.model.named_buffers())
                for k, v in restored[coll].items():
                    live[k].copy_(v)
        self.optimizer.load_state_dict(restored["opt_state"])
        self.optimizer.count = int(restored["step"])
        self.start_epoch = last + 1
        self.global_iter = self.optimizer.count
        print(f"resumed from epoch {last}")

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch (reference train_epoch, main.py:196-236). Losses stay
        on the device between print intervals; a non-finite interval mean
        raises ``FloatingPointError``."""
        cfg = self.config
        loader = BatchLoader(self.train_data, batch_size=cfg.batch_size,
                             max_nodes=cfg.max_nodes,
                             max_edges=cfg.max_edges, seed=cfg.seed,
                             num_workers=cfg.num_workers,
                             image_format=cfg.image_format,
                             im_scale=constants.IM_SCALE)  # read per call
        loader._epoch = epoch
        # the next batches' copies to the device run while a step does
        batches = device_prefetch(
            (to_image_dtype(b, cfg.compute_dtype) for b in loader),
            self.device)
        generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed * 100003 + epoch)
        accum = defaultdict(list)
        epoch_means = defaultdict(list)
        t0 = time.time()
        for b_i, batch in enumerate(batches):
            metrics = self.train_step(batch, generator)
            self.global_iter += 1
            for k, v in metrics.items():
                accum[k].append(v)
            if (b_i + 1) % cfg.print_interval == 0:
                means = self._means(accum)  # one host sync an interval
                if not all(map(math.isfinite, means.values())):
                    # the reference kills the run on a non-finite loss
                    # (detector/engine.py:41-44); a silent NaN would burn
                    # the remaining epochs
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch} batch {b_i}: "
                        f"{means}")
                for k, v in means.items():
                    epoch_means[k].append(v)
                dt = (time.time() - t0) / cfg.print_interval
                print(f"e{epoch} b{b_i + 1} "
                      + " ".join(f"{k}={v:.4f}" for k, v in means.items())
                      + f" {dt:.3f}s/batch", flush=True)
                accum.clear()
                t0 = time.time()
        if accum:
            for k, v in self._means(accum).items():
                epoch_means[k].append(v)
        return {k: sum(v) / len(v) for k, v in epoch_means.items()}

    @staticmethod
    def _means(accum) -> Dict[str, float]:
        keys = list(accum)
        means = torch.stack([torch.stack(accum[k]).mean() for k in keys])
        return dict(zip(keys, means.tolist()))

    # ------------------------------------------------------------------
    def evaluate(self, split_names, verbose: bool = True,
                 collect_entries: bool = False) -> Dict[str, float]:
        results = {}
        for name in split_names:
            ds = self.splits.get(name)
            if ds is None or len(ds) == 0:
                continue
            res = val_epoch(
                self.model, ds, self.config, name, train=self.train_data,
                verbose=verbose, collect_entries=collect_entries,
                detector=self.detector, device=self.device)
            if collect_entries and "_entries" in res:
                results.setdefault("_entries", {})[name] = res.pop("_entries")
            for extra in ("_counters", "_throughput", "_detections"):
                if extra in res:
                    results.setdefault(extra, {})[name] = res.pop(extra)
            results.update(res)
        return results

    # ------------------------------------------------------------------
    def fit(self, val_names=("val_zs", "val_alls"),
            test_names=("test_zs", "test_10s", "test_100s", "test_alls")
            ) -> Dict[str, float]:
        """Full run: epochs + periodic val + final test (main.py:244-288).

        Validation runs after the first epoch and then every ``VAL_EVERY``
        epochs."""
        cfg = self.config
        for epoch in range(self.start_epoch, cfg.num_epochs):
            losses = self.train_epoch(epoch)
            print(f"epoch {epoch}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in losses.items()))
            if cfg.save_dir:
                self.save(epoch)
            run_val = (epoch == self.start_epoch
                       or (epoch % VAL_EVERY == 0
                           and epoch < cfg.num_epochs - 1))
            if cfg.val_size != 0 and run_val:
                self.evaluate(val_names, verbose=False)
        results = {}
        if not cfg.notest:
            results = self.evaluate(test_names,
                                    collect_entries=cfg.save_scores)
            if cfg.save_dir and results:
                with open(os.path.join(cfg.save_dir, "test_results.json"),
                          "w") as f:
                    json.dump({k: v for k, v in results.items()
                               if not k.startswith("_")}, f, indent=2)
            if cfg.save_scores and cfg.save_dir and "_entries" in results:
                # test prediction entries (reference main.py:284-288)
                import pickle
                with open(os.path.join(cfg.save_dir,
                                       "test_predictions.pkl"), "wb") as f:
                    pickle.dump(results.pop("_entries"), f)
        return results
