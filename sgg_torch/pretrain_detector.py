"""Detector pretraining: train a Faster R-CNN on a split's objects.

Counterpart of the JAX package's ``pretrain_detector.py`` (reference
``pretrain_detector.py`` with the torchvision engine,
``detector/engine.py``): the sum of the RPN objectness and box losses and
the RoI-head classifier and box losses, every detector parameter trained
(the backbone included: for the VGG16 detector through the backward
kernels of K2 and K1, for the ResNet50-FPN one through K1's at four
pyramid levels and the BatchNorms' scales and biases, never their
statistics), SGD at lr 0.005 with momentum 0.9 and coupled L2 5e-4, a
linear warmup over the first epoch's steps, the rate times 0.1 every 3
epochs, and a detector payload per epoch that ``python -m sgg_torch.main
-m sgdet -ckpt <dir>`` loads (with ``-backbone resnet50`` for the FPN
detector). Runs on the card unless the caller passes the CPU::

    python -m sgg_torch.pretrain_detector synthetic - <out_dir> 2 3
    python -m sgg_torch.pretrain_detector vg <data_dir> <out_dir>

``pretrain`` trains ``FasterRCNNFPN`` unless given another detector, as
the JAX package's does (the reference pretrains only the FPN detector);
the VGG16 one is ``pretrain(..., detector=FasterRCNNVGG(...))``. ``vg`` and
``gqa`` need ``h5py`` (vg) and PIL.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sgg_torch import constants
from sgg_torch.data.graph_batch import GraphBatch
from sgg_torch.data.pipeline import BatchLoader, device_prefetch
from sgg_torch.device import resolve_device
from sgg_torch.models.detector import (balanced_draws, init_detector_weights,
                                       roi_head_losses, rpn_losses)
from sgg_torch.train import checkpoint as ckpt

LR, MOMENTUM, WEIGHT_DECAY = 0.005, 0.9, 5e-4
WARMUP_MAX, LR_EPOCHS, LR_DECAY = 1000, 3, 0.1


def detector_lr_schedule(lr: float, steps_per_epoch: int,
                         num_epochs: int) -> Callable[[int], float]:
    """The rate of update ``count`` (0-based), equal to the JAX package's
    ``optax.join_schedules`` step by step, in its float32 arithmetic: a
    linear warmup from ``lr / 1000`` over ``min(1000, steps_per_epoch -
    1)`` updates (at least 1), then ``lr``, times 0.1 at epochs 3, 6, 9..."""
    warmup = min(WARMUP_MAX, steps_per_epoch - 1) if steps_per_epoch > 1 \
        else 0
    steps = max(warmup, 1)
    init, end = lr / 1000, lr
    rates, boundaries, cur = [], [steps], lr
    for e in range(LR_EPOCHS, num_epochs, LR_EPOCHS):
        rates.append(cur)
        boundaries.append(e * steps_per_epoch)
        cur *= LR_DECAY
    rates.append(cur)
    f32 = np.float32

    def schedule(count: int) -> float:
        # optax.linear_schedule: count clipped to [0, steps], in float32
        c = f32(min(max(count, 0), steps))
        frac = f32(1) - c / f32(steps)
        value = f32(f32(init - end) * frac) + f32(end)
        for boundary, rate in zip(boundaries, rates):
            if count >= boundary:
                value = f32(rate)
        return float(value)

    return schedule


class DetectorOptimizer:
    """optax ``chain(add_decayed_weights(5e-4), sgd(schedule, momentum=
    0.9))`` over every parameter that requires a gradient: ``g + wd * p``,
    the momentum trace ``g + 0.9 * t`` (from zero), ``p - lr * t``; no
    clipping. ``count`` is the number of updates applied."""

    def __init__(self, model: torch.nn.Module,
                 schedule: Callable[[int], float]):
        self.named = [(n, p) for n, p in model.named_parameters()
                      if p.requires_grad]
        for name, p in self.named:
            if p.dtype != torch.float32:
                raise TypeError(f"{name}: master weights must be float32, "
                                f"not {p.dtype}")
        self.params = [p for _, p in self.named]
        self.schedule = schedule
        self.sgd = torch.optim.SGD(self.params, lr=schedule(0),
                                   momentum=MOMENTUM,
                                   weight_decay=WEIGHT_DECAY)
        # optax's trace starts at zero: the same first step as SGD's own
        # start, and a fixed checkpoint layout
        for p in self.params:
            self.sgd.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.count = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        """One update; a parameter that took no gradient gets a zero one,
        so it still decays, as under optax."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.sgd.param_groups:
            group["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Momentum buffers by parameter name."""
        return {name: self.sgd.state[p]["momentum_buffer"]
                for name, p in self.named}


def detector_losses(detector, batch: GraphBatch,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict] = None, proposal_index=None):
    """The detector's forward on a batch on its device, with the GT boxes
    appended to its proposals, and its four losses: ``(losses, out)``.

    The samplers' uniforms come from ``generator`` (on the detector's
    device) unless ``draws`` gives them: ``{"rpn": (u_pos, u_neg) (B, K),
    "roi": (u_pos, u_neg) (B, P)}``. ``proposal_index`` (``(index,
    rpn_prop_mask)`` of a forward) fixes the RPN's proposal slots."""
    out = detector(batch.images, batch.im_hw, gt_boxes=batch.boxes,
                   gt_mask=batch.node_mask, proposal_index=proposal_index)
    if draws is None:
        dev = out["rpn_obj_logits"].device
        draws = {"rpn": balanced_draws(generator, out["rpn_obj_logits"].shape,
                                       dev),
                 "roi": balanced_draws(generator, out["prop_mask"].shape,
                                       dev)}
    losses = rpn_losses(draws["rpn"], out["anchors"], out["rpn_obj_logits"],
                        out["rpn_deltas"], batch.boxes, batch.node_mask)
    losses.update(roi_head_losses(
        draws["roi"], out["proposals"], out["prop_mask"],
        out["class_logits"], out["box_deltas"], batch.boxes, batch.classes,
        batch.node_mask))
    return losses, out


def make_detector_train_step(detector, optimizer: DetectorOptimizer):
    """Returns ``train_step(batch, generator, draws=None,
    proposal_index=None) -> metrics`` (device scalars; no host read).

    The detector runs in eval mode (no dropout in its box head; the JAX
    step uses ``train=False``); ``generator``, ``draws`` and
    ``proposal_index`` are ``detector_losses``'. The gradients stay on the
    parameters until the next step."""
    dev = next(detector.parameters()).device

    def train_step(batch: GraphBatch,
                   generator: Optional[torch.Generator],
                   draws: Optional[Dict] = None,
                   proposal_index=None) -> Dict[str, torch.Tensor]:
        detector.eval()
        optimizer.zero_grad()
        losses, out = detector_losses(detector, batch.to(dev), generator,
                                      draws, proposal_index)
        total = sum(losses.values())
        total.backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        # rounds-NMS convergence monitor: 1.0 unless a suppression chain
        # outran the round budget, read with the losses
        metrics["nms_converged_frac"] = out["nms_converged"].float().mean()
        return metrics

    return train_step


@dataclasses.dataclass
class PretrainState:
    """What ``pretrain`` leaves: the optimizer (``count`` updates applied,
    its momentum buffers) and the metrics read at each print interval."""

    optimizer: DetectorOptimizer
    history: List[Dict[str, float]]

    @property
    def step(self) -> int:
        return self.optimizer.count


def _means(accum) -> Dict[str, float]:
    keys = list(accum)
    means = torch.stack([torch.stack(accum[k]).mean() for k in keys])
    return dict(zip(keys, means.tolist()))  # one host read


def pretrain(splits, *, num_epochs: int = 10, batch_size: int = 3,
             lr: float = LR, save_dir: Optional[str] = None,
             max_nodes: int = 64, detector=None, with_images: bool = True,
             steps_per_print: int = 50, device=None):
    """Pretrain ``detector`` on ``splits["train"]``; returns ``(detector,
    PretrainState)``. With no ``detector``, a ``FasterRCNNFPN`` of the
    split's classes computing in bfloat16, the JAX package's default.

    The detector is moved to ``device`` (the card unless the caller asks
    for the CPU) and keeps its compute type (``to_compute_dtype``, over
    float32 master weights). Its weights are drawn anew from seed 0
    (``init_detector_weights``), as the JAX package initializes them from
    a fixed key. Every
    ``steps_per_print`` steps the interval's mean metrics are read, printed
    and kept with its seconds a batch (host included); a non-finite one
    raises ``FloatingPointError``. With
    ``save_dir``, each epoch writes a payload (``step``, ``params``,
    ``batch_stats``, ``opt_state``, ``epoch``)."""
    dev = resolve_device("cuda" if device is None else device)
    train_data = splits["train"]
    if detector is None:
        from sgg_torch.models.detector import FasterRCNNFPN
        detector = FasterRCNNFPN(train_data.num_classes).to_compute_dtype(
            torch.bfloat16)
    detector = init_detector_weights(detector, 0).to(dev).eval()
    loader = BatchLoader(train_data, batch_size=batch_size,
                         max_nodes=max_nodes, max_edges=1,
                         with_images=with_images,
                         im_scale=constants.IM_SCALE)  # read per call
    steps_per_epoch = max(len(train_data) // batch_size, 1)
    optimizer = DetectorOptimizer(
        detector, detector_lr_schedule(lr, steps_per_epoch, num_epochs))
    step_fn = make_detector_train_step(detector, optimizer)
    history: List[Dict[str, float]] = []

    def report(accum, epoch, b_i, t0, n):
        means = _means(accum)
        accum.clear()
        s_per_batch = (time.time() - t0) / max(n, 1)
        history.append(dict(means, epoch=epoch, batch=b_i + 1,
                            s_per_batch=s_per_batch))
        print(f"e{epoch} b{b_i + 1} "
              + " ".join(f"{k}={v:.4f}" for k, v in means.items())
              + f" {s_per_batch:.3f}s/b", flush=True)
        if not all(map(math.isfinite, means.values())):
            raise FloatingPointError(f"non-finite loss at epoch {epoch} "
                                     f"batch {b_i}: {means}")

    for epoch in range(num_epochs):
        loader._epoch = epoch
        generator = torch.Generator(device=dev).manual_seed(epoch)
        accum = defaultdict(list)
        t0, n, b_i = time.time(), 0, -1
        for b_i, batch in enumerate(device_prefetch(loader, dev)):
            metrics = step_fn(batch, generator)
            n += 1
            for k, v in metrics.items():
                accum[k].append(v)
            if (b_i + 1) % steps_per_print == 0:
                report(accum, epoch, b_i, t0, n)
                t0, n = time.time(), 0
        if accum:
            report(accum, epoch, b_i, t0, n)
        if save_dir:
            ckpt.save_payload(save_dir, {
                "step": torch.tensor(optimizer.count),
                "params": {k: v.detach()
                           for k, v in detector.named_parameters()},
                "batch_stats": dict(detector.named_buffers()),
                "opt_state": optimizer.state_dict(),
                "epoch": torch.tensor(epoch)}, epoch)
    return detector, PretrainState(optimizer, history)


def main(argv: Optional[Sequence[str]] = None):
    """CLI: ``python -m sgg_torch.pretrain_detector {vg,gqa,synthetic}
    DATA_DIR OUT_DIR [EPOCHS=10] [BATCH=3|2] [NUM_VAL_IM=5000] [LR=0.005]
    [-device cpu]``, the JAX package's arguments and defaults (reference
    ``pretrain_detector.py:130,145-149``: batch 3 for VG, 2 for GQA, the
    first NUM_VAL_IM train images kept for val). It trains ``pretrain``'s
    default, the ResNet50-FPN detector (bfloat16 compute over float32
    master weights), on the train split alone: ``vg`` reads
    ``DATA_DIR/VG/stanford_filtered`` without the non-overlap filter (the
    reference's pretraining loader; ``SGG_CHECK_SIZES=0`` for a fixture
    tree), ``gqa`` the GQA scene graphs; ``synthetic`` a 64-image split
    with the VG-Stanford vocabulary, DATA_DIR and NUM_VAL_IM unused."""
    p = argparse.ArgumentParser(prog="python -m sgg_torch.pretrain_detector")
    p.add_argument("dataset", choices=("vg", "gqa", "synthetic"))
    p.add_argument("data_dir")
    p.add_argument("out_dir")
    p.add_argument("epochs", nargs="?", type=int, default=10)
    p.add_argument("batch", nargs="?", type=int, default=None)
    p.add_argument("num_val_im", nargs="?", type=int, default=5000)
    p.add_argument("lr", nargs="?", type=float, default=LR)
    p.add_argument("-device", default="cuda")
    args = p.parse_args(argv)
    if args.dataset == "synthetic":
        from sgg_torch.data.synthetic import synthetic_splits
        train = synthetic_splits()["train"]
    elif args.dataset == "gqa":
        from sgg_torch.data import gqa
        train = gqa.load_split(gqa._GQAFiles(args.data_dir), "train",
                               num_val_im=args.num_val_im)
    else:
        from sgg_torch.data import visual_genome as vg
        check = os.environ.get("SGG_CHECK_SIZES", "1") != "0"
        train = vg.load_split(args.data_dir, "train", check_sizes=check,
                              num_val_im=args.num_val_im,
                              filter_non_overlap=False)
    batch = args.batch or (2 if args.dataset == "gqa" else 3)
    return pretrain({"train": train}, num_epochs=args.epochs,
                    batch_size=batch, lr=args.lr, save_dir=args.out_dir,
                    device=args.device)


if __name__ == "__main__":
    main()
