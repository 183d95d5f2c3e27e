"""Optimizer: SGD with momentum, coupled L2, a 1/10-LR group, a frozen
trunk, global-norm clipping and a MultiStepLR schedule.

Counterpart of ``sgg_tpu/train/state.py:48-100`` (reference
``lib/pytorch_misc.py:130-157`` + ``main.py:118,238``):

* effective learning rate ``lr * batch_size``;
* parameter groups by name: ``frozen`` (the trunk: no update, no decay,
  no state), ``fc`` (every parameter whose name starts with ``roi_fmap``:
  1/10 LR), ``main`` (the rest, biases and BatchNorm affines included);
* per update: clip the gradients to global norm ``clip`` with optax's
  formula (``(g / norm) * clip`` when ``norm >= clip``, no epsilon; torch's
  ``clip_grad_norm_`` adds 1e-6), then ``torch.optim.SGD`` with momentum
  0.9 and ``weight_decay = l2`` (``g + l2 * p``, then the momentum trace,
  then ``p - lr * trace``: optax's ``add_decayed_weights`` + ``sgd``);
* the learning rate of update ``k`` (0-based) is ``multistep_lr(k)``, with
  boundaries at ``(s + 1) * steps_per_epoch`` optimizer updates, as
  ``optax.piecewise_constant_schedule``.

Parameters and momentum buffers are float32 (the model's master weights).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn as nn

from sgg_torch.config import Config

LR_SCALES = {"main": 1.0, "fc": 0.1}


def param_label(name: str) -> str:
    """``frozen``, ``fc`` or ``main`` for a parameter name."""
    parts = name.split(".")
    if any("trunk" in p for p in parts):
        return "frozen"
    if any(p.startswith("roi_fmap") for p in parts):
        return "fc"  # 1/10th LR (pytorch_misc.py:133-140)
    return "main"


def multistep_lr(base_lr: float, steps: Sequence[int], decay: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR over epochs (milestones ``steps + 1``,
    pytorch_misc.py:151-153) as a function of the update count."""
    bounds = sorted((s + 1) * steps_per_epoch for s in steps)

    def schedule(count: int) -> float:
        return base_lr * decay ** sum(count >= b for b in bounds)

    return schedule


class Optimizer:
    """The train state's optimizer half: ``apply_gradients`` after
    ``backward``; ``count`` is the number of updates applied."""

    def __init__(self, config: Config, model: nn.Module,
                 steps_per_epoch: int = 1):
        self.clip = config.clip
        eff_lr = config.lr * config.batch_size  # main.py:238
        groups: Dict[str, list] = {"main": [], "fc": []}
        for name, p in model.named_parameters():
            label = param_label(name)
            if label == "frozen":
                continue
            if p.dtype != torch.float32:
                raise TypeError(f"{name}: master weights must be float32, "
                                f"not {p.dtype}")
            groups[label].append((name, p))
        self.schedules = {
            label: multistep_lr(eff_lr * LR_SCALES[label], config.steps,
                                config.lr_decay, steps_per_epoch)
            for label in groups}
        self.named = [item for label in groups for item in groups[label]]
        self.params = [p for _, p in self.named]
        self.sgd = torch.optim.SGD(
            [{"params": [p for _, p in groups[label]], "label": label}
             for label in groups if groups[label]],
            lr=eff_lr, momentum=0.9, weight_decay=config.l2)
        # optax's trace starts at zero; a zero buffer makes SGD's first
        # step the same (0.9 * 0 + g) and gives checkpoints a fixed layout
        for p in self.params:
            self.sgd.state[p]["momentum_buffer"] = torch.zeros_like(p)
        self.count = 0

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    @torch.no_grad()
    def apply_gradients(self) -> torch.Tensor:
        """Clip, decay, momentum, step; returns the global gradient norm
        before clipping (a device scalar). A trainable parameter that took
        no gradient gets a zero one, so it still decays, as under optax."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep = norm < self.clip
        denom = torch.where(keep, 1.0, norm)
        mult = torch.where(keep, 1.0, torch.full_like(norm, self.clip))
        for g in grads:
            g.div_(denom).mul_(mult)
        for group in self.sgd.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.sgd.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Momentum buffers by parameter name."""
        return {name: self.sgd.state[p]["momentum_buffer"]
                for name, p in self.named}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for name, p in self.named:
            self.sgd.state[p]["momentum_buffer"].copy_(state[name])
