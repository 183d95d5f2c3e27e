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

``Adam`` is the GAN's optimizer (``sgg_tpu/train/gan_step.py:58-73``,
reference ``pytorch_misc.py:98-127``): ``optax.adam(lr, b1, b2)`` over one
partition of the GAN's parameters, in optax's arithmetic.
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


class Adam:
    """``optax.adam(lr, b1=b1, b2=b2)`` (eps 1e-8, no ``eps_root``) over
    ``named`` (name, parameter) pairs, one partition of a model, as
    ``optax.multi_transform`` with ``set_to_zero`` on the rest gives it:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, then ``p +=
    -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)`` at update t
    (1-based), each term in optax's order and rounding (op by op; jitted,
    XLA fuses the second moment's update into an FMA). A parameter that
    took no gradient gets a zero one, as in optax. The moments are float32
    and the bias corrections are computed on the parameters' device, so an
    update waits for nothing."""

    def __init__(self, named, lr: float, b1: float, b2: float,
                 eps: float = 1e-8):
        self.named = list(named)
        self.params = [p for _, p in self.named]
        self.lr, self.b1, self.b2 = float(lr), float(b1), float(b2)
        self.eps = float(eps)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _bias_correction(self, decay: float, like: torch.Tensor):
        full = lambda v: torch.full((), v, dtype=torch.float32,  # noqa: E731
                                    device=like.device)
        return 1 - full(decay) ** full(float(self.count))

    @torch.no_grad()
    def apply_gradients(self) -> torch.Tensor:
        """One update from the parameters' ``grad``; returns their global
        norm (a device scalar)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        b1, b2 = self.b1, self.b2
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(self.mu, b1))
        self.nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(self.nu, b2))
        self.count += 1
        mu_hat = torch._foreach_div(
            self.mu, self._bias_correction(b1, self.params[0]))
        nu_hat = torch._foreach_div(
            self.nu, self._bias_correction(b2, self.params[0]))
        # the square root correctly rounded, as XLA's (PyTorch's vectorized
        # float32 sqrt on the CPU is not): through float64
        roots = [r.float() for r in torch._foreach_sqrt(
            [v.double() for v in nu_hat])]
        denom = torch._foreach_add(roots, self.eps)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom),
                                     -self.lr)
        torch._foreach_add_(self.params, updates)
        return norm

    def state_dict(self) -> Dict:
        """The update count and both moments by parameter name."""
        return {"count": torch.tensor(self.count),
                "mu": {n: m for (n, _), m in zip(self.named, self.mu)},
                "nu": {n: v for (n, _), v in zip(self.named, self.nu)}}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for i, (n, _) in enumerate(self.named):
            self.mu[i].copy_(state["mu"][n])
            self.nu[i].copy_(state["nu"][n])
