"""The system under test, built from a cell: the configuration as the
program's ``Config``, the generated split as its ``SGGDataset``, and the
``Trainer`` whose ``train_epoch`` the window drives, with the modules and
the benchmark's weights that the configuration's family
(``benchmarks/families``) builds.

The program is imported only here and in ``window.py``; nothing of it is
edited. ``SGG_IM_SCALE``, the program's own setting of the canvas side,
is set from the configuration before the program is first imported.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from benchmarks import families


def set_canvas(cfg: dict) -> None:
    os.environ["SGG_IM_SCALE"] = str(cfg["im_scale"])


def program_config(cfg: dict, keys, seed: int, device: str, data_dir: str):
    """The program's ``Config`` with the configuration's ``keys`` (a
    family's ``CONFIG_KEYS``; lists as tuples)."""
    from sgg_torch.config import Config
    kw = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
          for k in keys if k in cfg}
    return Config(seed=seed, device=device, data=data_dir, val_size=0,
                  notest=True, num_epochs=1, gitcommit="benchmark",
                  hostname="benchmark", **kw)


def dataset(split, image_dir: str, names, cfg: dict, mode: str = "train",
            entries=None):
    """The program's ``SGGDataset`` of ``split`` (of its ``entries``, in
    their order, where given): ``train`` shuffles and flips, ``test``
    neither."""
    from sgg_torch.data.datasets import SGGDataset
    from benchmarks.traffic import vocabulary
    classes, predicates = vocabulary(cfg["num_classes"],
                                     cfg["num_predicates"])
    idx = range(len(split)) if entries is None else entries
    return SGGDataset(name="stanford", mode=mode,
                      filenames=[names[split.entry_file[i]] for i in idx],
                      images_dir=image_dir,
                      gt_boxes=[split.gt_boxes[i] for i in idx],
                      gt_classes=[split.gt_classes[i] for i in idx],
                      relationships=[split.relationships[i] for i in idx],
                      ind_to_classes=classes, ind_to_predicates=predicates,
                      box_coordinates="native")


def load_weights(module: torch.nn.Module, weights: Dict[str, torch.Tensor]
                 ) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; the two sets
    of names and shapes must be the same."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"the program's parameters differ from the "
                       f"benchmark's: only the program's "
                       f"{sorted(set(params) - set(weights))[:5]}, only the "
                       f"benchmark's {sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: the program's shape "
                                 f"{tuple(p.shape)}, the benchmark's "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])


class Built:
    """The trainer, the name of its step attribute, and how to copy the
    optimizers' first moments and the trained parameters to the host:
    ``trainer.optimizer`` (SGD) and the ``adams`` the step also drives."""

    def __init__(self, trainer, attr: str, adams=()):
        self.trainer = trainer
        self.attr = attr
        self.named = list(trainer.optimizer.named)
        self.adams = list(adams)
        for a in self.adams:
            self.named += a.named

    def opt_state(self):
        """SGD's momentum by name; each Adam's first moment over 1 -
        beta1 (the gradient it got)."""
        sgd = self.trainer.optimizer
        out = {n: sgd.sgd.state[p]["momentum_buffer"].detach().to(
            "cpu", copy=True) for n, p in sgd.named}
        for a in self.adams:
            out.update({n: (m / (1.0 - a.b1)).to("cpu")
                        for (n, _), m in zip(a.named, a.mu)})
        return out

    def params(self):
        return {n: p.detach().to("cpu", copy=True) for n, p in self.named}


def build(cfg: dict, device, weight_seed: int, split, image_dir: str, names,
          cfg_seed: int, log=None, tests=None) -> Built:
    """The trainer of a cell with the benchmark's weights, built by the
    configuration's family (``benchmarks/families``). ``tests``: more
    splits by name (program ``SGGDataset``s) for ``Trainer.evaluate``."""
    from sgg_torch import constants
    if constants.IM_SCALE != cfg["im_scale"]:
        raise RuntimeError(f"the program's canvas is {constants.IM_SCALE} "
                           f"px, the configuration's {cfg['im_scale']}: "
                           f"SGG_IM_SCALE was read before it was set")
    return families.of(cfg).build(cfg, device, weight_seed, split, image_dir,
                                  names, cfg_seed, log=log, tests=tests)
