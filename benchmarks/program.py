"""The system under test, built from a cell: the configuration as the
program's ``Config``, the generated split as its ``SGGDataset``, the
relation model (and with ``gan`` the GAN) with the benchmark's weights,
and the ``Trainer`` whose ``train_epoch`` the window drives.

The program is imported only here and in ``window.py``; nothing of it is
edited. ``SGG_IM_SCALE``, the program's own setting of the canvas side,
is set from the configuration before the program is first imported.
"""

from __future__ import annotations

import os
from typing import Dict

import torch


CONFIG_KEYS = ("mode", "loss", "batch_size", "max_nodes", "max_edges",
               "rels_per_img", "num_workers", "print_interval",
               "image_format", "compute_dtype", "lr", "l2", "clip", "alpha",
               "beta", "gamma", "use_bias", "edge_model", "backbone", "gan",
               "ganlosses", "lrG", "lrD", "ganw", "largeD", "beta1", "beta2",
               "perturb", "L", "topk", "graphn_a", "init_embed", "attachG")


def set_canvas(cfg: dict) -> None:
    os.environ["SGG_IM_SCALE"] = str(cfg["im_scale"])


def program_config(cfg: dict, seed: int, device: str, data_dir: str):
    from sgg_torch.config import Config
    kw = {k: cfg[k] for k in CONFIG_KEYS if k in cfg}
    if "ganlosses" in kw:
        kw["ganlosses"] = tuple(kw["ganlosses"])
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


def relation_model(cfg: dict, device, weights):
    """The program's relation model on ``device``, in the configuration's
    compute type, holding ``weights``."""
    from sgg_torch.models.relhead import RelModelIMP
    dt = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" \
        else torch.float32
    with torch.device(device):
        model = RelModelIMP(
            num_classes=cfg["num_classes"],
            num_predicates=cfg["num_predicates"], mode=cfg["mode"],
            use_bias=cfg["use_bias"], backbone=cfg["backbone"],
            edge_model=cfg["edge_model"], obj_dim=cfg["obj_dim"],
            hidden_dim=cfg["hidden_dim"], mp_iter=cfg["mp_iter"])
    model = model.to_compute_dtype(dt).to(device).eval()
    load_weights(model, weights)
    return model


def gan_model(cfg: dict, device, weights, sn):
    """The program's GAN on ``device`` holding ``weights`` and the spectral
    norms' starting vectors ``sn``."""
    from sgg_torch.models.gan import GANModel
    with torch.device(device):
        gan = GANModel(num_classes=cfg["num_classes"],
                       num_predicates=cfg["num_predicates"],
                       fmap_sz=cfg["im_scale"] // 16, largeD=cfg["largeD"])
    gan = gan.to(device)
    load_weights(gan, weights)
    buffers = dict(gan.named_buffers())
    with torch.no_grad():
        for name, u in sn.items():
            buffers[name].copy_(u)
    return gan


class Built:
    """The trainer, the name of its step attribute, and how to copy the
    optimizers' first moments and the trained parameters to the host."""

    def __init__(self, trainer, gan: bool):
        self.trainer = trainer
        self.attr = "gan_step" if gan else "train_step"
        opt = trainer.optimizer
        self.named = list(opt.named)
        self.adams = [trainer.g_opt, trainer.d_opt] if gan else []
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
    """The trainer of a cell with the benchmark's weights: the relation
    model's from ``weight_seed``, the GAN's from the next two seeds (the
    reference draws the same). ``tests``: more splits by name (program
    ``SGGDataset``s) for ``Trainer.evaluate``."""
    from sgg_torch import constants
    from sgg_torch.train.trainer import Trainer
    from benchmarks.reference import gan as ref_gan
    if constants.IM_SCALE != cfg["im_scale"]:
        raise RuntimeError(f"the program's canvas is {constants.IM_SCALE} "
                           f"px, the configuration's {cfg['im_scale']}: "
                           f"SGG_IM_SCALE was read before it was set")
    from benchmarks.reference import model as ref_model
    weights = ref_model.make_weights(ref_model.param_spec(cfg), weight_seed,
                                     device, ref_model.stored_types(cfg))
    model = relation_model(cfg, device, weights)
    del weights
    gan = None
    if cfg.get("gan"):
        gan = gan_model(cfg, device,
                        ref_gan.make(ref_gan.param_spec(cfg),
                                     weight_seed + 1, device),
                        ref_gan.make(ref_gan.sn_spec(cfg), weight_seed + 2,
                                     device))
    config = program_config(cfg, cfg_seed, torch.device(device).type,
                            image_dir)
    ds = dataset(split, image_dir, names, cfg)
    if log is not None:
        log("weights made, dataset built")
    trainer = Trainer(config, {"train": ds, **(tests or {})}, model=model,
                      gan=gan)
    return Built(trainer, gan is not None)
