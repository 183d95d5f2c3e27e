"""Offline per-class feature extraction for the GAN's feature bank.

    python -m sgg_torch.extract_features -m sgcls -save_dir <dir> \
        [-split stanford -data <dir>] [-feature_cache <dir>] [-device cpu]

Counterpart of the root ``extract_features.py`` (reference
``extract_features.py``): one pass over the train split through the
relation model in eval mode (``return_feats``), appending each valid GT
object's RoIAligned node features, one ``(p, p, C)`` row as float32, to
the dataset of its class in ``<save_dir>/features.hdf5``: the bank that
``-vis_cond`` reads (``augment/feature_bank.py``). With ``-feature_cache``
the pass reads the frozen trunk's cached maps instead of running the
trunk. The relation model is the one ``Trainer`` restores from
``-save_dir`` (seeded random weights where it holds no checkpoint). Runs
on the card unless ``-device cpu`` is given; ``h5py`` must be importable,
which is checked before any work starts.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from sgg_torch.device import resolve_device
from sgg_torch.train.assign import sample_edges


def make_pools_step(model, device="cuda"):
    """``pools_step(batch) -> node_pool`` (B, N, p, p, C) float32 on
    ``device``, without waiting for it: the eval-mode forward of
    ``model`` with ``return_feats`` on edges drawn from a generator seeded
    0 for every batch (the JAX pass's ``jax.random.key(0)``). The node
    pools do not depend on the edges."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)

    @torch.inference_mode()
    def pools_step(batch) -> torch.Tensor:
        batch = batch.to(dev)
        model.eval()
        generator.manual_seed(0)
        sampled, pm = sample_edges(generator, batch.rels, batch.rel_mask,
                                   batch.node_mask, max_out=batch.max_edges)
        out = model(batch.images, batch.boxes, batch.classes,
                    sampled[..., :2], pm, fmap=batch.fmaps,
                    im_hw=batch.im_hw, return_feats=True)
        return out["node_pool"].float()

    return pools_step


def batch_pools(trainer, n_batches: int = -1, batch_size: int = 8,
                num_workers: int = 4
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per batch of the train split, in order: (node pools (B, N, p, p, C)
    float32, classes (B, N), node mask (B, N)) on the host. The copy of
    the pools is the one wait on the device a batch."""
    from sgg_torch.data.pipeline import BatchLoader, to_image_dtype

    config, ds = trainer.config, trainer.train_data
    loader = BatchLoader(ds, batch_size=batch_size,
                         max_nodes=config.max_nodes,
                         max_edges=config.max_edges, shuffle=False,
                         drop_last=False, with_images=trainer.with_images,
                         num_workers=num_workers,
                         feature_cache=trainer._feature_cache_for(
                             "train", ds))
    step = make_pools_step(trainer.model, trainer.device)
    for b_i, batch in enumerate(loader):
        if n_batches > -1 and b_i >= n_batches:
            break
        batch = to_image_dtype(batch, config.compute_dtype)
        pools = step(batch).cpu().numpy()
        yield pools, np.asarray(batch.classes), np.asarray(batch.node_mask,
                                                           bool)


def extract_features(trainer, save_dir: str, n_batches: int = -1,
                     batch_size: int = 8, num_workers: int = 4) -> str:
    """The extraction with an assembled ``Trainer``; returns the hdf5
    path. A class's rows keep the order of its objects in the split."""
    from sgg_torch.augment.feature_bank import FeatureBankWriter
    from sgg_torch.main import require
    require("the feature bank", ("h5py",))
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "features.hdf5")
    names = trainer.train_data.ind_to_classes
    writer = None
    try:
        for pools, classes, mask in batch_pools(trainer, n_batches,
                                                batch_size, num_workers):
            if writer is None:
                writer = FeatureBankWriter(path, pools.shape[2:])
            for c in np.unique(classes[mask]):
                writer.append(names[c], pools[mask & (classes == c)])
    finally:
        if writer is not None:
            writer.close()
    return path


def main(argv: Optional[Sequence[str]] = None) -> str:
    from sgg_torch.config import config_from_args
    from sgg_torch.main import load_splits, require
    from sgg_torch.train.trainer import Trainer

    config = config_from_args(argv)
    if not config.save_dir:
        raise SystemExit("-save_dir is required")
    require("the feature bank", ("h5py",))
    # the relation model of a run in save_dir, if there is one
    trainer = Trainer(config, load_splits(config))
    path = extract_features(trainer, config.save_dir)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
