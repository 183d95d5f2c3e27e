"""Frozen-trunk feature-cache walkthrough: extract the trunk's maps once,
then train from them.

    python -m sgg_torch.examples.feature_cache_training [-device cpu]

Counterpart of ``examples/feature_cache_training.py`` with the port's
``data/feature_cache.py``. In predcls/sgcls (and sgdet, and under
``-gan``) the detector trunk is frozen, yet the reference recomputes the
whole VGG16 forward on every image of every epoch. The cache runs the
trunk once per image and flip orientation and stores its maps exactly
(bf16 bits, with the trunk weights' fingerprint); training then reads
them and the trunk never runs again. Self-contained on a small synthetic
split (96 px canvases, a narrow model); in the CLI this is ``-feature_cache
DIR``. The cache is an HDF5 file: without ``h5py`` (the card's machine)
the example raises an ``ImportError`` naming it before any work on the
card.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-device", "--device", default="cuda")
    args = ap.parse_args(argv)
    from sgg_torch.main import require
    require("the feature cache", ["h5py"])

    import torch

    from sgg_torch.config import Config
    from sgg_torch.data.datasets import SGGDataset
    from sgg_torch.data.feature_cache import (extract_trunk_cache,
                                              split_cache_path)
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.data.synthetic import SyntheticSGGDataset
    from sgg_torch.device import resolve_device
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.state import Optimizer
    from sgg_torch.train.step import make_train_step

    dev = resolve_device(args.device)
    IM = 96  # small canvases so the demo runs anywhere; real runs use 592
    syn = SyntheticSGGDataset(num_images=8, num_classes=9, num_predicates=5,
                              max_objects=5, image_size=IM, seed=0)
    ds = SGGDataset(name="stanford", mode="train", filenames=[],
                    images_dir="", gt_boxes=syn.gt_boxes,
                    gt_classes=syn.gt_classes,
                    relationships=syn.relationships,
                    ind_to_classes=syn.ind_to_classes,
                    ind_to_predicates=syn.ind_to_predicates,
                    box_coordinates="native")
    config = Config(batch_size=4, max_nodes=8, max_edges=12, mode="sgcls",
                    loss="dnorm", compute_dtype="bfloat16", device=dev.type)
    model = init_weights(RelModelIMP(num_classes=9, num_predicates=5,
                                     mode="sgcls", hidden_dim=16,
                                     obj_dim=32), 0)
    model = model.to_compute_dtype(torch.bfloat16).to(dev)

    @torch.inference_mode()
    def trunk_fn(canvases):
        return model.trunk(torch.from_numpy(canvases).to(dev))

    losses = []
    with tempfile.TemporaryDirectory() as d:
        # 1) extract the cache: one trunk pass per image and orientation
        path = split_cache_path(d, "train")
        t0 = time.time()
        cache = extract_trunk_cache(path, ds, trunk_fn, batch_size=4,
                                    im_scale=IM, with_images=False,
                                    progress=False)
        print(f"extracted {cache.num_images} images x {cache.n_orient} "
              f"orientations -> {path} in {time.time() - t0:.1f}s "
              f"(fmap {cache.fmap_hw}, {cache.channels}ch)")

        # 2) train from the cache: batches carry maps, the trunk never
        # runs again
        loader = BatchLoader(ds, batch_size=4, max_nodes=8, max_edges=12,
                             im_scale=IM, feature_cache=cache, seed=1)
        step = make_train_step(model, config, Optimizer(config, model))
        gen = torch.Generator(device=dev).manual_seed(0)
        for epoch in range(2):
            loader._epoch = epoch
            for batch in loader:
                if batch.images is not None or batch.fmaps is None:
                    raise RuntimeError("the cached loader gave images")
                metrics = step(batch, gen)
            losses.append(float(metrics["total"]))
            print(f"epoch {epoch}: loss={losses[-1]:.4f} "
                  f"(from cached fmaps {tuple(batch.fmaps.shape)})")
        if not np.isfinite(losses).all():
            raise FloatingPointError(f"non-finite losses {losses}")
        cache.close()
    print("done — in the CLI this is just `-feature_cache DIR`")
    return losses


if __name__ == "__main__":
    main()
