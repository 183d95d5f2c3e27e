"""Generated-feature quality: FID and precision/recall/density/coverage
of the GAN's fake node features against real ones (reference
``GAN_features.ipynb``).

    python -m sgg_torch.examples.gan_feature_quality [-device cpu]

Counterpart of ``examples/gan_feature_quality.py``: a narrow relation
model pools real node features (K1 over the VGG16 trunk's map) from four
synthetic 128 px images; an untrained, narrow GAN paints fake maps of the
same graphs, pooled by K1 at the same boxes; ``augment/gan_eval.py``
compares the two banks (the distances on the device). Runs on the card
unless given ``-device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sgg_torch.augment.gan_eval import compute_fid, compute_prdc
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.device import resolve_device
from sgg_torch.models.gan.gan import GANModel, init_gan_weights
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.ops.boxes import scale_boxes_01
from sgg_torch.ops.roi_align import roi_align
from sgg_torch.train.assign import sample_edges


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-device", "--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, N, E, IMG = 4, 8, 16, 128
    ds = SyntheticSGGDataset(num_images=B, num_classes=12, num_predicates=6,
                             max_objects=6, image_size=IMG,
                             with_images=True, seed=0)
    gb = ds.batch(list(range(B)), max_nodes=N, max_edges=E).to(dev)

    model = init_weights(RelModelIMP(num_classes=12, num_predicates=6,
                                     mode="sgcls", hidden_dim=16,
                                     obj_dim=32), 0).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    sampled, pm = sample_edges(gen, gb.rels, gb.rel_mask, gb.node_mask,
                               max_out=E)
    gan = init_gan_weights(GANModel(num_classes=12, num_predicates=6,
                                    hidden_dim=8, n_ch=512,
                                    fmap_sz=IMG // 16, n_layers_G=2),
                           1).to(dev).eval()
    with torch.no_grad():
        out = model(gb.images, gb.boxes, gb.classes, sampled[..., :2], pm,
                    return_feats=True)
        real = out["node_pool"].float().cpu().numpy()
        fmaps = gan.generate(gb.classes, scale_boxes_01(gb.boxes, gb.im_hw),
                             gb.rels, gb.node_mask, gb.rel_mask)
        fake = roi_align(fmaps, gb.boxes.float().contiguous(),
                         spatial_scale=1 / 16.0).float().cpu().numpy()
    mask = gb.node_mask.cpu().numpy()

    real_flat = real[mask].reshape(mask.sum(), -1)
    fake_flat = fake[mask].reshape(mask.sum(), -1)
    # the feature axis truncated for a stable covariance of few samples
    d = min(16, real_flat.shape[1])
    fid = compute_fid(fake_flat, real_flat, truncate=d)
    prdc = compute_prdc(real_flat[:, :d], fake_flat[:, :d],
                        nearest_k=min(3, len(real_flat) - 1), device=dev)
    print(f"FID (untrained G, {d}-d): {fid:.2f}")
    for k, v in prdc.items():
        print(f"{k}: {v:.3f}")
    return {"fid": fid, **prdc}


if __name__ == "__main__":
    main()
