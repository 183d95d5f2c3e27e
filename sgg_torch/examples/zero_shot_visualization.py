"""Zero-shot scene-graph visualization: ground-truth against predicted
scene graphs of zero-shot test images, zero-shot edges in red (reference
``Zero_Shot_VG.ipynb``, ``lib/visualize.py`` semantics).

    python -m sgg_torch.examples.zero_shot_visualization [DATA_DIR]
        [OUT_DIR] [-device cpu]

Counterpart of ``examples/zero_shot_visualization.py``: a predcls model
(seeded random weights, narrow heads, f32) runs over the first images of
the ``test_zs`` split of VG (``DATA_DIR/VG/stanford_filtered``) or, with
no VG tree there, of a synthetic split, and ``utils/visualize.py::
show_nx`` draws ``OUT_DIR/gt_<i>.png`` and ``OUT_DIR/pred_<i>.png``
(the top 10 predicted relations). Drawing needs networkx and matplotlib
(VG's files need ``h5py``), which the card's machine lacks: the example
raises an ``ImportError`` naming them before any work on the card, and
runs on a host that has them, on its card or with ``-device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from sgg_torch import constants
from sgg_torch.main import require


def _synthetic_splits():
    from sgg_torch.data.datasets import SGGDataset
    from sgg_torch.data.synthetic import SyntheticSGGDataset

    def mk(seed, mode):
        syn = SyntheticSGGDataset(num_images=8, seed=seed)
        return SGGDataset(
            name="stanford", mode=mode, filenames=[], images_dir="",
            gt_boxes=syn.gt_boxes, gt_classes=syn.gt_classes,
            relationships=syn.relationships,
            ind_to_classes=syn.ind_to_classes,
            ind_to_predicates=syn.ind_to_predicates)

    return {"train": mk(0, "train"), "val_zs": mk(1, "val"),
            "val_alls": mk(2, "val"), "test_zs": mk(3, "test"),
            "test_alls": mk(4, "test")}


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_dir", nargs="?", default="./data")
    ap.add_argument("out_dir", nargs="?", default="./zs_viz")
    ap.add_argument("--n-images", type=int, default=3)
    ap.add_argument("-device", "--device", default="cuda")
    args = ap.parse_args(argv)
    vg_tree = os.path.exists(os.path.join(args.data_dir, "VG",
                                          "stanford_filtered"))
    require("the zero-shot visualization", ["networkx", "matplotlib"]
            + (["h5py"] if vg_tree else []))

    import matplotlib.pyplot as plt
    import torch

    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.device import resolve_device
    from sgg_torch.eval.sgg_eval import rank_predicted_rels
    from sgg_torch.eval.surgery import filter_dets
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.step import make_eval_step
    from sgg_torch.utils.visualize import show_nx

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    if vg_tree:
        from sgg_torch.data import visual_genome
        splits = visual_genome.splits(args.data_dir)
    else:
        print("no VG data found — using the synthetic dataset")
        splits = _synthetic_splits()

    model = init_weights(RelModelIMP(
        num_classes=splits["train"].num_classes,
        num_predicates=splits["train"].num_predicates, mode="predcls",
        hidden_dim=64, obj_dim=128), 0).to(dev).eval()
    eval_step = make_eval_step(model, mode="predcls", device=dev)
    ds = splits["test_zs"]
    loader = BatchLoader(ds, batch_size=1, max_nodes=24, max_edges=64,
                         with_images=False, shuffle=False,
                         im_scale=constants.IM_SCALE)
    train_counts = splits["train"].triplet_counts
    zs = set(ds.triplet_counts)
    written = []
    for i, batch in enumerate(loader):
        if i >= args.n_images:
            break
        out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
               for k, v in eval_step(batch).items()}
        n = int(np.asarray(batch.node_mask[0]).sum())
        entry = filter_dets(np.asarray(batch.boxes[0][:n]),
                            out["obj_scores"][0][:n],
                            out["obj_preds"][0][:n], out["pairs"][0],
                            out["rel_dists"][0], out["pair_mask"][0])
        ranked, _ = rank_predicted_rels(entry["pred_rel_inds"],
                                        entry["rel_scores"],
                                        entry["obj_scores"],
                                        multiple_preds=True)
        for name, classes, rels in (
                (f"gt_{i}", ds.gt_classes[i], ds.relationships[i]),
                (f"pred_{i}", np.asarray(entry["pred_classes"]),
                 ranked[:10])):
            show_nx(classes, rels, ds.ind_to_classes, ds.ind_to_predicates,
                    train_triplet_counts=train_counts,
                    zeroshot_triplets=zs,
                    name=os.path.join(args.out_dir, name))
            written.append(os.path.join(args.out_dir, f"{name}.png"))
        plt.close("all")
        print(f"wrote {args.out_dir}/gt_{i}.png and "
              f"{args.out_dir}/pred_{i}.png")
    return written


if __name__ == "__main__":
    main()
