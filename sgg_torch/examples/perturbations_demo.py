"""Scene-graph perturbation demo: before/after triplets for the three
perturbation strategies (reference ``Scene_Graph_Perturbations_VG
.ipynb``).

    python -m sgg_torch.examples.perturbations_demo

Counterpart of ``examples/perturbations_demo.py`` with the port's
``augment/perturb.py``: the same synthetic split and seeds print the same
triplets. The perturbations run on the host (numpy): no device is used.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from sgg_torch.augment.perturb import SceneGraphPerturb
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.data.word_vectors import normalized_class_embeddings


def main(argv: Optional[Sequence[str]] = None) -> None:
    syn = SyntheticSGGDataset(num_images=12, num_classes=20,
                              num_predicates=8, max_objects=6, seed=0)
    ds = SGGDataset(name="stanford", mode="train", filenames=[],
                    images_dir="", gt_boxes=syn.gt_boxes,
                    gt_classes=syn.gt_classes,
                    relationships=syn.relationships,
                    ind_to_classes=syn.ind_to_classes,
                    ind_to_predicates=syn.ind_to_predicates)
    emb = normalized_class_embeddings(ds.ind_to_classes)

    img = 0
    classes = ds.gt_classes[img][None].copy()
    rels = ds.relationships[img][None]
    nm = np.ones_like(classes, bool)
    rm = np.ones((1, rels.shape[1]), bool)

    def show(title, new_classes):
        print(f"\n=== {title} ===")
        for s, o, p in rels[0]:
            before = (ds.ind_to_classes[classes[0][s]],
                      ds.ind_to_predicates[p],
                      ds.ind_to_classes[classes[0][o]])
            after = (ds.ind_to_classes[new_classes[0][s]],
                     ds.ind_to_predicates[p],
                     ds.ind_to_classes[new_classes[0][o]])
            marker = "  ->  " + "_".join(after) if after != before else ""
            print("_".join(before) + marker)

    for method in ("rand", "neigh", "graphn"):
        sgp = SceneGraphPerturb(method, emb, ds.subj_pred_pairs,
                                ds.pred_obj_pairs, L=0.5, topk=5, alpha=1,
                                seed=42)
        new = sgp.perturb_batch(classes.copy(), rels, nm, rm)
        show(method, new)


if __name__ == "__main__":
    main()
