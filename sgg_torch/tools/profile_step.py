"""Step-time breakdown of the sgcls training path: trunk / RoIAlign / rects
/ union head / full forward / full train step.

    python -m sgg_torch.tools.profile_step [--batch 24 --nodes 40
        --edges 256 --img 592] [--iters 10] [-device cpu --tiny]

Counterpart of ``tools/profile_step.py``: the VGG16 relation model in
bf16 at the JAX bench's shape (``bench.py``: batch 24, 40 nodes, 256
edges, 592 px), seeded random weights, one synthetic batch on the card.
Each stage is counted (FLOPs, with the hand-written kernels' formula
counts, and K1/K2 launches) in one call, then timed by CUDA events and by
the host's clock (``utils/profiling.py``). The train step is timed in
place (it updates the model) after its warm-up calls, on the same batch.
The last line is the JSON object of ``StageProfiler.line``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sgg_torch.config import Config
from sgg_torch.device import resolve_device
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.ops.boxes import gather_boxes, union_boxes
from sgg_torch.ops.roi_align import roi_align
from sgg_torch.tools import _common
from sgg_torch.train.assign import sample_edges
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from sgg_torch.utils.profiling import StageProfiler

STAGES = ("trunk fwd", "K1 nodes", "K1 unions", "rects conv",
          "roi_fmap fc6/fc7", "full forward", "full train step")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _common.parser(__doc__, 24, 40, 256, 592).parse_args(argv)
    dev = resolve_device(args.device)
    batch = _common.synthetic_batch(args, dev)
    config = Config(batch_size=args.batch, max_nodes=args.nodes,
                    max_edges=args.edges, mode="sgcls", loss="dnorm",
                    compute_dtype="bfloat16", device=args.device)
    model = init_weights(RelModelIMP(
        _common.NUM_CLASSES, _common.NUM_PREDICATES, mode="sgcls",
        **_common.widths(args)), 0).to_compute_dtype(torch.bfloat16)
    model = model.to(dev).eval()
    gen = _common.generator(dev)
    sampled, pm = sample_edges(gen, batch.rels, batch.rel_mask,
                               batch.node_mask, max_out=args.edges)
    pairs = sampled[..., :2]
    prof = StageProfiler("profile_step", dev, iters=args.iters,
                         batch=args.batch)

    with torch.no_grad():
        fmap = prof.stage("trunk fwd", lambda: model.trunk(batch.images))
        prof.stage("K1 nodes", lambda: roi_align(
            fmap, batch.boxes, spatial_scale=1 / 16))
        ub = union_boxes(batch.boxes, pairs[..., 0],
                         pairs[..., 1]).contiguous()
        pool = prof.stage("K1 unions", lambda: roi_align(
            fmap, ub, spatial_scale=1 / 16))
        pair_boxes = torch.cat([gather_boxes(batch.boxes, pairs[..., 0]),
                                gather_boxes(batch.boxes, pairs[..., 1])],
                               -1)
        prof.stage("rects conv", lambda: model.union_feats(pair_boxes,
                                                           batch.im_hw))
        prof.stage("roi_fmap fc6/fc7", lambda: model.roi_fmap(pool))
        prof.stage("full forward", lambda: model(
            batch.images, batch.boxes, batch.classes, pairs, pm,
            im_hw=batch.im_hw))

    step = make_train_step(model, config, Optimizer(config, model))
    prof.stage("full train step", lambda: step(batch, gen))
    return prof.line(sizes=vars(args), dtype="bfloat16")


if __name__ == "__main__":
    main()
