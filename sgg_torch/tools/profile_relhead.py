"""Time inside the relation head at the SGDet eval shapes: node and union
RoIAlign, the rects branch, the edge and node RoI heads, IMP.

    python -m sgg_torch.tools.profile_relhead [--batch 8 --nodes 50
        --edges 1024 --img 592] [--iters 20] [-device cpu --tiny]

Counterpart of ``tools/profile_relhead.py``: the ~pair-budget slice of an
SGDet eval step split into K1 on the nodes and on the unions (all 1024
and the deduplicated half), ``UnionBoxFeats`` (the rects conv branch),
the edge ``RoiHead`` (fc6/fc7 on 25088-d unions), the node ``RoiHead``
and ``IMPHead`` (3 message-passing rounds), and the sum of the parts.
Random bf16 inputs from a seeded ``RandomState`` on a ``img // 16`` map;
seeded random weights. The last line is the JSON object of
``StageProfiler.line`` (``sum of parts`` in its ``sum_of_parts``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sgg_torch.constants import POOL_SIZE
from sgg_torch.device import resolve_device
from sgg_torch.models.backbone import RoiHead
from sgg_torch.models.relhead import IMPHead, init_weights
from sgg_torch.models.resnet import set_compute_dtype
from sgg_torch.models.union_features import UnionBoxFeats
from sgg_torch.ops.boxes import gather_boxes, union_boxes
from sgg_torch.ops.roi_align import roi_align
from sgg_torch.tools import _common
from sgg_torch.utils.profiling import StageProfiler

BF16 = torch.bfloat16
C = 512  # the VGG16 map's channels
STAGES = ("K1 nodes", "K1 unions", "K1 unions (dedup'd half)",
          "rects conv branch", "edge RoiHead fc6/fc7", "node RoiHead fc6/fc7",
          "IMP head (3 iters)")
# the parts whose sum ``sum of parts`` is (the JAX tool's)
PARTS = ("K1 nodes", "K1 unions", "rects conv branch", "edge RoiHead fc6/fc7",
         "node RoiHead fc6/fc7", "IMP head (3 iters)")


def _module(mod: torch.nn.Module, dev) -> torch.nn.Module:
    init_weights(mod, 0)
    set_compute_dtype(mod, BF16, store=False)
    return mod.to(dev).eval()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _common.parser(__doc__, 8, 50, 1024, 592,
                          iters=20).parse_args(argv)
    dev = resolve_device(args.device)
    B, N, E, HW = args.batch, args.nodes, args.edges, args.img // 16
    obj_dim = _common.widths(args)["obj_dim"]
    hidden = _common.widths(args)["hidden_dim"]
    rng = np.random.RandomState(0)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    fmap = t(rng.rand(B, HW, HW, C), BF16)
    boxes = t(np.sort(rng.rand(B, N, 2, 2) * (args.img - 32), axis=2)
              .reshape(B, N, 4)[..., [0, 2, 1, 3]], torch.float32)
    pairs = t(rng.randint(0, N, (B, E, 2)), torch.long)
    pm = torch.ones((B, E), dtype=torch.bool, device=dev)
    prof = StageProfiler("profile_relhead", dev, iters=args.iters, batch=B)
    in_dim = POOL_SIZE * POOL_SIZE * C
    with torch.no_grad():
        prof.stage("K1 nodes", lambda: roi_align(
            fmap, boxes, spatial_scale=1 / 16, pooled=POOL_SIZE))
        ub = union_boxes(boxes, pairs[..., 0], pairs[..., 1]).contiguous()
        prof.stage("K1 unions", lambda: roi_align(
            fmap, ub, spatial_scale=1 / 16, pooled=POOL_SIZE))
        half = ub[:, :E // 2].contiguous()
        prof.stage("K1 unions (dedup'd half)", lambda: roi_align(
            fmap, half, spatial_scale=1 / 16, pooled=POOL_SIZE))
        uf = _module(UnionBoxFeats(dim=C, pooling_size=POOL_SIZE), dev)
        pb = torch.cat([gather_boxes(boxes, pairs[..., 0]),
                        gather_boxes(boxes, pairs[..., 1])], -1)
        prof.stage("rects conv branch", lambda: uf(pb))
        upool = t(rng.rand(B, E, POOL_SIZE, POOL_SIZE, C), BF16)
        eh = _module(RoiHead(in_dim, obj_dim, with_final_relu=False), dev)
        prof.stage("edge RoiHead fc6/fc7", lambda: eh(upool))
        del upool
        npool = t(rng.rand(B, N, POOL_SIZE, POOL_SIZE, C), BF16)
        nh = _module(RoiHead(in_dim, obj_dim, with_final_relu=True), dev)
        prof.stage("node RoiHead fc6/fc7", lambda: nh(npool))
        imp = _module(IMPHead(obj_dim, _common.NUM_CLASSES,
                              _common.NUM_PREDICATES, hidden_dim=hidden), dev)
        nf = t(rng.rand(B, N, obj_dim), BF16)
        ef = t(rng.rand(B, E, obj_dim), BF16)
        prof.stage("IMP head (3 iters)", lambda: imp(nf, ef, pairs, pm))
    total = {k: sum(prof.stages[p][k] for p in PARTS)
             if prof.stages[PARTS[0]][k] is not None else None
             for k in ("card_ms", "wall_ms", "flops")}
    card = ("not measured" if total["card_ms"] is None
            else f"{total['card_ms']:9.3f} ms")
    print(f"{'sum of parts':44s} card {card}  wall "
          f"{total['wall_ms']:9.3f} ms", flush=True)
    return prof.line(sizes=vars(args), dtype="bfloat16", sum_of_parts=total)


if __name__ == "__main__":
    main()
