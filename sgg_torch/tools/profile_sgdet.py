"""Time of the SGDet eval path by stage: trunk / detector / relation head
on the pair budget / the full retry eval step.

    python -m sgg_torch.tools.profile_sgdet [--batch 8 --nodes 40
        --edges 256 --img 592] [--iters 10] [-device cpu --tiny]

Counterpart of ``tools/profile_sgdet.py`` through the port's
``make_sgdet_retry_eval_step`` (``models/sgdet.py``): ``FasterRCNNVGG``
(151 classes) and the SGDet ``RelModelIMP`` in bf16 with seeded random
weights on one synthetic batch. A random 151-way classifier scores every
class near 1/151, under every retry threshold: as ``chip_smoke.py`` does,
the classifier's weights are scaled by ``CLS_SCALE`` so that detections
reach the relation head (the tool prints so, and the detections an
image). The detector stages run at the retry ladder's lowest threshold,
as one retry pass does; the relation head on the compacted pair budget
(``SGDET_EVAL_MAX_PAIRS`` an image). The last line is the JSON object of
``StageProfiler.line``, with the trunk's and the detector's shares.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sgg_torch.device import resolve_device
from sgg_torch.models.detector import FasterRCNNVGG, init_detector_weights
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.models.sgdet import (SGDET_EVAL_MAX_PAIRS, THRESHOLDS,
                                    make_sgdet_retry_eval_step)
from sgg_torch.tools import _common
from sgg_torch.utils.profiling import StageProfiler

BF16 = torch.bfloat16
CLS_SCALE = 24.0  # chip_smoke.py's: 50 detections an image above 0.2
TINY_DETECTOR = {"obj_dim": 32, "rpn_pre_nms_top_n": 32,
                 "rpn_post_nms_top_n": 16, "detections_per_img": 8}
STAGES = ("trunk fwd", "detector full (trunk+RPN+NMS+head)",
          "detector sans trunk (fmap given)", "rel head (pair budget)",
          "full retry eval step")


def detector(args, dev) -> FasterRCNNVGG:
    """The seeded random detector in bf16, its classifier times
    ``CLS_SCALE``."""
    det = init_detector_weights(FasterRCNNVGG(
        _common.NUM_CLASSES, **(TINY_DETECTOR if args.tiny else {})), 0)
    with torch.no_grad():
        det.cls_score.weight.mul_(CLS_SCALE)
    return det.requires_grad_(False).to_compute_dtype(BF16).to(dev).eval()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _common.parser(__doc__, 8, 40, 256, 592).parse_args(argv)
    dev = resolve_device(args.device)
    batch = _common.synthetic_batch(args, dev)
    det = detector(args, dev)
    rel = init_weights(RelModelIMP(
        _common.NUM_CLASSES, _common.NUM_PREDICATES, mode="sgdet",
        **_common.widths(args)), 0).to_compute_dtype(BF16).to(dev).eval()
    step = make_sgdet_retry_eval_step(det, rel,
                                      max_pairs=SGDET_EVAL_MAX_PAIRS,
                                      device=args.device)
    thresh = min(THRESHOLDS)
    print(f"detections: the classifier's weights times {CLS_SCALE} "
          f"(chip_smoke.py's CLS_SCALE recipe); detector stages at score "
          f"threshold {thresh}", flush=True)
    prof = StageProfiler("profile_sgdet", dev, iters=args.iters,
                         batch=args.batch)
    with torch.inference_mode():
        fmap = prof.stage("trunk fwd", lambda: det.trunk(batch.images))
        prof.stage("detector full (trunk+RPN+NMS+head)", lambda: det(
            batch.images, batch.im_hw, score_thresh=thresh))
        prof.stage("detector sans trunk (fmap given)", lambda: det(
            None, batch.im_hw, fmap=fmap, score_thresh=thresh))
        found = step.detect(batch)
        flags = step.flags(found)
        rung = step.rungs[-1] if step.rungs else None
        n_det = found["det_mask"].sum(1).tolist()
        print(f"detections an image {n_det}; candidate pairs (max an "
              f"image) {flags['pair_count']}; relation head on "
              f"{rung or 'all'} pairs an image", flush=True)
        prof.stage("rel head (pair budget)", lambda: step.relate(found, rung))
        prof.stage("full retry eval step", lambda: step(batch))
    st = prof.stages
    key = "card_ms" if st["trunk fwd"]["card_ms"] is not None else "wall_ms"
    full = st["full retry eval step"][key]
    shares = {"trunk": st["trunk fwd"][key] / full,
              "detector": st["detector full (trunk+RPN+NMS+head)"][key]
              / full}
    print(f"trunk share of full step ({key}): {100 * shares['trunk']:.0f}%  "
          f"detector share: {100 * shares['detector']:.0f}%", flush=True)
    return prof.line(sizes=vars(args), dtype="bfloat16", shares=shares,
                     shares_of=key, detections=n_det,
                     pair_count=flags["pair_count"], pair_budget=rung,
                     cls_scale=CLS_SCALE)


if __name__ == "__main__":
    main()
