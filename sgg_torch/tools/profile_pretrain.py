"""Time of the VGG16 detector-pretraining step by stage.

    python -m sgg_torch.tools.profile_pretrain [--batch 8 --nodes 40
        --img 592] [--iters 10] [-device cpu --tiny]

Counterpart of ``tools/profile_pretrain.py`` through the port's
``sgg_torch.pretrain_detector``: ``FasterRCNNVGG`` (151 classes) in bf16
over f32 master weights, seeded random weights (``init_detector_weights``),
one synthetic batch. Stages: the trunk's forward (K2); the detector's
forward (trunk, RPN, NMS, box head: K2 and K1); the RPN's and the box
head's losses on that forward's outputs (assignment, balanced sampling,
cross entropy, smooth L1); the training forward with its losses, without
and with the backward (K1-bwd-fmap, K1-bwd-boxes and K2-bwd: the step
differentiates through its proposals and trains conv1_1); and the whole
step (``make_detector_train_step``: SGD with momentum and weight decay,
``DetectorOptimizer``), timed in place after its warm-up. The shares line
splits the step into trunk, forward, losses, backward and update. The
last line is the JSON object of ``StageProfiler.line``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sgg_torch.device import resolve_device
from sgg_torch.models.detector import (FasterRCNNVGG, balanced_draws,
                                       init_detector_weights,
                                       roi_head_losses, rpn_losses)
from sgg_torch.pretrain_detector import (LR, DetectorOptimizer,
                                         detector_losses,
                                         detector_lr_schedule,
                                         make_detector_train_step)
from sgg_torch.tools import _common
from sgg_torch.tools.profile_sgdet import TINY_DETECTOR
from sgg_torch.utils.profiling import StageProfiler

STAGES = ("trunk fwd", "detector fwd (trunk+RPN+NMS+head)",
          "rpn_losses (assign+sample+CE+L1)",
          "roi_head_losses (assign+sample+CE+L1)", "fwd + losses (no grad)",
          "fwd + bwd (grad)", "FULL pretrain step")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _common.parser(__doc__, 8, 40, 1, 592).parse_args(argv)
    dev = resolve_device(args.device)
    batch = _common.synthetic_batch(args, dev)
    det = FasterRCNNVGG(_common.NUM_CLASSES,
                        **(TINY_DETECTOR if args.tiny else {}))
    det = init_detector_weights(det.to_compute_dtype(torch.bfloat16), 0)
    det = det.to(dev).eval()
    gen = _common.generator(dev)
    prof = StageProfiler("profile_pretrain", dev, iters=args.iters,
                         batch=args.batch)
    with torch.no_grad():
        prof.stage("trunk fwd", lambda: det.trunk(batch.images))
        out = prof.stage("detector fwd (trunk+RPN+NMS+head)",
                         lambda: det(batch.images, batch.im_hw))
        rpn_draws = balanced_draws(gen, out["rpn_obj_logits"].shape, dev)
        roi_draws = balanced_draws(gen, out["prop_mask"].shape, dev)
        prof.stage("rpn_losses (assign+sample+CE+L1)", lambda: rpn_losses(
            rpn_draws, out["anchors"], out["rpn_obj_logits"],
            out["rpn_deltas"], batch.boxes, batch.node_mask))
        prof.stage("roi_head_losses (assign+sample+CE+L1)",
                   lambda: roi_head_losses(
                       roi_draws, out["proposals"], out["prop_mask"],
                       out["class_logits"], out["box_deltas"], batch.boxes,
                       batch.classes, batch.node_mask))
        del out
        prof.stage("fwd + losses (no grad)", lambda: sum(
            detector_losses(det, batch, gen)[0].values()))

    def grad():
        det.zero_grad(set_to_none=True)
        total = sum(detector_losses(det, batch, gen)[0].values())
        total.backward()
        return total.detach()

    prof.stage("fwd + bwd (grad)", grad)
    det.zero_grad(set_to_none=True)
    opt = DetectorOptimizer(det, detector_lr_schedule(LR, 1, 1))
    step = make_detector_train_step(det, opt)
    prof.stage("FULL pretrain step", lambda: step(batch, gen))
    st = prof.stages
    key = "card_ms" if st["trunk fwd"]["card_ms"] is not None else "wall_ms"
    t = {k: v[key] for k, v in st.items()}
    full = t["FULL pretrain step"]
    shares = {
        "trunk-fwd": t["trunk fwd"] / full,
        "det-fwd": t["detector fwd (trunk+RPN+NMS+head)"] / full,
        "losses": (t["fwd + losses (no grad)"]
                   - t["detector fwd (trunk+RPN+NMS+head)"]) / full,
        "bwd": (t["fwd + bwd (grad)"] - t["fwd + losses (no grad)"]) / full,
        "update+rest": (full - t["fwd + bwd (grad)"]) / full}
    print(f"shares ({key}): " + "  ".join(
        f"{k} {100 * v:.0f}%" for k, v in shares.items()), flush=True)
    return prof.line(sizes=vars(args), dtype="bfloat16", shares=shares,
                     shares_of=key)


if __name__ == "__main__":
    main()
