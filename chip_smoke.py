#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sgg_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, no network and no
JAX. Phases, one or more lines each; any failure ends the run with a
non-zero exit and without the result line:

1. card facts: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the six CUDA kernels from the five sources in
   ``sgg_torch/csrc`` (one ``nvcc`` a source, in parallel);
3. each kernel against its plain PyTorch version at the training path's
   shapes (batch 24: nodes R=40, unions R=256) and at the eval path's
   (batch 16: R=64 and 256), in f32 (TF32 off, tolerance 1e-5 abs) and in
   bf16 (within 2e-2 of the f32 plain result, relative to its largest
   magnitude), with timings (CUDA events, mean over 20 launches after
   warm-up) and the card's bound; then every other route of the kernels
   at small shapes, same tolerances (K1 at channel counts and alignments
   that take its narrower vector widths and with a whole-map ROI; K2 in
   both types at a ragged size), and K1's plain version on the card
   against the same call on the CPU (f32, 1e-6 abs); then the frozen
   trunk's conv epilogue at the outputs of the twelve cuDNN convs at the
   training shape (batch 24, 592 px), bf16 and f32, the same bits as its
   plain version, with ms a conv of the kernel, the plain version and
   PyTorch's ``add_`` + ``relu`` + ``max_pool2d`` chain and the byte bound,
   each timed over copies of the map that outgrow the L2;
4. the eval slice at full width: ``val_epoch`` in mode sgcls (predcls +
   sgcls regimes) over a 64-image synthetic split with the VG-Stanford
   vocabulary, VGG16 on 592x592 canvases in bf16, seeded random weights;
   the kernels' launch counters are zeroed just before and read just
   after, and must match the batches run, all on the bf16 routes;
5. the training slice at full width (``main.py -m sgcls -loss dnorm -b
   24``: max_nodes 40, max_edges 256, bf16 compute over f32 master
   weights, dropout on, uint8 canvases normalized on the card) on a
   96-image synthetic train split: a warm-up
   epoch, then one counted and timed ``Trainer.train_epoch`` (2 K1 + 1 K2
   launches a step, bf16 routes, finite losses, train images/s with the
   host), one step under ``set_sync_debug_mode("error")`` (no host sync),
   a one-batch overfit of 10 steps (the loss falls; one step's ms),
   the trunk bit-unchanged and every head parameter and BN statistic
   moved, where a step's time goes (host assembly and copy of uint8 and
   float32 canvases, steps on batches copied on the step's stream
   against ``device_prefetch``'s own copy stream, timed in turns, trunk,
   optimizer, the profiler's kernels), and a
   checkpoint round trip (the next step's
   losses from the saved and the restored state within 1e-6 relative,
   grad_norm within 1e-3: the backward adds into bf16 with atomics);
6. card (kernels) against CPU (plain versions), same weights, f32, under
   its own deadline: one full-width eval step of 2 images (1e-3 abs) and
   one full-width train step of 2 images on the same sampled edges with
   dropout off (losses and grad_norm within 1e-4 relative; the update, as
   the momentum buffers hold it, within 1e-3 relative in norm; updated
   parameters and BN statistics within 1e-6 abs);
7. SGDet at full width under its own deadline (VG-Stanford vocabulary,
   ``FasterRCNNVGG`` defaults, seeded random weights with the classifier's
   weights scaled by ``CLS_SCALE`` so that detections clear the score
   thresholds): ``python -m sgg_torch.main -m sgdet -nepoch 0 -ckpt <dir>
   -split synthetic -val_size 32`` in-process from a detector written to a
   temporary directory (images/s, cap counters, detections an image, the
   selected thresholds, recalls, ``DetectionEvaluator``'s AP over the
   detections; at least half the images reach the
   evaluator, one fills all 50 slots; K1 three launches a batch pass and
   K2 one, bf16 routes only); one eval pass of 8 images split by stage
   (CUDA events) with its peak memory; K1 at the detector's shape (8 x 512
   proposals), per eval and train step, and K2 at batch 8 and 6, against
   the plain versions; the detect and relate stages and a train step under
   ``set_sync_debug_mode("error")``; each escalation of the retry wrapper
   forced once (candidate cap, rounds budget, pair budget), each equal to
   the exact run (sequential NMS, a covering cap, dense pairs); card
   against CPU (f32, 2 images: the continuous outputs within 1e-3 of their
   size, and the CPU's post-processing of the card's continuous outputs
   giving the card's decisions exactly and its boxes within 1e-3 px); and
   ``Trainer`` in mode sgdet (``-loss dnorm -b 6``) for 4 steps (finite
   losses, ``nms_converged_frac``, the detector bit-unchanged, every
   relation-head parameter moved, 3 K1 + 1 K2 launches a step);
   no backward kernel launches on the frozen paths of phases 4-7;
8. detector pretraining at full width under its own deadline:
   ``sgg_torch.pretrain_detector.pretrain`` of ``FasterRCNNVGG(151)``
   (defaults, 592 px, bf16 over f32 master weights, batch 3, 12 synthetic
   images, 2 epochs), counted (K1, K1-bwd-fmap, K1-bwd-boxes, K2 and
   K2-bwd once a step on their bf16 routes, K2-bwd's "bf16-mma" on the
   tensor cores; no plain version on a card tensor), finite losses, every
   parameter moved; its epoch-1 payload,
   unmodified, loaded strictly and evaluated by ``main -m sgdet -nepoch 0
   -ckpt`` (no image with a class above the retry floor after 8 steps
   reads as zero detections; ``DetectionEvaluator`` reads any there are,
   and phase 7's CLI detections); a step under ``set_sync_debug_mode("error")``, timed whole
   and by stage, with its peak memory; the three backward kernels at the
   pretraining shape against their plain versions (f32 and bf16) with
   times and bounds (cuDNN's weight gradient beside K2-bwd), each launched
   twice on the same inputs giving the same bits, K1-bwd-fmap's tile lists
   equal to their CPU model and its ROIs a tile (mean, max) beside the
   proposals' footprints in map cells a ROI, the busiest tile's ROIs timed
   alone, and K1-bwd-fmap at the FPN stride-4 level's shape (3 x 148 x 148
   x 256, the same proposals at scale 1/4) beside its bound; and one f32
   step card against CPU (2 images, the card's proposal slots and the same
   sampler draws: losses within 1e-5 relative; each part's gradient
   within ``GRAD_LIMIT`` in norm, a limit that the same step with
   RoIAlign's boxes detached exceeds; the updated parameters apart by no
   more than the rate times their gradients' difference), with where the
   gap comes from: both devices' heads on the card's feature map, both
   trunks' backward from one map gradient, and the max-pool picks, ReLU
   signs and RoIAlign sample taps that differ between the devices;
9. ResNet50-FPN at full width under its own deadline (592 px, 256
   channels, obj_dim 1024, 151 classes, 51 predicates, bf16 over f32
   masters): ``pretrain`` with its default detector, ``FasterRCNNFPN(151)``
   (batch 3, 18 images, 2 epochs = 12 steps), counted (K1, K1-bwd-fmap
   and K1-bwd-boxes 4 times a step, once a pyramid level, on their bf16
   routes; K2 never), finite losses, every parameter moved and no
   BatchNorm statistic; a step under ``set_sync_debug_mode("error")``,
   timed whole and by stage; K1 and both backward kernels at P2-P5's
   shapes on the step's proposals (the gradient's rows zero outside each
   level's ROIs, as ``multiscale_roi_align`` gives them) and K1 on the
   relation head's 10 x 10 x 256 pool level, against their plain versions
   under phase 3's and phase 8's limits, the backward kernels twice for
   the same bits, with times and bounds; ``main -m sgdet -backbone
   resnet50 -nepoch 0 -ckpt`` on the pretraining's payload and one
   relation train step at batch 6 on that frozen detector (4 + 2 K1
   launches), and the same CLI on a random FPN detector whose classifier
   is scaled by ``CLS_SCALE``, so that detections reach the relation head
   (4 K1 launches a detector pass, 2 a relation pass); one f32 FPN detector
   step card against CPU (2 images, the
   card's proposal slots and the same draws: losses within 1e-5 relative,
   each part's gradient within ``FPN_GRAD_LIMIT`` in norm, a limit that
   two faults on the card exceed: the top-down upsampling with torch's
   ``nearest`` instead of JAX's rule, and RoIAlign's boxes detached); the
   ``-backbone resnet50`` sgcls training at batch 24 (a warm-up and a
   counted epoch, 2 K1 launches a step on the pool level, the trunk
   bit-unchanged, a step's ms on the card) and its dual predcls/sgcls
   evaluation, counted; and ``-edge_model raw_boxes`` on the VGG16 model,
   one train step and one eval forward (2 K1 + 1 K2 each);
10. real inputs under its own deadline: torchvision-format reference
   checkpoints drawn from a seeded generator at full width (a VGG16
   ``FasterRCNN`` with its classifier's weights times ``CLS_SCALE``, a
   ``vgrel.pth`` relation model with its frequency bias, a
   ``maskrcnn_resnet50_fpn`` backbone), saved and imported by ``python -m
   sgg_torch.import_reference_ckpt`` in-process, every mapped tensor
   bitwise equal to its source after the layout change, the skipped names
   printed; ``main -m sgdet -nepoch 0 -ckpt <imported detector>`` on the
   card on the synthetic split with its images written as JPEGs (a shape
   at each box; decoded with PIL), counted as phase 7 (CLI eval images/s
   beside the batches re-detected with sequential NMS); one sgcls eval
   forward of the imported relation model on two of those JPEGs and one
   forward of a ``FasterRCNNFPN`` on the imported backbone on random
   images, card against CPU in f32 (phase 6's 1e-3 and
   phase 7's 1e-3 of the size); and the data packages: with ``h5py`` and
   PIL, ``main -split stanford`` on a VG fixture tree (two train steps and
   the eval); without either, ``sgg_torch.data.visual_genome`` imports and
   ``-split stanford`` raises ``ImportError`` naming what is missing before
   any work on the card; with PIL, ``main -split gqa -backbone resnet50``
   (JSON scene graphs, JPEGs decoded) on a GQA fixture tree on the card;
11. GAN-augmented training at full width under its own deadline: ``Trainer``
   with ``-m sgcls -loss dnorm -b 24 -gan -largeD -perturb graphn -L 0.2
   -topk 5 -graphn_a 2 -split synthetic`` (the VGG16 relation model in bf16
   over f32 masters, the f32 GAN with 37 x 37 x 512 fake maps) on the
   96-image split: a warm-up epoch, then one counted and timed epoch (per
   step K2 once and K1 twice on the real bf16 map, K1 four times on the
   f32 fake map, K1-bwd-fmap twice on ``f32-staged``, no other backward
   kernel and no plain version on a card tensor; finite losses with every
   GAN key; train images/s with the host); a step under
   ``set_sync_debug_mode("error")``; a step timed by phase (F, G, D) with
   CUDA events and its peak memory; the trunk bit-unchanged and every
   relation-head tensor and G and D parameter moved; K1 (f32) and
   K1-bwd-fmap (``f32-staged``, and ``bf16-mma`` for a bf16 GAN) at the
   step's shape (the batch's 40 node boxes and the unions of 256 sampled
   pairs an image over a 24 x 37 x 37 x 512 map) against their plain
   versions under phase 3's and phase 8's limits, each launched twice for
   the same bits, with times and bounds; and one f32 GAN step of 2 images
   card against CPU with TF32 off (losses within ``GAN_LOSS_LIMIT``, the
   gradients each optimizer receives within ``GAN_GRAD_LIMIT`` in norm by
   part, G's and the rec update's within ``GAN_G_LIMIT``), with where G's
   gap comes from: the card's step with K1-bwd-fmap's plain version, and
   G's backward alone from one fixed map gradient, card against CPU;
12. the GAN's feature-bank conditioning at full width under its own
   deadline (the card's machine has no ``h5py``, so the bank's file is
   neither written nor read here; the CPU tests hold both): 12a
   ``extract_features``' forward (batch 8, bf16) over the 96-image split,
   counted (K2 once and K1 twice a batch, bf16), images/s and the copy of a
   batch's pools to the host, the pools card against CPU on 2 images (f32,
   within ``POOL_LIMIT``) and a forward under
   ``set_sync_debug_mode("error")``; 12b the reservoirs filled from those
   pools by ``FeatureBank``'s own draw, one ``sample`` at 24 x 40 and its
   pinned copy timed; 12c ``Trainer`` with phase 11's command and
   ``-vis_cond`` (the bank of 12b): a warm-up and a counted, timed epoch
   (phase 11's launches a step, finite losses with every GAN key, train
   images/s beside phase 11's from the same run, the host's perturbation
   and sample a batch), a step under ``set_sync_debug_mode("error")``, a
   step timed by phase with its peak memory, the trunk bit-unchanged and
   G's projection moved; 12e FID and PRDC between the bank's node pools and
   K1's node pools of the trained G's maps (pool means, 512-d), the
   distance matrices card against CPU (squares within ``DIST_LIMIT``, PRDC
   equal), and ``recall_jit.batch_recall`` on the card over phase 4's eval
   batch (the sgcls regime and predcls on its scores) equal to the numpy
   evaluator's R@20/50/100; 12d one f32 conditioned GAN step of 2 images
   card against CPU with the same vis tensor, under phase 11's limits;
13. data-parallel training and evaluation (``sgg_torch.parallel``) under its
   own deadline: 13a phase 5's training (bf16, batch 24, dropout on, the
   sampler drawing) for an epoch and one sgcls ``val_epoch`` batch under a
   1-rank NCCL group (every collective runs) and with no group, from the
   same state under deterministic algorithms: the same bits in the losses,
   every relation-model tensor and momentum buffer and the metrics, 2 K1 +
   1 K2 a step on the bf16 routes, train images/s beside phase 5's; 13b two
   ranks sharing the card over gloo (``parallel.spawn``: spawned
   processes, a file store in a temporary directory, each joined within
   ``DP_JOIN_S``; a rank's failure fails the phase), f32 with TF32 off, 12
   images a rank against one process on the same 24 from the same state:
   the sgcls step (losses within ``DP_LOSS_LIMIT`` relative, the updated
   parameters and BatchNorm statistics within ``DP_UPDATE_LIMIT`` of the
   largest update, both ranks' states the same bits) and a ``-gan -largeD
   -perturb graphn`` step (every F, G and D loss within ``DP_GAN_LIMIT``),
   the launches counted on each rank (K1 and K2 on ``f32``; the GAN's K1
   ``f32`` on the fake map and K1-bwd-fmap ``f32-staged``), a rank's step
   ms (not a scaling figure: two ranks share one card);
14. multi-process SGDet training under its own deadline: 14a phase 7's
   SGDet training (VGG16 detector, batch 6, bf16, dropout on, the sampler
   drawing) for ``SGDET_DP_STEPS`` steps under a 1-rank NCCL group and
   with no group, from the same state under deterministic algorithms: the
   same bits in the losses and every relation-model tensor and momentum
   buffer, 3 K1 + 1 K2 a step on the bf16 routes; 14b the SGDet step on
   two ranks sharing the card over gloo (spawned as in 13b), f32 with
   TF32 off, 3 images a rank against one process of 6 (the ranks'
   detections the process's rows bit for bit, losses within
   ``MESH_LOSS_LIMIT`` relative, the updated relation model within
   ``DP_UPDATE_LIMIT`` of the largest update, 3 K1 + 1 K2 ``f32`` a
   rank). In f32 a ReLU input within rounding of 0 can gate one way on
   the ranks and the other in one process: 14b records the RoI heads' and
   IMP's ReLU inputs, requires every gate that differs to be a rounding
   flip (its input in one process within its ReLU's largest input
   difference), and holds the update against one process run with the
   ranks' gates (the plain one's is printed);
15. the port's tools and examples under its own deadline, each ``python -m
   sgg_torch.tools.<name>`` (or ``sgg_torch.examples.<name>``) in a process
   of its own, killed at ``TOOL_TIMEOUT_S``, its last line parsed: 15a the
   six profilers at full width, each alone on the card (``profile_step``,
   ``profile_trunk --quick``, ``profile_relhead``, ``profile_sgdet``,
   ``profile_pretrain``, ``profile_gan``; ``TOOL_ITERS`` timed calls a
   stage), then 15b ``e2e_throughput`` (24 x 6 images) and ``soak`` (48
   images x 1 epoch): every stage's card and wall ms finite and positive,
   no MFU over 100%, and each kernel a stage goes through launched in it
   (``TOOL_LAUNCHES``); 15c, all at once: ``reprobe_gates`` (its three
   gates, each stage a process; every stage must finish, its times read
   beside the rehearsal's work), the dress rehearsal's GQA chain
   (``dress_rehearsal.sh ... gqa``: ``pretrain_detector gqa``, ``-m sgcls
   -split gqa -backbone resnet50 -exclude_left_right``, ``-m sgdet -split
   gqa``) on a ``make_fixture_dataset gqa`` tree at 592 px, its
   ``test_results.json`` finite, the preflight on a VG tree of placeholder
   files (exit 1, the first BLOCKER naming ``h5py``, no traceback; the
   card's machine has no ``h5py``), ``perturbations_demo`` and
   ``gan_feature_quality`` (a finite FID). The tools' kernel launches
   (their JSON lines' process totals) join the paths as
   ``tool_<name>``;
16. the native host library (``sgg_torch.native``) under its own
   deadline: 16a a fresh ``g++`` build, timed, and the host CPU's model
   beside the card's name and power limit; 64 seeded uint8 images
   (300-1024 px a side, half flipped) through ``prepare_image_u8`` and its
   plain version (within 1 per byte on at most ``NATIVE_SHARE`` of the
   bytes), ms an image inline and on the loader's 4 threads beside PIL's
   route for the same images; 16b phase 5's train shape packed from
   ragged graphs over both caps, native against plain (equal buffers and
   dropped counts), ms a batch of each; 16c the card's rasterizer on phase
   5's 6,144 pairs within 1e-4 of ``draw_union_rects_native``; 16d ``main
   -m sgcls -loss dnorm -b 24`` (VGG16, 592 px, uint8) for 2 epochs of 4
   steps and the evals on the GQA splits of a fixture tree of JPEGs
   larger than the canvas (the CLI refuses ``-split gqa`` with VGG16, so
   ``load_splits`` answers ``-split synthetic`` with the CLI's GQA
   branch), counted: every uint8 image through the native prep, every
   batch through the native packer, K2 and K1 launched (path
   ``native_gqa``), train images/s by epoch beside phase 5's, and the
   host's ms to assemble a batch of 24 JPEGs on the uint8 (native) and
   float32 (PIL) routes.

Then the launches of each path, a JSON line ``{"kernels": [...]}`` (each
forward row's numbers at the training shapes, the eval shapes' under
``eval_shape``, the SGDet shapes' under ``sgdet``, the FPN levels' and the
pool level's under ``fpn``, the GAN step's under ``gan``; the backward
rows' at the pretraining shape, their FPN levels' under ``fpn``,
K1-bwd-fmap's GAN shape under ``gan``; ``launches`` summed over the paths
of phases 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15 and 16, the data-parallel
paths' launches summed over their ranks, the tools' over their processes) and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOTAL_DEADLINE_S = 1100
PARITY_DEADLINE_S = 420
SGDET_DEADLINE_S = 480
# the JAX bench's training shape (bench.py: sgcls, dnorm, batch 24)
TRAIN_BATCH, TRAIN_NODES, TRAIN_EDGES = 24, 40, 256
# SGDet: eval batch 8 (val_epoch's), the CLI's train batch 6; seeded random
# classifier weights times CLS_SCALE put 50 detections an image above 0.2
# with ~950 candidates above 0.01 on the synthetic canvases (under the
# 1024 cap), where unscaled a 151-way softmax leaves every class near 1/151
SGDET_EVAL_BATCH, SGDET_TRAIN_BATCH, CLS_SCALE = 8, 6, 24.0
CANVAS = 592  # the full-width canvas (constants.IM_SCALE)
# detector pretraining: the reference's VG batch (pretrain_detector.py),
# 12 synthetic images, 2 epochs (8 steps); LR_CHECK: the card-vs-CPU step
PRETRAIN_BATCH, PRETRAIN_IMAGES, PRETRAIN_EPOCHS = 3, 12, 2
PRETRAIN_DEADLINE_S = 420
LR_CHECK = 0.005
# the card-vs-CPU step's gradients, relative in norm by part: above the
# sound steps' and below the reading with RoIAlign's boxes detached
GRAD_LIMIT = 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Deadline:
    """SIGALRM-based deadline for a stretch of the run."""

    def __init__(self, seconds: int, what: str):
        self.seconds, self.what = int(seconds), what

    def _fire(self, *_):
        raise TimeoutError(f"{self.what} passed its {self.seconds} s deadline")

    def __enter__(self):
        self.prev = signal.signal(signal.SIGALRM, self._fire)
        self.prev_left = signal.alarm(self.seconds)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self.prev)
        if self.prev_left:
            used = int(time.monotonic() - self.t0)
            signal.alarm(max(self.prev_left - used, 1))
        return False


def bound_ms(n_bytes: float, flops: float, peaks, bf16: bool):
    """The least time for ``n_bytes`` and ``flops`` on a card of ``peaks``
    (``sgg_torch.utils.profiling.card_peaks``), and which bounds it."""
    bw, bf16_rate, f32_rate = peaks[:3]
    t_bytes = n_bytes / bw * 1e3
    t_ops = flops / (bf16_rate if bf16 else f32_rate) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(torch, got, want) -> float:
    """Max abs error over ``want``'s largest magnitude; 0 where both are
    all zero (an FPN level with no ROI of its own gets no gradient)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eval_boxes(g, B: int, R: int, canvas: int):
    """Image-pixel boxes sized like the synthetic split's, with zero-size,
    inverted, partly and wholly outside boxes mixed in."""
    import torch
    xy = torch.rand(B, R, 2, generator=g) * canvas * 0.8
    wh = torch.rand(B, R, 2, generator=g) * canvas * 0.4 + 8
    b = torch.cat([xy, torch.clamp(xy + wh, max=canvas)], -1)
    b[:, 0] = 0.0
    b[:, 1] = torch.tensor([300.0, 200.0, 100.0, 100.0])
    b[:, 2] = torch.tensor([-50.0, -80.0, 120.0, 90.0])
    b[:, 3] = torch.tensor([500.0, 520.0, 700.0, 650.0])
    b[:, 4] = torch.tensor([-400.0, -300.0, -100.0, -50.0])
    b[:, 5] = torch.tensor([296.0, 296.0, 296.0, 296.0])
    return b.contiguous()


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as printed
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)


def all_kernels():
    """Every CUDA kernel of the port by its row name in the ``kernels``
    line."""
    from sgg_torch.utils.profiling import hand_written_kernels
    return hand_written_kernels()


def phase_build():
    from sgg_torch.ops import _cuda
    t0 = time.perf_counter()
    ks = all_kernels()
    _cuda.build_all(list(ks.values()))
    sources = sorted({k.source.name for k in ks.values()})
    print(f"phase 2 build: {len(ks)} kernels from {len(sources)} sources "
          f"({', '.join(sources)}) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for k in ks.values():
        for line in k.resource_lines():
            print(f"  {k.source.name}: {line}", flush=True)


def phase_routes(torch, K1, K2, g, dev):
    """Every route of the kernels that the main path's shapes do not take,
    each against the plain version; one line a route."""
    def report(name, err, rel):
        print(f"phase 3 route {name}: max|err| f32 {err:.3g}, bf16 rel "
              f"{rel:.3g}", flush=True)
        check(err <= 1e-5, f"{name}: f32 max |err| {err} > 1e-5")
        check(rel <= 2e-2, f"{name}: bf16 rel err {rel} > 2e-2")

    def shifted(t, k):  # contiguous copy, k elements off an aligned address
        buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
        view = buf[k:].view(t.shape)
        view.copy_(t)
        return view

    def k1_route(name, fmap, boxes, shift=0, **kw):
        kw["spatial_scale"] = 1 / 16
        want = K1.roi_align_reference(fmap, boxes, **kw)
        got = K1.roi_align(shifted(fmap, shift), boxes, **kw)
        got16 = K1.roi_align(shifted(fmap.bfloat16(), shift), boxes, **kw)
        report(name, float((got - want).abs().max()),
               rel_err(torch, got16, want))

    B, H, W = 2, 9, 11
    boxes = eval_boxes(g, B, 12, 16 * H).to(dev)
    for C, width in ((203, 1), (6, 2)):
        fmap = torch.randn(B, H, W, C, generator=g).to(dev)
        k1_route(f"roi_align C={C} ({width} channel(s) a thread)", fmap,
                 boxes)
    fmap = torch.randn(B, H, W, 200, generator=g).to(dev)
    k1_route("roi_align C=200 (8 channels a thread, 25 groups)", fmap, boxes)
    k1_route("roi_align C=200, map 2 elements off 16-byte alignment "
             "(2 channels a thread)", fmap, boxes, shift=2)
    k1_route("roi_align ratio 3, pooled 5 (more than 4 taps a bin: the plain "
             "double loop)", fmap, boxes, pooled=5, ratio=3)
    k1_route("roi_align ratio 1", fmap, boxes, ratio=1)
    # the whole 37 x 37 map and a box beyond it (every bin 4 x 4 distinct
    # taps) beside the tiny, degenerate and outside boxes of eval_boxes
    big = eval_boxes(g, B, 12, 592)
    big[:, 6] = torch.tensor([0.0, 0.0, 592.0, 592.0])
    big[:, 7] = torch.tensor([-40.0, -40.0, 640.0, 640.0])
    fmap = torch.randn(B, 37, 37, 512, generator=g)
    k1_route("roi_align whole-map ROI, 37x37x512", fmap.to(dev), big.to(dev))
    # the yardstick itself: the plain version on the card against the same
    # call on the CPU (the one the CPU tests hold against the JAX package),
    # on the same whole-map, tiny, degenerate and outside boxes
    frames = K1._box_frames(big, 1 / 16)
    on_card = K1._interp_weights(frames[1].to(dev), frames[3].to(dev), 37, 7,
                                 2).cpu()
    w_err = float((on_card
                   - K1._interp_weights(frames[1], frames[3], 37, 7, 2)
                   ).abs().max())
    p_err = float((K1.roi_align_reference(fmap.to(dev), big.to(dev),
                                          spatial_scale=1 / 16).cpu()
                   - K1.roi_align_reference(fmap, big, spatial_scale=1 / 16)
                   ).abs().max())
    print(f"phase 3 plain roi_align, card against CPU (f32, whole-map ROI, "
          f"37x37x512): max|err| axis weights {w_err:.3g}, output "
          f"{p_err:.3g}", flush=True)
    check(w_err <= 1e-6, f"plain roi_align axis weights: card and CPU differ "
                         f"by {w_err} > 1e-6")
    check(p_err <= 1e-6, f"plain roi_align: card and CPU differ by {p_err} "
                         f"> 1e-6")

    x = torch.randn(2, 37, 29, 3, generator=g).to(dev)
    w = (torch.randn(3, 3, 3, 64, generator=g) * math.sqrt(2 / 27)).to(dev)
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    want = K2.vgg_conv1_reference(x, w, b)
    report("vgg_conv1 2x37x29 (f32: exact FMA route; bf16: tensor-core "
           "route)", float((K2.vgg_conv1(x, w, b) - want).abs().max()),
           rel_err(torch, K2.vgg_conv1(x.bfloat16(), w, b), want))
    torch.cuda.synchronize()


def measure_kernels(torch, K1, K2, peaks, g, dev, B, n_nodes, n_unions):
    """K1 (one forward's two launches: nodes, then unions) and K2 at one
    batch shape, each against its plain version on the same inputs (f32
    1e-5 abs, bf16 2e-2 relative to the f32 plain result); times and the
    card's bound for the bf16 route. Returns {kernel name: numbers}."""
    canvas, H, C = 592, 37, 512
    fmap = torch.rand(B, H, H, C, generator=g).to(dev)
    nodes = eval_boxes(g, B, n_nodes, canvas).to(dev)
    unions = eval_boxes(g, B, n_unions, canvas).to(dev)
    err, rel = 0.0, 0.0
    for bx in (nodes, unions):
        want = K1.roi_align_reference(fmap, bx, spatial_scale=1 / 16)
        got = K1.roi_align(fmap, bx, spatial_scale=1 / 16)
        err = max(err, float((got - want).abs().max()))
        got16 = K1.roi_align(fmap.bfloat16(), bx, spatial_scale=1 / 16)
        rel = max(rel, rel_err(torch, got16, want))
    torch.cuda.synchronize()
    check(err <= 1e-5, f"roi_align f32 max |err| {err} > 1e-5")
    check(rel <= 2e-2, f"roi_align bf16 rel err {rel} > 2e-2")
    f16 = fmap.bfloat16()

    def k1():
        K1.roi_align(f16, nodes, spatial_scale=1 / 16)
        K1.roi_align(f16, unions, spatial_scale=1 / 16)

    def p1():
        K1.roi_align_reference(f16, nodes, spatial_scale=1 / 16)
        K1.roi_align_reference(f16, unions, spatial_scale=1 / 16)

    n_out = B * (n_nodes + n_unions) * 49 * C
    n_bytes = 2 * fmap.numel() * 2 + (nodes.numel() + unions.numel()) * 4 \
        + n_out * 2
    bms, bby = bound_ms(n_bytes, n_out * 32, peaks, bf16=True)
    rows = {"roi_align": dict(
        max_abs_err=err, bf16_rel_err=rel, ms=time_ms(k1),
        plain_ms=time_ms(p1), bound_ms=bms, bound_by=bby, library_ms=None,
        shape=f"bf16 fmap {B}x37x37x512; nodes R={n_nodes} + unions "
              f"R={n_unions} (one forward's two launches)",
        bytes=n_bytes, flops=n_out * 32)}
    del fmap, f16

    x = (torch.randn(B, canvas, canvas, 3, generator=g)).to(dev)
    w = (torch.randn(3, 3, 3, 64, generator=g) * math.sqrt(2 / 27)).to(dev)
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    want = K2.vgg_conv1_reference(x, w, b)
    got = K2.vgg_conv1(x, w, b)
    torch.cuda.synchronize()
    err2 = float((got - want).abs().max())
    check(err2 <= 1e-5, f"vgg_conv1 f32 max |err| {err2} > 1e-5")
    x16, w16, b16 = x.bfloat16(), w.bfloat16(), b.bfloat16()
    rel2 = rel_err(torch, K2.vgg_conv1(x16, w, b), want)
    check(rel2 <= 2e-2, f"vgg_conv1 bf16 rel err {rel2} > 2e-2")
    del want, got
    xc = x16.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    wc = w16.permute(3, 2, 0, 1).contiguous()
    n_px = B * canvas * canvas
    n_bytes2 = x16.numel() * 2 + (w.numel() + b.numel()) * 4 + n_px * 64 * 2
    flops2 = n_px * 64 * 27 * 2
    bms2, bby2 = bound_ms(n_bytes2, flops2, peaks, bf16=True)
    rows["vgg_conv1"] = dict(
        max_abs_err=err2, bf16_rel_err=rel2,
        ms=time_ms(lambda: K2.vgg_conv1(x16, w16, b16)),
        plain_ms=time_ms(lambda: K2.vgg_conv1_reference(x16, w16, b16)),
        bound_ms=bms2, bound_by=bby2,
        library_ms=time_ms(lambda: torch.relu(
            torch.nn.functional.conv2d(xc, wc, b16, padding=1))),
        shape=f"bf16 {B}x592x592x3 -> {B}x592x592x64", bytes=n_bytes2,
        flops=flops2)
    del x, x16, xc
    torch.cuda.empty_cache()
    return rows


def measure_epilogue(torch, peaks, dev, B: int = TRAIN_BATCH):
    """The trunk's conv epilogue on the outputs of its twelve cuDNN convs
    at batch ``B``, 592 px: in f32 and bf16 the plain version's bits (in
    place without a pool, into the pooled map with one), then the bf16
    route (the training path's) timed as the kernel, the plain version and
    PyTorch's chain that the trunk ran before it (the bias ``add_``,
    ``relu``, ``max_pool2d``), each over copies of the map that outgrow
    the L2 (``past_l2``), beside the byte bound. Returns the row's numbers:
    sums over the twelve and each conv's under ``by_conv``."""
    from sgg_torch.models.backbone import POOL_AFTER, VGG16_CFG
    from sgg_torch.ops import conv_epilogue as EP
    from sgg_torch.tools.profile_trunk import layer_names
    from sgg_torch.utils.profiling import past_l2
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(3)
    side, shapes = CANVAS, []
    for c, pool in zip([v for v in VGG16_CFG if v != "M"], POOL_AFTER):
        shapes.append((side, c, pool))
        side //= 2 if pool else 1
    by_conv = {}
    for name, (H, C, pool) in zip(layer_names()[1:], shapes[1:]):
        for dtype in (torch.float32, torch.bfloat16):
            y = torch.randn(B, H, H, C, generator=g, device=dev).to(dtype)
            b = (torch.randn(C, generator=g, device=dev) * 0.5).to(dtype)
            want = EP.conv_epilogue_reference(y, b, pool)
            got = EP.conv_epilogue(y if pool else y.clone(), b, pool)
            check(got.shape == want.shape and torch.equal(got, want),
                  f"conv_epilogue {name} {dtype}: not the plain version's "
                  f"bits")
            del want, got
        maps = past_l2(y)

        def library():
            x = maps().permute(0, 3, 1, 2)
            x.add_(b.reshape(1, -1, 1, 1))
            x = torch.relu(x)
            return F.max_pool2d(x, 2, 2) if pool else x

        n_out = B * (H // 2) ** 2 * C if pool else y.numel()
        n_bytes = (y.numel() + n_out + C) * y.element_size()
        by_conv[name] = dict(
            ms=time_ms(lambda: EP.conv_epilogue(maps(), b, pool)),
            plain_ms=time_ms(
                lambda: EP.conv_epilogue_reference(maps(), b, pool)),
            library_ms=time_ms(library),
            bound_ms=bound_ms(n_bytes, 0, peaks, bf16=True)[0],
            bytes=n_bytes, shape=f"bf16 {B}x{H}x{H}x{C}")
        del y, maps, library
        torch.cuda.empty_cache()
    sums = {k: sum(m[k] for m in by_conv.values())
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes")}
    return dict(bits_equal=["float32", "bfloat16"], **sums,
                bound_by="bytes", flops=0, by_conv=by_conv,
                shape=f"bf16 B={B}, {CANVAS} px: the twelve cuDNN convs' "
                      f"outputs (4 pooled), summed")


def phase_kernels(torch, peaks):
    """Each kernel against its plain version at the training path's shapes
    (the rows of the ``kernels`` line) and at the eval path's (nested as
    ``eval_shape``), then every other route at small shapes."""
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    train = measure_kernels(torch, K1, K2, peaks, g, dev, TRAIN_BATCH,
                            TRAIN_NODES, TRAIN_EDGES)
    evals = measure_kernels(torch, K1, K2, peaks, g, dev, 16, 64, 256)
    meta = {"roi_align": ("sgg_torch/csrc/roi_align.cu",
                          "sgg_tpu/ops/roi_align_pallas.py:169"),
            "vgg_conv1": ("sgg_torch/csrc/vgg_stem.cu",
                          "sgg_tpu/ops/vgg_stem_pallas.py:68")}
    rows = {}
    for name, (source, replaces) in meta.items():
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, **train[name],
                          eval_shape=evals[name])
    phase_routes(torch, K1, K2, g, dev)
    for r in rows.values():
        for shape, m in (("train", r), ("eval", r["eval_shape"])):
            print(f"phase 3 {r['name']} ({shape} shape): max|err| f32 "
                  f"{m['max_abs_err']:.3g}, bf16 rel {m['bf16_rel_err']:.3g};"
                  f" {m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
                  f"({m['bound_by']}), plain {m['plain_ms']:.4f} ms, library "
                  f"{m['library_ms']} ms [{m['shape']}]", flush=True)
    torch.cuda.empty_cache()
    rows["conv_epilogue"] = dict(
        name="conv_epilogue", route="cuda",
        source="sgg_torch/csrc/conv_epilogue.cu", replaces=None,
        **measure_epilogue(torch, peaks, dev))
    for name, m in [*rows["conv_epilogue"]["by_conv"].items(),
                    ("all twelve", rows["conv_epilogue"])]:
        print(f"phase 3 conv_epilogue {name}: f32 and bf16 the plain "
              f"version's bits; {m['ms']:.4f} ms, bound {m['bound_ms']:.4f} "
              f"ms (bytes, {100 * m['bound_ms'] / m['ms']:.1f}% of it), "
              f"plain {m['plain_ms']:.4f} ms, library {m['library_ms']:.4f} "
              f"ms [{m['shape']}]", flush=True)
    return rows


def phase_slice(torch, splits):
    """val_epoch (sgcls: predcls + sgcls regimes) at full width on the card.
    Returns the launches and one eval batch's GT and outputs (for phase
    12's on-device recall)."""
    from sgg_torch.config import Config
    from sgg_torch.eval.driver import val_epoch
    from sgg_torch.ops import conv_epilogue as EP
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    from sgg_torch.train.trainer import build_model

    config = Config(mode="sgcls", compute_dtype="bfloat16", device="cuda")
    t0 = time.perf_counter()
    model = build_model(config, splits["train"], device="cuda", seed=0)
    print(f"phase 4 model built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params, bf16)", flush=True)
    test = splits["test_alls"]
    # warm-up: one batch per regime (first launches, cuDNN/cuBLAS set-up)
    val_epoch(model, test, config, "test_alls", n_batches=1, verbose=False,
              device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (K1.KERNEL, K2.KERNEL, EP.KERNEL):
        k.reset_counts()
    res = val_epoch(model, test, config, "test_alls", verbose=False,
                    device="cuda")
    torch.cuda.synchronize()
    launches = {"roi_align": K1.KERNEL.launches,
                "vgg_conv1": K2.KERNEL.launches,
                "conv_epilogue": EP.KERNEL.launches}
    routes = {"roi_align": dict(K1.KERNEL.routes),
              "vgg_conv1": dict(K2.KERNEL.routes),
              "conv_epilogue": dict(EP.KERNEL.routes)}
    counters = res.get("_counters", {})
    n_batches = counters.get("eval_ladder_batches", 0)
    forwards = n_batches + counters.get("eval_dedup_fallback", 0)
    expect_batches = 2 * math.ceil(len(test) / 16)
    print(f"phase 4 counters {json.dumps(counters)}; launches "
          f"{json.dumps(launches)} by route {json.dumps(routes)}; forwards "
          f"{forwards}", flush=True)
    check(set(routes["roi_align"]) == set(routes["vgg_conv1"]) == {"bf16"}
          and routes["conv_epilogue"] == trunk_routes(forwards),
          f"eval launched a route other than bf16, or not 12 epilogues a "
          f"forward: {routes}")
    check(n_batches == expect_batches,
          f"{n_batches} eval batches, expected {expect_batches}")
    check(launches["vgg_conv1"] > 0 and launches["vgg_conv1"] == forwards,
          f"vgg_conv1 launched {launches['vgg_conv1']} times for "
          f"{forwards} forwards")
    check(launches["roi_align"] > 0
          and launches["roi_align"] == 2 * forwards,
          f"roi_align launched {launches['roi_align']} times for "
          f"{forwards} forwards (2 each)")
    scalars = {k: v for k, v in res.items() if not k.startswith("_")}
    recalls = {k: v for k, v in scalars.items() if "R@" in k}
    check(len(recalls) > 0 and all(math.isfinite(v) for v in recalls.values()),
          "recalls missing or not finite")
    thr = res["_throughput"]
    for m in ("predcls", "sgcls"):
        check(thr[m]["images"] > 0, f"{m}: no image evaluated")
        print(f"phase 4 {m}: {thr[m]['images']} images in "
              f"{thr[m]['seconds']:.3f} s = "
              f"{thr[m]['images'] / thr[m]['seconds']:.2f} images/s",
              flush=True)
    print(f"phase 4 peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("phase 4 results " + json.dumps(scalars), flush=True)
    # the forward alone, on a batch already on the card (after the counts
    # were read): how much of the loop's wall time the card is busy
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.train.step import make_eval_step
    batch = next(iter(BatchLoader(test, batch_size=16, max_nodes=64,
                                  max_edges=config.max_edges, shuffle=False,
                                  drop_last=False))).to("cuda")
    step = make_eval_step(model, mode="sgcls", max_pairs=512, device="cuda")
    fwd = time_ms(lambda: step(batch), iters=5, warmup=1)
    out = step(batch)
    kept = {k: getattr(batch, k) for k in (
        "boxes", "classes", "node_mask", "rels", "rel_mask")}
    kept.update({k: out[k] for k in (
        "obj_preds", "obj_scores", "pairs", "pair_mask", "rel_dists")})
    loop_s = sum(thr[m]["seconds"] for m in thr)
    print(f"phase 4 one eval forward (16 images, rung 512, dedup, bf16): "
          f"{fwd:.3f} ms; {forwards} forwards = "
          f"{100 * forwards * fwd / 1e3 / loop_s:.1f}% of the "
          f"{loop_s:.3f} s loop", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches, kept


def _snapshot(model, keep):
    return {n: t.detach().clone() for n, t in
            list(model.named_parameters()) + list(model.named_buffers())
            if keep(n)}


def phase_train(torch, splits):
    """Training at full width on the card (``main.py -m sgcls -loss dnorm
    -b 24``): ``Trainer.train_epoch`` twice (a warm-up epoch, then the
    counted and timed one), a one-batch overfit of 10 steps, where the
    step's time goes, and a checkpoint round trip. Returns the launches
    by path and the counted epoch's train images/s."""
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    from sgg_torch import constants
    from sgg_torch.config import Config
    from sgg_torch.data.pipeline import BatchLoader, device_prefetch
    from sgg_torch.ops import conv_epilogue as EP
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    from sgg_torch.train.state import Optimizer
    from sgg_torch.train.step import make_train_step
    from sgg_torch.train.trainer import Trainer

    config = Config(mode="sgcls", loss="dnorm", batch_size=TRAIN_BATCH,
                    max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                    compute_dtype="bfloat16", device="cuda",
                    print_interval=2, num_workers=4)
    t0 = time.perf_counter()
    trainer = Trainer(config, splits)
    model, opt = trainer.model, trainer.optimizer
    steps = trainer.steps_per_epoch
    print(f"phase 5 trainer built in {time.perf_counter() - t0:.1f} s; "
          f"{len(splits['train'])} train images, {steps} steps an epoch",
          flush=True)
    for name, p in model.named_parameters():
        want = torch.bfloat16 if name.startswith("trunk.") else torch.float32
        check(p.dtype == want, f"{name} is {p.dtype}, expected {want}")
    check(all(b.dtype == torch.float32
              for b in opt.state_dict().values()),
          "momentum buffers are not float32")
    trunk0 = _snapshot(model, lambda n: n.startswith("trunk."))
    heads0 = _snapshot(model, lambda n: not n.startswith("trunk.")
                       and "num_batches" not in n)

    def counted(fn):
        for k in (K1.KERNEL, K2.KERNEL, EP.KERNEL):
            k.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        n = {"roi_align": K1.KERNEL.launches, "vgg_conv1": K2.KERNEL.launches,
             "conv_epilogue": EP.KERNEL.launches}
        routes = {"roi_align": dict(K1.KERNEL.routes),
                  "vgg_conv1": dict(K2.KERNEL.routes),
                  "conv_epilogue": dict(EP.KERNEL.routes)}
        return out, n, routes

    trainer.train_epoch(0)  # warm-up: first launches, cuDNN/cuBLAS set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, n_epoch, routes = counted(lambda: trainer.train_epoch(1))
    loop_s = time.perf_counter() - t0
    print(f"phase 5 train_epoch: {steps} steps x {TRAIN_BATCH} images in "
          f"{loop_s:.3f} s = {steps * TRAIN_BATCH / loop_s:.2f} train "
          f"images/s (host included); losses {json.dumps(losses)}; launches "
          f"{json.dumps(n_epoch)} by route {json.dumps(routes)}", flush=True)
    check(all(math.isfinite(v) for v in losses.values()),
          f"non-finite epoch losses {losses}")
    check(n_epoch == {"roi_align": 2 * steps, "vgg_conv1": steps,
                      "conv_epilogue": 12 * steps},
          f"{steps} train steps launched {n_epoch} (want 2 K1 + 1 K2 + 12 "
          f"epilogues a step)")
    check(routes == {"roi_align": {"bf16": 2 * steps},
                     "vgg_conv1": {"bf16": steps},
                     "conv_epilogue": trunk_routes(steps)},
          f"train steps took routes {routes}, want bf16 only")

    # the host's share: batch assembly alone, then one batch's copy, for
    # the trainer's uint8 canvases and for float32 ones
    host_ms, copy_ms, host_mb = {}, {}, {}
    for fmt in ("float32", config.image_format):
        loader = BatchLoader(splits["train"], batch_size=TRAIN_BATCH,
                             max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                             seed=config.seed, num_workers=config.num_workers,
                             im_scale=constants.IM_SCALE, image_format=fmt)
        t0 = time.perf_counter()
        host_batches = list(loader)
        host_ms[fmt] = (time.perf_counter() - t0) * 1e3 / len(host_batches)
        host_mb[fmt] = host_batches[0].images.nbytes / 1e6
        t0 = time.perf_counter()
        batch = host_batches[0].to("cuda")
        torch.cuda.synchronize()
        copy_ms[fmt] = (time.perf_counter() - t0) * 1e3
        if fmt == config.image_format:
            kept = host_batches
        del host_batches
    print(f"phase 5 host batch of {TRAIN_BATCH} canvases by image format: "
          f"assembly ms {json.dumps(host_ms)}, images MB "
          f"{json.dumps(host_mb)}, one copy to the card ms "
          f"{json.dumps(copy_ms)} (the trainer ships "
          f"{config.image_format})", flush=True)
    check(config.image_format == "uint8"
          and host_mb["uint8"] * 4 == host_mb["float32"],
          f"host images {host_mb} MB, want uint8 at a quarter")
    host_ms, copy_ms = host_ms[config.image_format], \
        copy_ms[config.image_format]

    # one-batch overfit, each step timed on a batch already on the card: a
    # generator of one seed each step repeats the sampled edges and the
    # dropout masks, so every step fits the same problem, with a fresh
    # optimizer at a tenth of the LR (the trainer's momentum from other
    # batches at the full LR overshoots on one batch)
    fit_cfg = config.replace(lr=config.lr / 10)
    fit_step = make_train_step(model, fit_cfg, Optimizer(fit_cfg, model))
    gen = torch.Generator(device="cuda").manual_seed(1)
    fit_step(batch, gen)  # compiled routes and allocations are warm; check
    torch.cuda.synchronize()  # that a step never waits for the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit_step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("phase 5 a train step under set_sync_debug_mode('error'): no "
          "host sync", flush=True)

    def overfit():
        totals, step_ms = [], []
        for _ in range(10):
            gen = torch.Generator(device="cuda").manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            totals.append(fit_step(batch, gen)["total"])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(totals).tolist(), step_ms

    (totals, step_ms), n_fit, routes_fit = counted(overfit)
    step_ms.sort()
    print(f"phase 5 overfit one batch, 10 steps: total loss "
          f"{json.dumps([round(t, 5) for t in totals])}; one train step "
          f"{step_ms[len(step_ms) // 2]:.3f} ms median (min "
          f"{step_ms[0]:.3f}, max {step_ms[-1]:.3f}); launches "
          f"{json.dumps(n_fit)} by route {json.dumps(routes_fit)}",
          flush=True)
    check(all(map(math.isfinite, totals)), f"non-finite losses {totals}")
    check(totals[-1] < totals[0], f"loss did not fall: {totals}")
    check(n_fit == {"roi_align": 20, "vgg_conv1": 10, "conv_epilogue": 120}
          and routes_fit == {"roi_align": {"bf16": 20},
                             "vgg_conv1": {"bf16": 10},
                             "conv_epilogue": trunk_routes(10)},
          f"overfit launches {n_fit} by route {routes_fit}")
    print(f"phase 5 peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    changed = [n for n, t in _snapshot(model, trunk0.__contains__).items()
               if not torch.equal(t, trunk0[n])]
    check(not changed, f"trunk changed: {changed[:5]}")
    after = _snapshot(model, heads0.__contains__)
    still = [n for n, t in after.items() if torch.equal(t, heads0[n])]
    check(not still, f"head parameters or BN statistics did not move: "
                     f"{still[:5]}")
    print(f"phase 5 trunk bit-unchanged ({len(trunk0)} tensors); all "
          f"{len(heads0)} head parameters and BN statistics moved",
          flush=True)

    # the trainer's copies on a stream of their own (device_prefetch)
    # against copies on the step's stream: the same host batches, three
    # passes over them a loop, loops timed in turns a b b a a b b a (these
    # calls train on)
    kept = kept * 3

    def loop(prefetch: bool) -> float:
        gen = torch.Generator(device="cuda").manual_seed(3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = device_prefetch(iter(kept), "cuda") if prefetch else \
            (b.to("cuda") for b in kept)
        for b in moved:
            fit_step(b, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(kept)

    loop_ms = {"step_stream": [], "copy_stream": []}
    for prefetch in (False, True, True, False, False, True, True, False):
        loop_ms["copy_stream" if prefetch else "step_stream"].append(
            round(loop(prefetch), 3))
    print(f"phase 5 copy to the card and step, ms a batch of {len(kept)} "
          f"host batches ({config.image_format}), in turns a b b a a b b a: "
          f"{json.dumps(loop_ms)}", flush=True)
    del kept

    # where one step's time goes (after the checks: these calls train on)
    with torch.no_grad():
        trunk_ms = time_ms(lambda: model.trunk(batch.images), iters=5,
                           warmup=1)
    opt_ms = time_ms(opt.apply_gradients, iters=5, warmup=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    per_kernel = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 2e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(f"phase 5 one step: host batch assembly {host_ms:.1f} ms a batch, "
          f"copy to the card {copy_ms:.1f} ms, trunk forward {trunk_ms:.3f} "
          f"ms, optimizer update {opt_ms:.3f} ms; profiled step "
          f"{prof_wall_ms:.3f} ms wall, kernels "
          + (f"{busy_ms:.3f} ms busy ({100 * busy_ms / prof_wall_ms:.1f}%)"
             if per_kernel else "not measured (no device events)"),
          flush=True)
    if per_kernel:
        print("phase 5 top kernels (ms a step) " + json.dumps(
            {k[:90]: round(v, 4) for k, v in top}), flush=True)

    # checkpoint round trip: the next step from the saved and the restored
    # state, on the same batch with generators of the same seed
    ckdir = tempfile.mkdtemp(prefix="sgg_ckpt_")
    try:
        trainer.config = config.replace(save_dir=ckdir)
        trainer.save(1)
        other = Trainer(config.replace(save_dir=ckdir), splits)
        check(other.start_epoch == 2 and other.global_iter == opt.count,
              "restore did not resume after epoch 1")
        mine = dict(model.state_dict())
        diff = [k for k, v in other.model.state_dict().items()
                if not torch.equal(v, mine[k])]
        check(not diff, f"restored state differs: {diff[:5]}")
        a = trainer.train_step(batch, torch.Generator("cuda").manual_seed(5))
        b = other.train_step(batch, torch.Generator("cuda").manual_seed(5))
        errs = {k: float((a[k] - b[k]).abs() / a[k].abs()) for k in a}
        # the forward is deterministic; the backward is not quite (the
        # gathers' backward adds into bf16 with atomics, in any order)
        print(f"phase 5 checkpoint round trip: next step from saved vs "
              f"restored state, rel err {json.dumps(errs)} (losses 1e-6, "
              f"grad_norm 1e-3)", flush=True)
        check(all(errs[k] <= 1e-6 for k in ("obj_loss", "rel_loss", "total"))
              and errs["grad_norm"] <= 1e-3,
              f"restored run diverges: {errs}")
        del other
    finally:
        shutil.rmtree(ckdir)
    del trainer, model, opt, batch
    torch.cuda.empty_cache()
    return ({"train_epoch": n_epoch, "overfit": n_fit},
            steps * TRAIN_BATCH / loop_s)


def phase_parity(torch, splits):
    """One full-width eval step and one full-width train step in f32: card
    (kernels) against CPU (plain versions) with the same weights."""
    from sgg_torch import constants
    from sgg_torch.config import Config
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.models.backbone import Dropout
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.assign import sample_edges
    from sgg_torch.train.state import Optimizer
    from sgg_torch.train.step import make_eval_step, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    test = splits["test_alls"]
    cpu = init_weights(RelModelIMP(num_classes=test.num_classes,
                                   num_predicates=test.num_predicates), 1)
    cpu.eval()
    card = RelModelIMP(num_classes=test.num_classes,
                       num_predicates=test.num_predicates)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    loader = BatchLoader(test, batch_size=2, max_nodes=64, max_edges=576,
                         shuffle=False, drop_last=False,
                         im_scale=constants.IM_SCALE)
    batch = next(iter(loader))
    n = batch.node_mask.sum(1)
    check(int((n * (n - 1)).max()) <= 512, "parity batch needs > 512 pairs")
    t0 = time.perf_counter()
    got = make_eval_step(card, mode="sgcls", max_pairs=512,
                         device="cuda")(batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = make_eval_step(cpu, mode="sgcls", max_pairs=512,
                          device="cpu")(batch)
    t_cpu = time.perf_counter() - t0
    errs = {k: float((got[k].cpu() - want[k]).abs().max())
            for k in ("obj_logits", "rel_dists")}
    valid = torch.from_numpy(batch.node_mask)
    same = bool(torch.equal(got["obj_preds"].cpu()[valid],
                            want["obj_preds"][valid]))
    print(f"phase 6 eval parity card vs CPU (f32, 2 images, full width): "
          f"max|err| {json.dumps(errs)}, obj_preds equal {same}; card "
          f"{t_card:.2f} s, CPU {t_cpu:.2f} s", flush=True)
    check(all(math.isfinite(v) and v <= 1e-3 for v in errs.values()),
          f"card vs CPU outputs differ: {errs}")
    check(same, "card vs CPU obj_preds differ")

    # one train step of 2 images on the same sampled edges, dropout off
    # (the card's and the CPU's generators draw different numbers)
    for mod in list(cpu.modules()) + list(card.modules()):
        if isinstance(mod, Dropout):
            mod.p = 0.0
    train = BatchLoader(splits["train"], batch_size=2,
                        max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                        shuffle=False, im_scale=constants.IM_SCALE)
    batch = next(iter(train))
    host = batch.to("cpu")
    edges = sample_edges(torch.Generator().manual_seed(0), host.rels,
                         host.rel_mask, host.node_mask, max_out=TRAIN_EDGES)
    out, secs, opts = {}, {}, {}
    for dev, m in (("cuda", card), ("cpu", cpu)):
        cfg = Config(device=dev, mode="sgcls", loss="dnorm", batch_size=2,
                     max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                     compute_dtype="float32")
        opts[dev] = Optimizer(cfg, m)
        step = make_train_step(m, cfg, opts[dev])
        t0 = time.perf_counter()
        out[dev] = {k: float(v) for k, v in step(batch, None,
                                                 edges=edges).items()}
        secs[dev] = time.perf_counter() - t0
    loss_err = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
                for k in out["cpu"]}
    # the update itself: after one step from zero, each momentum buffer is
    # the clipped gradient plus the decay, unrounded (the parameters round
    # it away where it is below their ulp, as on BatchNorm scales near 1).
    # Held as one vector, like grad_norm: a tensor whose gradient cancels
    # (a conv bias before a train-mode BatchNorm) is summation-order noise
    # relative to its own size. The tensors that carry most of the
    # difference are printed with their own relative error
    mom = opts["cpu"].state_dict()
    sq = {}
    for k, v in opts["cuda"].state_dict().items():
        d = v.cpu() - mom[k]
        sq[k] = (float(d.square().sum()), float(mom[k].square().sum()))
    upd_err = math.sqrt(sum(d for d, _ in sq.values())
                        / sum(r for _, r in sq.values()))
    top = {k: round(math.sqrt(d / r), 6) for k, (d, r) in
           sorted(sq.items(), key=lambda kv: -kv[1][0])[:3]}
    ours = cpu.state_dict()
    par_err = max(float((v.cpu() - ours[k]).abs().max())
                  for k, v in card.state_dict().items())
    print(f"phase 6 train parity card vs CPU (f32, 2 images, full width, "
          f"same edges): loss/grad_norm rel err {json.dumps(loss_err)}; "
          f"update (momentum buffers) rel err {upd_err:.3g} in norm, most "
          f"of it in {json.dumps(top)} (each in its own norm); updated "
          f"parameters and BN statistics max|err| {par_err:.3g}; card "
          f"{secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s", flush=True)
    check(all(v <= 1e-4 for v in loss_err.values()),
          f"card vs CPU losses differ: {loss_err}")
    check(upd_err <= 1e-3 and par_err <= 1e-6,
          f"card vs CPU updates differ: {upd_err} relative in norm, "
          f"parameters {par_err} max abs")


def sgdet_detector(torch, num_classes: int, seed: int = 0):
    """The full-width ``FasterRCNNVGG`` (f32, on the CPU) with seeded random
    weights, its classifier's weights times ``CLS_SCALE``."""
    from sgg_torch.models.detector import FasterRCNNVGG, init_detector_weights
    det = init_detector_weights(FasterRCNNVGG(num_classes), seed)
    with torch.no_grad():
        det.cls_score.weight.mul_(CLS_SCALE)
    return det.eval()


def _on_card(torch, det, dtype):
    import copy
    return copy.deepcopy(det).requires_grad_(False).to_compute_dtype(
        dtype).cuda().eval()


def trunk_routes(forwards: int, dtype: str = "bf16"):
    """The conv epilogue's launches by route in ``forwards`` frozen trunk
    forwards: 4 with a pool and 8 without, each."""
    return ({f"{dtype}-pool": 4 * forwards, f"{dtype}-nopool": 8 * forwards}
            if forwards else {})


NO_BACKWARD = {"roi_align_bwd_fmap": 0, "roi_align_bwd_boxes": 0,
               "vgg_conv1_bwd": 0}


def _counted(torch, fn):
    """``fn()`` with every kernel's count zeroed before and read after; a
    plain version (forward or backward) called on a card tensor meanwhile
    fails the run. Returns (out, launches, launches by route), by kernel.

    Every trunk forward launches K2 once, and a frozen one the conv
    epilogue 4 times with a pool and 8 without (``trunk_routes``); the
    epilogue's launches must be that for at most K2's launches."""
    from sgg_torch.ops import conv_epilogue as EP
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    plain = [(K1, "roi_align_reference"),
             (K1, "roi_align_backward_reference"),
             (K1, "roi_align_boxes_grad_reference"),
             (K2, "vgg_conv1_reference"),
             (K2, "vgg_conv1_backward_reference"),
             (EP, "conv_epilogue_reference")]
    saved = [getattr(mod, name) for mod, name in plain]
    on_card = []

    def watch(f, name):
        def call(x, *a, **k):
            if x.is_cuda:
                on_card.append(name)
            return f(x, *a, **k)
        return call

    ks = all_kernels()
    for k in ks.values():
        k.reset_counts()
    try:
        for (mod, name), f in zip(plain, saved):
            setattr(mod, name, watch(f, name))
        out = fn()
        torch.cuda.synchronize()
    finally:
        for (mod, name), f in zip(plain, saved):
            setattr(mod, name, f)
    check(not on_card, f"plain versions ran on the card: {on_card[:3]}")
    epi = dict(ks["conv_epilogue"].routes)
    fused = {d: epi.get(f"{d}-pool", 0) // 4 for d in ("bf16", "f32")}
    check(epi == {**trunk_routes(fused["bf16"]),
                  **trunk_routes(fused["f32"], "f32")}
          and sum(fused.values()) <= ks["vgg_conv1"].launches,
          f"the conv epilogue launched {epi} by route for "
          f"{ks['vgg_conv1'].launches} trunk forwards (K2's launches)")
    return out, {n: k.launches for n, k in ks.items()}, {
        n: dict(k.routes) for n, k in ks.items()}


def sgdet_eval_cli(torch, det, ckdir):
    """7a: ``python -m sgg_torch.main -m sgdet -nepoch 0 -ckpt <dir>`` at
    full width, counted."""
    from sgg_torch import main as cli
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.models.sgdet import sgdet_eval_with_retry
    from sgg_torch.models.relhead import RelModelIMP, init_weights

    # warm-up on the same shapes (CUDA context, cuDNN/cuBLAS handles, the
    # kernels' libraries), outside the counted run
    warm = _on_card(torch, det, torch.bfloat16)
    rel = init_weights(RelModelIMP(num_classes=151, num_predicates=51,
                                   mode="sgdet"), 0)
    rel = rel.to_compute_dtype(torch.bfloat16).cuda().eval()
    test = synthetic_splits(num_eval=SGDET_EVAL_BATCH)["test_alls"]
    batch = next(iter(BatchLoader(test, batch_size=SGDET_EVAL_BATCH,
                                  max_nodes=64, max_edges=64,
                                  shuffle=False, drop_last=False)))
    sgdet_eval_with_retry(warm, rel, batch)
    del warm, rel
    torch.cuda.empty_cache()

    argv = ["-m", "sgdet", "-nepoch", "0", "-ckpt", ckdir, "-split",
            "synthetic", "-val_size", "32", "-nwork", "4"]
    t0 = time.perf_counter()
    res, n, routes = _counted(torch, lambda: cli.main(argv))
    wall = time.perf_counter() - t0
    thr, cnt, dets = res["_throughput"], res["_counters"], res["_detections"]
    images = sum(t["sgdet"]["images"] for t in thr.values())
    secs = sum(t["sgdet"]["seconds"] for t in thr.values())
    n_det = [d for v in dets.values() for d in v["n_det"]]
    sel = [t for v in dets.values() for t in v["sel_thresh"]]
    batches = sum(c.get("sgdet_batches", 0) for c in cnt.values())
    redetect = sum(c.get("sgdet_nms_unconverged", 0)
                   + c.get("sgdet_nms_cand_overflow", 0)
                   for c in cnt.values())
    shares = {f"{t:g}": round(sel.count(t) / len(sel), 4)
              for t in sorted(set(sel), reverse=True)}
    print(f"phase 7 sgdet eval (main -m sgdet -nepoch 0 -ckpt, 4 test "
          f"splits, batch {SGDET_EVAL_BATCH}): {images} of {len(n_det)} "
          f"images reached the evaluator in {secs:.3f} s of eval loops = "
          f"{images / secs:.2f} images/s ({wall:.1f} s with model "
          f"building); per split " + json.dumps(
              {k: round(v["sgdet"]["images"] / v["sgdet"]["seconds"], 2)
               for k, v in thr.items()}) + " images/s", flush=True)
    print(f"phase 7 counters {json.dumps(cnt)}; detections an image min "
          f"{min(n_det)} median {sorted(n_det)[len(n_det) // 2]} max "
          f"{max(n_det)}; selected threshold shares {json.dumps(shares)}; "
          f"launches {json.dumps(n)} by route {json.dumps(routes)}",
          flush=True)
    recalls = {k: v for k, v in res.items()
               if k.startswith("sgdet/test_alls_R@") and
               k.split("R@")[1].split("_")[0] in ("20", "50", "100")}
    ap, n_img, n_total = _det_ap(dets)
    print("phase 7 recalls " + json.dumps(recalls) + f"; DetectionEvaluator "
          f"over {n_img} images, {n_total} detections {json.dumps(ap)}",
          flush=True)
    check(images >= 0.5 * len(n_det),
          f"only {images} of {len(n_det)} images reached the evaluator")
    check(max(n_det) == 50, f"no image filled the 50 detection slots "
                            f"(max {max(n_det)})")
    check(len(recalls) == 6 and all(math.isfinite(v)
                                    for v in recalls.values()),
          f"recalls missing or not finite: {recalls}")
    check(all(set(r) <= {"bf16"} for k, r in routes.items()
              if k != "conv_epilogue")
          and routes["conv_epilogue"] == trunk_routes(batches + redetect),
          f"sgdet eval launched a route other than bf16: {routes}")
    want = {"vgg_conv1": batches + redetect,
            "roi_align": batches + redetect + 2 * batches, **NO_BACKWARD,
            "conv_epilogue": 12 * (batches + redetect)}
    check(n == want, f"sgdet eval launched {n}; {batches} batches with "
                     f"{redetect} re-detections want {want}")
    return n


def _stage_times(torch, det, step, batch, rung, iters=5):
    """7b: one eval pass split by stage with CUDA events (ms, mean of
    ``iters`` after one warm-up)."""
    from sgg_torch.models.detector import (generate_proposals,
                                           postprocess_detections)
    from sgg_torch.ops.roi_align import roi_align

    names = ("trunk", "rpn_proposals", "box_head", "postprocess_nms",
             "select_pairs", "relation_head")
    totals = dict.fromkeys(names, 0.0)
    for it in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        with torch.inference_mode():
            ev[0].record()
            fmap = det.trunk(batch.images)
            ev[1].record()
            obj, dl = det.rpn(fmap)
            anchors = det.anchors(fmap.shape[1], fmap.shape[2], fmap.device)
            props, _, pmask, _, _ = generate_proposals(
                anchors, obj, dl, batch.im_hw,
                pre_nms_top_n=det.rpn_pre_nms_top_n,
                post_nms_top_n=det.rpn_post_nms_top_n,
                nms_thresh=det.rpn_nms_thresh, nms_method=det.nms_method,
                nms_rounds=det.nms_rounds)
            ev[2].record()
            feats = det.box_head(roi_align(fmap, props, spatial_scale=1 / 16,
                                           pooled=7)).float()
            cl, bd = det.cls_score(feats), det.bbox_pred(feats)
            ev[3].record()
            postprocess_detections(
                cl, bd, props, pmask, batch.im_hw, score_thresh=0.01,
                nms_thresh=det.nms_thresh,
                detections_per_img=det.detections_per_img,
                nms_candidates=det.nms_candidates,
                nms_method=det.nms_method, nms_rounds=det.nms_rounds)
            ev[4].record()
        d = step.detect(batch)  # the whole detect stage, pairs included
        ev[5].record()
        step.relate(d, rung)
        ev[6].record()
        torch.cuda.synchronize()
        if it:
            ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]
            detect_ms = ev[4].elapsed_time(ev[5])
            # select_pairs: the detect stage beyond the detector's stages
            ms[4] = detect_ms - sum(ms[:4])
            for k, v in zip(names, ms):
                totals[k] += v / iters
    return totals, props


def sgdet_kernels(torch, peaks, fmap16, props, n_unions):
    """7b: K1 at the detector's shape (one launch over 8 x 512 proposals)
    and K1's three launches of an SGDet eval and train step; K2 at batch 8
    and 6. Each against its plain version on the same inputs."""
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    dev = fmap16.device
    g = torch.Generator().manual_seed(7)
    B, H, W, C = fmap16.shape
    f32 = torch.rand(B, H, W, C, generator=g).to(dev)
    want = K1.roi_align_reference(f32, props, spatial_scale=1 / 16)
    err = float((K1.roi_align(f32, props, spatial_scale=1 / 16)
                 - want).abs().max())
    rel = rel_err(torch, K1.roi_align(fmap16, props, spatial_scale=1 / 16),
                  K1.roi_align_reference(fmap16.float(), props,
                                         spatial_scale=1 / 16))
    check(err <= 1e-5, f"roi_align detector shape f32 max |err| {err}")
    check(rel <= 2e-2, f"roi_align detector shape bf16 rel err {rel}")
    del f32, want

    def k1_bytes(b, r):
        return b * H * W * C * 2 + b * r * 16 + b * r * 49 * C * 2

    def k1_row(b, rs):
        fm = fmap16[:b].contiguous()
        boxes = [eval_boxes(g, b, r, CANVAS).to(dev) for r in rs]
        boxes[0] = props[:b, :rs[0]].contiguous()
        n_out = sum(b * r * 49 * C for r in rs)
        nb = sum(k1_bytes(b, r) for r in rs)
        bms, bby = bound_ms(nb, n_out * 32, peaks, bf16=True)
        return dict(
            ms=time_ms(lambda: [K1.roi_align(fm, x, spatial_scale=1 / 16)
                                for x in boxes]),
            plain_ms=time_ms(lambda: [K1.roi_align_reference(
                fm, x, spatial_scale=1 / 16) for x in boxes], iters=5),
            bound_ms=bms, bound_by=bby, library_ms=None,
            shape=f"bf16 fmap {b}x{H}x{W}x{C}; "
            f"R={'+'.join(map(str, rs))}")

    out = {"roi_align": {
        "detector_shape": dict(max_abs_err=err, bf16_rel_err=rel,
                               **k1_row(B, (512,))),
        "eval_step": k1_row(SGDET_EVAL_BATCH, (512, 50, n_unions)),
        "train_step": k1_row(SGDET_TRAIN_BATCH, (512, 50, 64))}}
    k2 = {}
    for name, b in (("eval_step", SGDET_EVAL_BATCH),
                    ("train_step", SGDET_TRAIN_BATCH)):
        x = torch.randn(b, CANVAS, CANVAS, 3,
                        generator=g).to(dev).bfloat16()
        w = (torch.randn(3, 3, 3, 64, generator=g) * 0.2).to(dev)
        bias = torch.zeros(64, device=dev)
        n_px = b * CANVAS * CANVAS
        bms, bby = bound_ms(x.numel() * 2 + (w.numel() + 64) * 4
                            + n_px * 64 * 2, n_px * 64 * 27 * 2, peaks,
                            bf16=True)
        xc = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        wc = w.bfloat16().permute(3, 2, 0, 1).contiguous()
        k2[name] = dict(ms=time_ms(lambda: K2.vgg_conv1(x, w, bias)),
                        plain_ms=time_ms(lambda: K2.vgg_conv1_reference(
                            x, w.bfloat16(), bias.bfloat16()), iters=5),
                        library_ms=time_ms(lambda: torch.relu(
                            torch.nn.functional.conv2d(
                                xc, wc, bias.bfloat16(), padding=1))),
                        bound_ms=bms, bound_by=bby,
                        shape=f"bf16 {b}x{CANVAS}x{CANVAS}x3 -> "
                              f"{b}x{CANVAS}x{CANVAS}x64")
        del x, xc
    out["vgg_conv1"] = k2
    torch.cuda.empty_cache()
    for kname, row in out.items():
        for shape, m in row.items():
            print(f"phase 7 {kname} ({shape}): {m['ms']:.4f} ms, bound "
                  f"{m['bound_ms']:.4f} ms ({m['bound_by']}), plain "
                  f"{m['plain_ms']:.4f} ms, library "
                  f"{m.get('library_ms')} ms"
                  + (f", max|err| f32 {m['max_abs_err']:.3g}, bf16 rel "
                     f"{m['bf16_rel_err']:.3g}" if "max_abs_err" in m
                     else "") + f" [{m['shape']}]", flush=True)
    return out


def sgdet_escalations(torch, det, rel, batch):
    """7c: each escalation of the retry wrapper forced once, each equal to
    the exact run (sequential NMS, a covering cap, dense pairs)."""
    import numpy as np

    from sgg_torch.models.sgdet import (make_sgdet_retry_eval_step,
                                        sgdet_eval_with_retry)
    from sgg_torch.utils import counters
    cases = {"candidate cap 64": ({"nms_candidates": 64}, None),
             "one NMS round": ({"nms_rounds": 1}, None),
             "pair budget 16": ({}, 16)}
    need = 0
    for name, (settings, mp) in cases.items():
        saved = {k: getattr(det, k) for k in settings}
        before = counters.snapshot()
        try:
            for k, v in settings.items():
                setattr(det, k, v)
            t0 = time.perf_counter()
            got = sgdet_eval_with_retry(det, rel, batch, max_pairs=mp)
            secs = time.perf_counter() - t0
        finally:
            for k, v in saved.items():
                setattr(det, k, v)
        events = counters.delta(before)
        need = max(need, int(got["n_nms_candidates"].max()))
        cap = 1 << max(need - 1, 1).bit_length()
        exact = make_sgdet_retry_eval_step(
            det, rel, max_pairs=None, nms_method="sequential",
            nms_candidates=cap)(batch)
        diff = [k for k, v in exact.items()
                if not np.array_equal(v.cpu().numpy(), got[k])]
        print(f"phase 7 escalation '{name}': counters {json.dumps(events)} "
              f"in {secs:.3f} s; equal to the exact run (sequential NMS, "
              f"cap {cap}, dense pairs): {not diff}", flush=True)
        want_event = {"candidate cap 64": "sgdet_nms_cand_overflow",
                      "one NMS round": "sgdet_nms_unconverged",
                      "pair budget 16": "sgdet_pair_overflow"}[name]
        check(events.get(want_event, 0) == 1,
              f"{name}: {want_event} did not fire: {events}")
        check(not diff, f"{name}: differs from the exact run in {diff}")


def sgdet_card_vs_cpu(torch, det_cpu):
    """7d: the detector in f32 on the card and on the CPU, 2 images at full
    width; then the CPU's post-processing of the card's continuous
    outputs."""
    from sgg_torch.models.detector import (generate_proposals,
                                           postprocess_detections)
    from sgg_torch.models.sgdet import detection_pairs
    from sgg_torch.ops.roi_align import roi_align
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    card = _on_card(torch, det_cpu, torch.float32)
    g = torch.Generator().manual_seed(3)
    images = torch.randn(2, CANVAS, CANVAS, 3, generator=g)
    im_hw = torch.tensor([[CANVAS, CANVAS], [0.75 * CANVAS, CANVAS]],
                         dtype=torch.float32)
    with torch.no_grad():
        got = card(images.cuda(), im_hw.cuda())
        pairs_g = [x.cpu() for x in detection_pairs(got["boxes"],
                                                    got["mask"], True)]
        t0 = time.perf_counter()
        want = det_cpu(images, im_hw)
        t_cpu = time.perf_counter() - t0
    got = {k: v.cpu() for k, v in got.items()}
    # the box head is held on the card's proposals: the CPU's own can differ
    # where two RPN scores differ by less than the devices do
    with torch.no_grad():
        feats = det_cpu.box_head(roi_align(
            want["fmap"], got["proposals"], spatial_scale=1 / 16,
            pooled=7)).float()
        want["class_logits"] = det_cpu.cls_score(feats)
        want["box_deltas"] = det_cpu.bbox_pred(feats)
    flips = int(((got["proposals"] - want["proposals"]).abs().amax(-1)
                 > 1e-2).sum())
    errs = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max())
            for k in ("fmap", "rpn_obj_logits", "rpn_deltas",
                      "class_logits", "box_deltas")}
    # the CPU's post-processing of the card's own continuous outputs
    props, _, pmask, _, _ = generate_proposals(
        got["anchors"], got["rpn_obj_logits"], got["rpn_deltas"], im_hw,
        pre_nms_top_n=card.rpn_pre_nms_top_n,
        post_nms_top_n=card.rpn_post_nms_top_n,
        nms_thresh=card.rpn_nms_thresh, nms_method=card.nms_method,
        nms_rounds=card.nms_rounds)
    post = postprocess_detections(
        got["class_logits"], got["box_deltas"], got["proposals"],
        got["prop_mask"], im_hw, score_thresh=card.score_thresh,
        nms_thresh=card.nms_thresh,
        detections_per_img=card.detections_per_img,
        nms_candidates=card.nms_candidates, nms_method=card.nms_method,
        nms_rounds=card.nms_rounds)
    pairs_c = detection_pairs(post["boxes"], post["mask"], True)
    same = {"prop_mask": torch.equal(pmask, got["prop_mask"]),
            "labels": torch.equal(post["labels"], got["labels"]),
            "mask": torch.equal(post["mask"], got["mask"]),
            "n_candidates": torch.equal(post["n_candidates"],
                                        got["n_candidates"]),
            "pairs": torch.equal(pairs_c[0], pairs_g[0])
            and torch.equal(pairs_c[1], pairs_g[1])}
    box_err = {"proposals": float((props - got["proposals"]).abs().max()),
               "boxes": float((post["boxes"] - got["boxes"]).abs().max())}
    print(f"phase 7 card vs CPU detector (f32, 2 images, full width): "
          f"rel err {json.dumps(errs)} (box head on the card's proposals; "
          f"{flips} of {got['proposals'].shape[0] * got['proposals'].shape[1]}"
          f" proposal slots more than 1e-2 px off the CPU's own); CPU "
          f"post-processing "
          f"of the card's "
          f"outputs: equal {json.dumps(same)}, box max|err| "
          f"{json.dumps(box_err)} px; detections {got['mask'].sum(1).tolist()}"
          f"; CPU forward {t_cpu:.2f} s", flush=True)
    check(all(v <= 1e-3 for v in errs.values()),
          f"card vs CPU detector outputs differ: {errs}")
    check(all(same.values()), f"CPU post-processing differs: {same}")
    check(all(v <= 1e-3 for v in box_err.values()),
          f"CPU post-processing boxes differ: {box_err}")
    del card
    torch.cuda.empty_cache()


def sgdet_train(torch, det_cpu):
    """7e: ``Trainer`` in mode sgdet (``main.py -m sgdet -loss dnorm -b
    6``) for 4 steps, then one step under the sync check and the step's
    time on a batch already on the card."""
    import copy

    from sgg_torch.config import Config
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.trainer import Trainer

    splits = synthetic_splits(num_train=4 * SGDET_TRAIN_BATCH, num_eval=8)
    config = Config(mode="sgdet", loss="dnorm", batch_size=SGDET_TRAIN_BATCH,
                    compute_dtype="bfloat16", device="cuda",
                    print_interval=2, num_workers=4)
    trainer = Trainer(config, splits, detector=copy.deepcopy(det_cpu))
    det, model = trainer.detector, trainer.model
    det0 = _snapshot(det, lambda n: True)
    rel0 = _snapshot(model, lambda n: "num_batches" not in n)
    steps = trainer.steps_per_epoch
    t0 = time.perf_counter()
    losses, n_epoch, routes = _counted(torch, lambda: trainer.train_epoch(0))
    loop_s = time.perf_counter() - t0
    print(f"phase 7 sgdet train_epoch (-loss dnorm -b {SGDET_TRAIN_BATCH}): "
          f"{steps} steps in {loop_s:.3f} s = "
          f"{steps * SGDET_TRAIN_BATCH / loop_s:.2f} train images/s (host "
          f"and first-step set-up included); losses {json.dumps(losses)}; "
          f"launches {json.dumps(n_epoch)} by route {json.dumps(routes)}",
          flush=True)
    check(steps == 4, f"{steps} steps an epoch, want 4")
    check(all(math.isfinite(v) for v in losses.values()),
          f"non-finite losses {losses}")
    check(n_epoch == {"roi_align": 3 * steps, "vgg_conv1": steps,
                      **NO_BACKWARD, "conv_epilogue": 12 * steps}
          and routes == {"roi_align": {"bf16": 3 * steps},
                         "vgg_conv1": {"bf16": steps},
                         **{k: {} for k in NO_BACKWARD},
                         "conv_epilogue": trunk_routes(steps)},
          f"sgdet train launched {n_epoch} by route {routes} (want 3 K1 + "
          f"1 K2 a step, bf16)")
    batch = next(iter(BatchLoader(splits["train"],
                                  batch_size=SGDET_TRAIN_BATCH,
                                  max_nodes=config.max_nodes,
                                  max_edges=config.max_edges,
                                  seed=config.seed))).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_ms, fracs = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        fracs.append(float(m["nms_converged_frac"]))
    step_ms.sort()
    changed = [n for n, t in _snapshot(det, lambda n: True).items()
               if not torch.equal(t, det0[n])]
    after = _snapshot(model, rel0.__contains__)
    still = [n for n, t in after.items() if torch.equal(t, rel0[n])]
    print(f"phase 7 sgdet train step on a batch on the card: "
          f"{step_ms[len(step_ms) // 2]:.3f} ms median of 5 (min "
          f"{step_ms[0]:.3f}, max {step_ms[-1]:.3f}) = "
          f"{SGDET_TRAIN_BATCH * 1e3 / step_ms[len(step_ms) // 2]:.2f} "
          f"images/s; no host sync under set_sync_debug_mode('error'); "
          f"nms_converged_frac {fracs}; detector bit-unchanged "
          f"({len(det0)} tensors): {not changed}; relation-head tensors "
          f"moved {len(after) - len(still)} of {len(after)}", flush=True)
    check(not changed, f"the detector changed: {changed[:5]}")
    check(not still, f"relation-head tensors did not move: {still[:5]}")
    del trainer, det, model, batch
    torch.cuda.empty_cache()
    return n_epoch


def phase_sgdet(torch, peaks, rows):
    """Phase 7: the SGDet paths at full width."""
    import shutil
    import tempfile

    from sgg_torch.config import Config
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.models.sgdet import (SGDET_EVAL_MAX_PAIRS,
                                        make_sgdet_retry_eval_step)
    from sgg_torch.train.checkpoint import save_detector
    from sgg_torch.train.trainer import build_model

    t0 = time.perf_counter()
    det_cpu = sgdet_detector(torch, 151)
    print(f"phase 7 detector built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in det_cpu.parameters()) / 1e6:.1f} M "
          f"params)", flush=True)
    ckdir = tempfile.mkdtemp(prefix="sgg_det_")
    try:
        save_detector(ckdir, det_cpu)
        paths = {"sgdet_eval": sgdet_eval_cli(torch, det_cpu, ckdir)}
    finally:
        shutil.rmtree(ckdir)

    # one eval pass of 8 images on the card, by stage
    det = _on_card(torch, det_cpu, torch.bfloat16)
    test = synthetic_splits(num_eval=32)["test_alls"]
    rel = build_model(Config(mode="sgdet"), test, device="cuda", seed=0)
    batch = next(iter(BatchLoader(test, batch_size=SGDET_EVAL_BATCH,
                                  max_nodes=64, max_edges=64,
                                  shuffle=False, drop_last=False))).to("cuda")
    step = make_sgdet_retry_eval_step(det, rel,
                                      max_pairs=SGDET_EVAL_MAX_PAIRS)
    d = step.detect(batch)
    flags = step.flags(d)
    rung = step.rung_for(flags["pair_count"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stages, props = _stage_times(torch, det, step, batch, rung)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.set_sync_debug_mode("error")
    try:  # batch on the card, everything warm: neither stage may wait
        d = step.detect(batch)
        step.relate(d, rung)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the union launch pools half the edge budget (dedup), padding included
    n_unions = max((rung or step.n_pairs) // 2, 8)
    print(f"phase 7 one sgdet eval pass ({SGDET_EVAL_BATCH} images, bf16, "
          f"pair rung {rung}): ms by stage " + json.dumps(
              {k: round(v, 3) for k, v in stages.items()})
          + f", detector {sum(list(stages.values())[:4]):.3f} ms; peak "
          f"device memory {peak:.2f} GiB; flags {json.dumps(flags)}; the "
          f"detect and relate stages ran under set_sync_debug_mode('error')",
          flush=True)
    kern = sgdet_kernels(torch, peaks, d["fmap"], props, n_unions)
    for name, row in kern.items():
        rows[name]["sgdet"] = row

    sgdet_escalations(torch, det, rel, batch)
    del det, rel, step, batch, d, props
    torch.cuda.empty_cache()
    sgdet_card_vs_cpu(torch, det_cpu)
    paths["sgdet_train"] = sgdet_train(torch, det_cpu)
    return paths


# the training paths' routes where a kernel's bf16 route is named for its
# design
ROUTES_BF16 = {"roi_align_bwd_fmap": "bf16-mma",
               "vgg_conv1_bwd": "bf16-mma"}
BWD_META = {  # kernel row: (source, the TPU kernel whose gradient it is)
    "roi_align_bwd_fmap": ("sgg_torch/csrc/roi_align_bwd.cu",
                           "sgg_tpu/ops/roi_align_pallas.py:196"),
    "roi_align_bwd_boxes": ("sgg_torch/csrc/roi_align_bwd.cu",
                            "sgg_tpu/ops/roi_align_pallas.py:169"),
    "vgg_conv1_bwd": ("sgg_torch/csrc/vgg_stem_bwd.cu",
                      "sgg_tpu/ops/vgg_stem_pallas.py:68")}


def _groups(named):
    """Parameter names by detector part."""
    out = {}
    for n in named:
        out.setdefault(n.split(".")[0] if n.split(".")[0] in (
            "trunk", "rpn", "box_head") else "heads", []).append(n)
    return out


def pretrain_run(torch, splits, ckdir):
    """8a: ``pretrain`` at full width, counted: every kernel once a step on
    its bf16 route, finite losses, every parameter moved."""
    from sgg_torch.models.detector import FasterRCNNVGG, init_detector_weights
    from sgg_torch.pretrain_detector import pretrain

    init = {n: p.detach().clone() for n, p in init_detector_weights(
        FasterRCNNVGG(151), 0).named_parameters()}
    det = FasterRCNNVGG(151).to_compute_dtype(torch.bfloat16)
    steps = PRETRAIN_EPOCHS * (PRETRAIN_IMAGES // PRETRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (det, state), n, routes = _counted(torch, lambda: pretrain(
        splits, num_epochs=PRETRAIN_EPOCHS, batch_size=PRETRAIN_BATCH,
        save_dir=ckdir, detector=det, steps_per_print=2, device="cuda"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = dict(det.named_parameters())
    moved = {g: sum(not torch.equal(params[k].detach().cpu(), init[k])
                    for k in names) for g, names in _groups(params).items()}
    sizes = {g: len(names) for g, names in _groups(params).items()}
    losses = [{k: round(v, 5) for k, v in h.items()} for h in state.history]
    print(f"phase 8 pretrain (FasterRCNNVGG(151), {CANVAS} px, batch "
          f"{PRETRAIN_BATCH}, {PRETRAIN_IMAGES} images, {PRETRAIN_EPOCHS} "
          f"epochs, bf16 over f32 masters): {state.step} steps in "
          f"{wall:.2f} s with set-up = "
          f"{state.step * PRETRAIN_BATCH / wall:.2f} images/s, the last "
          f"interval {PRETRAIN_BATCH / state.history[-1]['s_per_batch']:.2f}"
          f" images/s (host included); peak device "
          f"memory {peak:.2f} GiB; losses by interval {json.dumps(losses)}; "
          f"launches {json.dumps(n)} by route {json.dumps(routes)}; "
          f"parameters moved {json.dumps(moved)} of {json.dumps(sizes)}",
          flush=True)
    check(state.step == steps, f"{state.step} steps, want {steps}")
    check(all(math.isfinite(v) for h in state.history for v in h.values()),
          "non-finite pretraining losses")
    check(all(p.dtype == torch.float32 for p in params.values()),
          "master weights are not float32")
    check(moved == sizes, f"parameters that did not move: {moved} of "
                          f"{sizes}")
    # the trunk trains: autograd's chain, no conv epilogue
    once = {k: steps for k in n if k != "conv_epilogue"}
    want = {k: {ROUTES_BF16.get(k, "bf16"): steps} for k in once}
    check(n == {**once, "conv_epilogue": 0}
          and routes == {**want, "conv_epilogue": {}},
          f"pretraining launched {n} by route {routes}; want every kernel "
          f"but the conv epilogue once a step, on the routes {want}")
    return det, n


def _det_ap(dets):
    """``DetectionEvaluator`` over a CLI run's per-image detections and GT
    (``val_epoch``'s ``_detections``): (AP, images, detections)."""
    from sgg_torch.eval.det_eval import DetectionEvaluator
    ev = DetectionEvaluator(151)
    n_img = n_det = 0
    for v in dets.values():
        for i in range(len(v["boxes"])):
            ev.add_image(v["boxes"][i], v["labels"][i], v["scores"][i],
                         v["gt_boxes"][i], v["gt_classes"][i])
            n_img += 1
            n_det += len(v["boxes"][i])
    ap = ev.results()
    check(set(ap) == {"mAP", "AP50", "AP75"}
          and all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in ap.values()),
          f"DetectionEvaluator results {ap}")
    return ap, n_img, n_det


def pretrain_eval(torch, ckdir):
    """8b: the last payload, unmodified, loads strictly into the CLI's
    detector; then ``python -m sgg_torch.main -m sgdet -nepoch 0 -ckpt``
    evaluates that directory, counted. After 8 steps from random weights
    the detector may score no class above the 0.01 retry floor on any
    image: the CLI then stops with "evaluated zero images" (as the JAX
    driver does), which this phase reads as zero detections; otherwise
    ``DetectionEvaluator`` reads the detections."""
    from sgg_torch import main as cli
    from sgg_torch.models.detector import FasterRCNNVGG
    from sgg_torch.train.checkpoint import load_detector, load_detector_state

    payload, epoch = load_detector(ckdir)
    check(epoch == PRETRAIN_EPOCHS - 1 and int(payload["step"])
          == PRETRAIN_EPOCHS * (PRETRAIN_IMAGES // PRETRAIN_BATCH),
          f"latest payload is epoch {epoch}, step {int(payload['step'])}")
    load_detector_state(FasterRCNNVGG(151), payload)  # strict, as the CLI
    del payload
    argv = ["-m", "sgdet", "-nepoch", "0", "-ckpt", ckdir, "-split",
            "synthetic", "-val_size", "16", "-nwork", "4"]

    def evaluate():
        try:
            return cli.main(argv)
        except RuntimeError as e:
            if "evaluated zero images" not in str(e):
                raise
            return None

    t0 = time.perf_counter()
    res, n, routes = _counted(torch, evaluate)
    wall = time.perf_counter() - t0
    if res is None:
        what = ("the CLI stopped at a split that evaluated zero images (no "
                "class above the 0.01 retry floor)")
    else:
        ap, n_img, n_det = _det_ap(res["_detections"])
        what = (f"{n_img} images, {n_det} detections; DetectionEvaluator "
                f"{json.dumps(ap)}")
    print(f"phase 8 sgdet eval of the unmodified epoch-{epoch} payload "
          f"(main -m sgdet -nepoch 0 -ckpt): {what} in {wall:.1f} s; "
          f"launches {json.dumps(n)} by route {json.dumps(routes)}",
          flush=True)
    check(n["roi_align"] > 0 and n["vgg_conv1"] > 0
          and all(n[k] == 0 for k in NO_BACKWARD),
          f"sgdet eval launched {n}")
    return n


def pretrain_step_profile(torch, det, splits):
    """8c: one train step under ``set_sync_debug_mode("error")``, whole
    steps by the host clock, a step by stage with CUDA events, the
    profiler's kernels and the peak memory; returns the map and the
    proposals of the step's batch."""
    from torch.profiler import ProfilerActivity, profile

    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.models.detector import (balanced_draws, roi_head_losses,
                                           rpn_losses)
    from sgg_torch.pretrain_detector import (DetectorOptimizer,
                                             make_detector_train_step)

    batch = next(iter(BatchLoader(splits["train"], batch_size=PRETRAIN_BATCH,
                                  max_nodes=64, max_edges=1,
                                  seed=0))).to("cuda")
    # a small rate: the timed steps barely move the pretrained weights
    opt = DetectorOptimizer(det, lambda count: 5e-6)
    step = make_detector_train_step(det, opt)
    gen = torch.Generator(device="cuda").manual_seed(3)
    step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms.sort()
    names = ("trunk_forward", "heads_forward", "losses", "backward",
             "optimizer")
    totals = dict.fromkeys(names, 0.0)
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    for it in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        opt.zero_grad()
        ev[0].record()
        fmap = det.trunk(batch.images)
        ev[1].record()
        out = det(None, batch.im_hw, fmap=fmap, gt_boxes=batch.boxes,
                  gt_mask=batch.node_mask)
        ev[2].record()
        losses = rpn_losses(
            balanced_draws(gen, out["rpn_obj_logits"].shape, "cuda"),
            out["anchors"], out["rpn_obj_logits"], out["rpn_deltas"],
            batch.boxes, batch.node_mask)
        losses.update(roi_head_losses(
            balanced_draws(gen, out["prop_mask"].shape, "cuda"),
            out["proposals"], out["prop_mask"], out["class_logits"],
            out["box_deltas"], batch.boxes, batch.classes, batch.node_mask))
        total = sum(losses.values())
        ev[3].record()
        total.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        torch.cuda.synchronize()
        if it:
            for i, k in enumerate(names):
                totals[k] += ev[i].elapsed_time(ev[i + 1]) / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, gen)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    print(f"phase 8 pretrain step (batch {PRETRAIN_BATCH}, {CANVAS} px, "
          f"bf16) on a batch on the card: {step_ms[2]:.3f} ms median of 5 "
          f"(min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}); by stage "
          + json.dumps({k: round(v, 3) for k, v in totals.items()})
          + f" ms; peak device memory {peak:.2f} GiB; no host sync under "
          f"set_sync_debug_mode('error'); kernels "
          + (f"{sum(per_kernel.values()):.3f} ms busy, top "
             + json.dumps({k[:80]: round(v, 4) for k, v in top})
             if per_kernel else "not measured (no device events)"),
          flush=True)
    with torch.no_grad():
        fmap = det.trunk(batch.images)
        props = det(None, batch.im_hw, fmap=fmap, gt_boxes=batch.boxes,
                    gt_mask=batch.node_mask)["proposals"]
    return fmap, props.contiguous()


def _tap_counts(torch, boxes, H, W, scale=1 / 16):
    """Per ROI and bin, the folded taps of each axis (the nonzero entries
    of the plain version's weights), and per ROI the samples with a
    weight derivative, for the backward kernels' operation counts."""
    from sgg_torch.ops import roi_align as K1
    b = boxes.float().cpu()
    x1, y1, roi_w, roi_h = K1._box_frames(b, scale)
    ny = (K1._interp_weights(y1, roi_h, H, 7, 2) != 0).sum(-1).double()
    nx = (K1._interp_weights(x1, roi_w, W, 7, 2) != 0).sum(-1).double()
    dy = (K1._axis_samples(y1, roi_h, H, 7, 2)[2] != 0).sum(-1).double()
    dx = (K1._axis_samples(x1, roi_w, W, 7, 2)[2] != 0).sum(-1).double()
    return ny, nx, dy, dx


def _footprints(torch, boxes, H, W):
    """Per ROI the map cells its samples' taps span (rows x columns of
    the lo .. hi rectangle): the most that staging a ROI's map in shared
    memory would read once."""
    from sgg_torch.ops import roi_align as K1
    x1, y1, roi_w, roi_h = K1._box_frames(boxes.float().cpu(), 1 / 16)
    spans = []
    for start, extent, dim in ((y1, roi_h, H), (x1, roi_w, W)):
        lo, hi = K1._axis_samples(start, extent, dim, 7, 2)[:2]
        spans.append(hi.max(-1).values - lo.min(-1).values + 1)
    return (spans[0] * spans[1]).double()


def fmap_tiles(torch, K1, g16, props, fmap_shape, scale):
    """K1-bwd-fmap's tile lists on the card, held equal to the CPU model;
    returns (ROIs a tile, mean and max; the busiest tile's image and
    ROIs)."""
    B, H, W, _ = fmap_shape
    R = props.shape[1]
    layout = K1.fmap_workspace_layout(B, H, W, R)
    ws = torch.empty(-(-layout["bytes"] // 4), dtype=torch.int32,
                     device=g16.device)
    K1._grad_fmap_kernel(g16, props, fmap_shape, torch.bfloat16, scale, 7, 2,
                         workspace=ws)
    lists = K1.fmap_tile_lists(ws, layout, B, R)
    check(lists == K1.roi_tile_lists(props, (H, W), spatial_scale=scale),
          f"roi_align_bwd_fmap: the kernel's tile lists at {fmap_shape} "
          f"differ from roi_tile_lists")
    counts = [(len(lst), b, lst) for b, per_b in enumerate(lists)
              for lst in per_b]
    busiest = max(counts, key=lambda t: t[0])
    return (sum(n for n, _, _ in counts) / len(counts), busiest[0],
            busiest[1:])


def fmap_fpn_level(torch, K1, peaks, props, g_):
    """8d: K1-bwd-fmap at the FPN stride-4 level's shape (3 x 148 x 148 x
    256, the same proposals at scale 1/4): within its limit of the plain
    version, its lists the model's, its time beside its bound."""
    B, R = props.shape[:2]
    H = CANVAS // 4
    C = 256
    g16 = torch.randn(B, R, 7, 7, C, generator=g_).cuda().bfloat16()
    want = K1.roi_align_backward_reference(g16, props, (H, H), torch.float32,
                                           spatial_scale=0.25)
    got = K1._grad_fmap_kernel(g16, props, (B, H, H, C), torch.bfloat16,
                               0.25, 7, 2)
    torch.cuda.synchronize()
    rel = rel_err(torch, got, want)
    del want, got
    check(rel <= 1e-2, f"roi_align_bwd_fmap at the FPN level: bf16 rel err "
                       f"{rel}")
    mean, most, _ = fmap_tiles(torch, K1, g16, props, (B, H, H, C), 0.25)
    ny, nx, _, _ = _tap_counts(torch, props, H, H, scale=0.25)
    ops = 2 * C * float((ny.sum(-1) * nx.sum(-1)).sum())
    n_bytes = g16.numel() * 2 + props.numel() * 4 + B * H * H * C * 2
    bms, bby = bound_ms(n_bytes, ops, peaks, bf16=False)
    ms = time_ms(lambda: K1._grad_fmap_kernel(
        g16, props, (B, H, H, C), torch.bfloat16, 0.25, 7, 2))
    print(f"phase 8 roi_align_bwd_fmap at the FPN stride-4 level's shape (g "
          f"{B}x{R}x7x7x{C} over {B}x{H}x{H}x{C} bf16, the step's proposals "
          f"at scale 1/4): {ms:.4f} ms, bound {bms:.4f} ms ({bby}), "
          f"{ms / bms:.2f}x the bound; bf16 rel err {rel:.3g}; ROIs a tile "
          f"mean {mean:.1f}, max {most}", flush=True)


def pretrain_kernels(torch, peaks, fmap16, props):
    """8d: K1-bwd-fmap and K1-bwd-boxes at the pretraining shape (the
    step's proposal slots over a 3 x 37 x 37 x 512 map) and K2-bwd at 3 x
    592 x 592, each against its plain version on the same inputs (f32 and
    bf16), timed on the bf16 route (K1-bwd-fmap's "bf16-mma", K2-bwd's
    "bf16-mma") beside its bound; each launched twice on the same inputs
    must give the same bits; K1-bwd-fmap's tile lists equal to the CPU
    model, its ROIs a tile beside the proposals' footprints in map cells,
    the busiest tile's ROIs timed alone; K1-bwd-fmap at the FPN stride-4
    level's shape."""
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    B, H, W, C = fmap16.shape
    R = props.shape[1]
    g_ = torch.Generator().manual_seed(9)
    fmap32 = torch.randn(B, H, W, C, generator=g_).cuda()
    g32 = torch.randn(B, R, 7, 7, C, generator=g_).cuda()
    rows = {}
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        f, g = fmap32.to(dtype), g32.to(dtype)
        want_f = K1.roi_align_backward_reference(
            g, props, (H, W), dtype, spatial_scale=1 / 16)
        got_f = K1._grad_fmap_kernel(g, props, (B, H, W, C), dtype,
                                     1 / 16, 7, 2)
        want_b = K1.roi_align_boxes_grad_reference(g, f, props,
                                                   spatial_scale=1 / 16)
        got_b = K1._grad_boxes_kernel(g, f, props, 1 / 16, 7, 2)
        torch.cuda.synchronize()
        errs[dtype] = {
            "fmap": (float((got_f.float() - want_f.float()).abs().max()),
                     rel_err(torch, got_f, want_f.float())),
            "boxes": (float((got_b - want_b).abs().max()),
                      rel_err(torch, got_b, want_b))}
        del want_f, got_f
    for name, tol in (("fmap", (1e-5, 1e-2)), ("boxes", (1e-4, 1e-4))):
        rel32, rel16 = errs[torch.float32][name][1], \
            errs[torch.bfloat16][name][1]
        check(rel32 <= tol[0] and rel16 <= tol[1],
              f"roi_align_bwd_{name}: rel err f32 {rel32}, bf16 {rel16}")
    f16, g16 = fmap32.bfloat16(), g32.bfloat16()
    for f, g in ((fmap32, g32), (f16, g16)):
        twice = [(K1._grad_fmap_kernel(g, props, (B, H, W, C), g.dtype,
                                       1 / 16, 7, 2),
                  K1._grad_boxes_kernel(g, f, props, 1 / 16, 7, 2))
                 for _ in range(2)]
        torch.cuda.synchronize()
        for i, name in enumerate(("fmap", "boxes")):
            check(torch.equal(twice[0][i], twice[1][i]),
                  f"roi_align_bwd_{name} ({f.dtype}): two launches on the "
                  f"same inputs differ")
    del twice
    foot = _footprints(torch, props, H, W)
    mean, most, (bi, busiest) = fmap_tiles(torch, K1, g16, props,
                                           (B, H, W, C), 1 / 16)
    print(f"phase 8 roi_align_bwd_fmap and roi_align_bwd_boxes: the same "
          f"bits from two launches (f32, bf16); the {R} proposal slots' "
          f"footprints: mean {float(foot.mean()):.1f}, max "
          f"{float(foot.max()):.0f} map cells a ROI "
          f"({float(foot.mean()) * C * 2 / 1024:.1f} KiB in bf16 at C={C}), "
          f"against the {7 * 7 * 16} cell slots K1-bwd-boxes reads a ROI; "
          f"K1-bwd-fmap's tile lists equal to the model's, ROIs a tile of "
          f"{K1.FMAP_TILE[0]}x{K1.FMAP_TILE[1]} cells: mean {mean:.1f}, max "
          f"{most}", flush=True)
    fmap_fpn_level(torch, K1, peaks, props, g_)
    ny, nx, dy, dx = _tap_counts(torch, props, H, W)
    n_boxes = props.numel() * 4
    fmap_ops = 2 * C * float((ny.sum(-1) * nx.sum(-1)).sum())
    boxes_ops = 3 * C * float((dy * nx.sum(-1) + dx * ny.sum(-1)).sum())
    for name, fn, plain, n_bytes, ops in (
            ("roi_align_bwd_fmap",
             lambda: K1._grad_fmap_kernel(g16, props, (B, H, W, C),
                                          torch.bfloat16, 1 / 16, 7, 2),
             lambda: K1.roi_align_backward_reference(
                 g16, props, (H, W), torch.bfloat16, spatial_scale=1 / 16),
             g16.numel() * 2 + n_boxes + f16.numel() * 2, fmap_ops),
            ("roi_align_bwd_boxes",
             lambda: K1._grad_boxes_kernel(g16, f16, props, 1 / 16, 7, 2),
             lambda: K1.roi_align_boxes_grad_reference(
                 g16, f16, props, spatial_scale=1 / 16),
             g16.numel() * 2 + f16.numel() * 2 + 2 * n_boxes, boxes_ops)):
        bms, bby = bound_ms(n_bytes, ops, peaks, bf16=False)
        key = name.split("_")[-1]
        rows[name] = dict(
            **({"kernel_route": ROUTES_BF16[name]} if name in ROUTES_BF16
               else {}),
            max_abs_err=errs[torch.float32][key][0],
            bf16_rel_err=errs[torch.bfloat16][key][1],
            f32_rel_err=errs[torch.float32][key][1],
            ms=time_ms(fn), plain_ms=time_ms(plain, iters=3, warmup=1),
            bound_ms=bms, bound_by=bby, library_ms=None, bytes=n_bytes,
            flops=ops, shape=f"g {B}x{R}x7x7x{C}, fmap {B}x{H}x{W}x{C} "
                             f"bf16, the step's {R} proposal slots")
    # the busiest tile's ROIs alone: its blocks' work, with the little the
    # same ROIs add to other tiles
    sub = torch.tensor(busiest, device=props.device)
    p_sub = props[bi:bi + 1, sub].contiguous()
    g_sub = g16[bi:bi + 1, sub].contiguous()
    ms_sub = time_ms(lambda: K1._grad_fmap_kernel(
        g_sub, p_sub, (1, H, W, C), torch.bfloat16, 1 / 16, 7, 2))
    print(f"phase 8 roi_align_bwd_fmap: the busiest tile's {len(busiest)} "
          f"ROIs alone take {ms_sub:.4f} ms, "
          f"{ms_sub / rows['roi_align_bwd_fmap']['ms']:.2f} of the kernel's "
          f"time at the pretraining shape", flush=True)
    del fmap32, g32, f16, g16, g_sub
    torch.cuda.empty_cache()

    x32 = torch.randn(B, CANVAS, CANVAS, 3, generator=g_).cuda()
    w = (torch.randn(3, 3, 3, 64, generator=g_) * math.sqrt(2 / 27)).cuda()
    bias = (torch.randn(64, generator=g_) * 0.1).cuda()
    gg32 = torch.randn(B, CANVAS, CANVAS, 64, generator=g_).cuda()
    k2 = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        out = K2.vgg_conv1(x, w, bias)
        g = gg32.to(dtype)
        ww, wb = K2.vgg_conv1_backward_reference(x, out, g)
        gw, gb = K2._backward_kernel(x, out, g)
        torch.cuda.synchronize()
        k2[dtype] = (max(float((gw - ww).abs().max()),
                         float((gb - wb).abs().max())),
                     max(rel_err(torch, gw, ww), rel_err(torch, gb, wb)))
    check(k2[torch.float32][1] <= 1e-5 and k2[torch.bfloat16][1] <= 1e-5,
          f"vgg_conv1_bwd rel err {k2}")
    K2.KERNEL_BWD.reset_counts()
    twice = [K2._backward_kernel(x, out, g) for _ in range(2)]
    torch.cuda.synchronize()
    k2_route = dict(K2.KERNEL_BWD.routes)
    check(k2_route == {"bf16-mma": 2}
          and all(torch.equal(a, b) for a, b in zip(*twice)),
          f"vgg_conv1_bwd: routes {k2_route}, two launches on the same "
          f"inputs equal: {[torch.equal(a, b) for a, b in zip(*twice)]}")
    del twice
    del gg32
    n_px = B * CANVAS * CANVAS
    bms, bby = bound_ms(x.numel() * 2 + 2 * n_px * 64 * 2 + 28 * 64 * 4,
                        n_px * 64 * 28 * 2, peaks, bf16=False)
    xc = x.permute(0, 3, 1, 2)  # NCHW views of channels-last memory
    gm = torch.where(out > 0, g, 0).permute(0, 3, 1, 2)
    wc = w.bfloat16().permute(3, 2, 0, 1).contiguous()
    rows["vgg_conv1_bwd"] = dict(
        kernel_route="bf16-mma",
        max_abs_err=k2[torch.float32][0], f32_rel_err=k2[torch.float32][1],
        bf16_rel_err=k2[torch.bfloat16][1],
        ms=time_ms(lambda: K2._backward_kernel(x, out, g)),
        plain_ms=time_ms(lambda: K2.vgg_conv1_backward_reference(x, out, g),
                         iters=3, warmup=1),
        bound_ms=bms, bound_by=bby,
        # cuDNN's weight and bias gradient of the masked output gradient
        library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
            gm, xc, wc, [64], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, True])),
        bytes=x.numel() * 2 + 2 * n_px * 64 * 2, flops=n_px * 64 * 28 * 2,
        shape=f"bf16 {B}x{CANVAS}x{CANVAS}x3 images, {B}x{CANVAS}x{CANVAS}"
              f"x64 output and its gradient")
    del x, x32, out, g, gm, xc
    torch.cuda.empty_cache()
    for name, m in rows.items():
        route = f" on {m['kernel_route']}" if "kernel_route" in m else ""
        print(f"phase 8 {name}: {m['ms']:.4f} ms{route}, bound "
              f"{m['bound_ms']:.4f} "
              f"ms ({m['bound_by']}), plain {m['plain_ms']:.4f} ms, library "
              f"{m['library_ms']} ms; max|err| f32 {m['max_abs_err']:.3g} "
              f"(rel {m['f32_rel_err']:.3g}), bf16 rel "
              f"{m['bf16_rel_err']:.3g} [{m['shape']}]", flush=True)
    return rows


def _part_err(torch, got, want, parts):
    """Relative error in norm of each part's tensors."""
    out = {}
    for g, names in parts.items():
        num = sum(float((got[n] - want[n]).square().sum()) for n in names)
        den = sum(float(want[n].square().sum()) for n in names)
        out[g] = math.sqrt(num / max(den, 1e-30))
    return out


def _tap_flips(torch, a, b, mask, H, W):
    """RoIAlign samples (7 x 7 bins, ratio 2, the stride-16 map) whose low
    tap differs between two devices' proposals ``a`` and ``b`` (B, P, 4),
    over the valid slots where either sample has a weight derivative:
    there the box gradient takes another pair of map values."""
    from sgg_torch.ops import roi_align as K1
    fa = K1._box_frames(a.float().cpu(), 1 / 16)
    fb = K1._box_frames(b.float().cpu(), 1 / 16)
    n = 0
    for start, extent, dim in ((0, 2, W), (1, 3, H)):
        la, _, da, *_ = K1._axis_samples(fa[start], fa[extent], dim, 7, 2)
        lb, _, db, *_ = K1._axis_samples(fb[start], fb[extent], dim, 7, 2)
        n += int(((la != lb) & ((da != 0) | (db != 0))
                  & mask.cpu()[..., None]).sum())
    return n


def _trunk_routes(torch, trunk, images):
    """The f32 trunk's forward as ``VGG16Trunk`` runs it, keeping each
    ReLU's signs and each 2x2 max-pool's picks (where the window's maximum
    is positive: a window of zeros passes no gradient)."""
    import torch.nn.functional as F

    from sgg_torch.models.backbone import VGG16_CFG, normalize_images
    from sgg_torch.ops.vgg_stem import vgg_conv1
    with torch.no_grad():
        stem = trunk.conv[0]
        x = vgg_conv1(normalize_images(images).float().contiguous(),
                      stem.weight.permute(2, 3, 1, 0), stem.bias)
        x = x.permute(0, 3, 1, 2)
        signs, picks, i = [(x > 0).cpu()], [], 1
        for v in VGG16_CFG[1:]:
            if v == "M":
                x, idx = F.max_pool2d(x, 2, 2, return_indices=True)
                picks.append(torch.where(x > 0, idx, -1).cpu())
            else:
                conv = trunk.conv[i]
                x = F.conv2d(x, conv.weight, conv.bias, padding=1)
                signs.append((x > 0).cpu())
                x = F.relu(x)
                i += 1
    return signs, picks


def pretrain_card_vs_cpu(torch, splits):
    """8e: one f32 train step at full width, 2 images, on the card and on
    the CPU from the same weights, on the card's proposal slots and the
    same sampler draws: the losses, each part's gradient (``p.grad``, no
    weight decay) and the updated parameters. The gradient limit is
    calibrated by a fault: the same step on the card with RoIAlign's boxes
    detached (no box gradient through K1) must exceed it. Then where the
    sound gap comes from: both devices' heads on the card's feature map,
    both trunks' backward from the card's map gradient, and the max-pool
    picks, ReLU signs and RoIAlign sample taps that differ between the
    devices."""
    import copy

    import sgg_torch.models.detector as D
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.models.detector import (FasterRCNNVGG, balanced_draws,
                                           init_detector_weights)
    from sgg_torch.pretrain_detector import (DetectorOptimizer,
                                             detector_losses)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    init = init_detector_weights(FasterRCNNVGG(151), 1)
    p0 = {n: p.detach().clone() for n, p in init.named_parameters()}
    parts = _groups(p0)
    batch = next(iter(BatchLoader(splits["train"], batch_size=2,
                                  max_nodes=64, max_edges=1,
                                  shuffle=False)))
    batches = {"cuda": batch.to("cuda"), "cpu": batch.to("cpu")}
    card = copy.deepcopy(init).cuda()
    with torch.no_grad():
        out = card(batches["cuda"].images, batches["cuda"].im_hw,
                   gt_boxes=batches["cuda"].boxes,
                   gt_mask=batches["cuda"].node_mask)
    index = (out["proposal_index"], out["rpn_prop_mask"])
    fmap = out["fmap"]  # the card's, from the initial weights
    gen = torch.Generator().manual_seed(4)
    draws = {"rpn": balanced_draws(gen, out["rpn_obj_logits"].shape, "cpu"),
             "roi": balanced_draws(gen, out["prop_mask"].shape, "cpu")}
    del out
    H, W = fmap.shape[1:3]

    def run(det, d, update=True):
        """Losses, proposals, prop_mask and gradients of one step on
        ``d``; with ``update`` the optimizer steps too."""
        opt = DetectorOptimizer(det, lambda count: LR_CHECK)
        opt.zero_grad()
        losses, o = detector_losses(
            det, batches[d],
            draws={k: tuple(u.to(d) for u in v) for k, v in draws.items()},
            proposal_index=tuple(t.to(d) for t in index))
        sum(losses.values()).backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().cpu().clone() for n, p in det.named_parameters()}
        if update:
            opt.step()
        if d == "cuda":
            torch.cuda.synchronize()
        return ({k: v.detach().cpu() for k, v in losses.items()},
                o["proposals"].detach().cpu(), o["prop_mask"].cpu(), grads)

    cpu = copy.deepcopy(init)
    t0 = time.perf_counter()
    sound = {"card": run(card, "cuda")}
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    sound["cpu"] = run(cpu, "cpu")
    t_cpu = time.perf_counter() - t0
    loss_err = {k: float((sound["card"][0][k] - v).abs()
                         / v.abs().clamp(min=1e-12))
                for k, v in sound["cpu"][0].items()}
    g_card, g_cpu = sound["card"][3], sound["cpu"][3]
    grad_err = _part_err(torch, g_card, g_cpu, parts)
    worst = max((float((g_card[n] - g_cpu[n]).norm()
                       / g_cpu[n].norm().clamp(min=1e-30)), n)
                for n in g_cpu)
    # the updated parameters differ by no more than lr times the
    # gradients' difference, up to one rounding of each update's terms
    p_card = {n: p.detach().cpu() for n, p in card.named_parameters()}
    p_cpu = {n: p.detach() for n, p in cpu.named_parameters()}
    par_excess = 0.0
    for n, want in p_cpu.items():
        d = g_cpu[n] + 5e-4 * p0[n]
        slack = 2.0 ** -22 * (p0[n].abs() + LR_CHECK * d.abs()) + 1e-30
        par_excess = max(par_excess, float(
            (((p_card[n] - want).abs() - LR_CHECK * (g_card[n] - g_cpu[n])
              .abs()) / slack).max()))
    del card, cpu

    # the fault: RoIAlign's boxes detached on the card
    roi_align = D.roi_align
    D.roi_align = lambda f, boxes, **kw: roi_align(f, boxes.detach(), **kw)
    try:
        fault = run(copy.deepcopy(init).cuda(), "cuda", update=False)
    finally:
        D.roi_align = roi_align
    fault_err = _part_err(torch, fault[3], g_cpu, parts)

    # both devices' heads on the card's feature map
    class CardMap(torch.nn.Module):
        def __init__(self, leaf):
            super().__init__()
            self.leaf = leaf

        def forward(self, images):
            return self.leaf

    heads, gmap = {}, {}
    for d in ("cuda", "cpu"):
        det = copy.deepcopy(init).to(d)
        det.trunk = CardMap(fmap.to(d).clone().requires_grad_())
        heads[d] = run(det, d, update=False)
        gmap[d] = det.trunk.leaf.grad.detach()
        del det
    head_parts = {g: v for g, v in parts.items() if g != "trunk"}
    head_err = _part_err(torch, heads["cuda"][3], heads["cpu"][3],
                         head_parts)
    gmap_err = float((gmap["cuda"].cpu() - gmap["cpu"]).norm()
                     / gmap["cpu"].norm())
    # both trunks' backward from the card's map gradient
    trunk_g = {}
    for d in ("cuda", "cpu"):
        trunk = copy.deepcopy(init.trunk).to(d)
        trunk(batches[d].images).backward(gmap["cuda"].to(d))
        trunk_g[d] = {"trunk." + n: p.grad.detach().cpu()
                      for n, p in trunk.named_parameters()}
        del trunk
    trunk_err = _part_err(torch, trunk_g["cuda"], trunk_g["cpu"],
                          {"trunk": parts["trunk"]})["trunk"]
    routes = {d: _trunk_routes(torch, copy.deepcopy(init.trunk).to(d),
                               batches[d].images) for d in ("cuda", "cpu")}
    relu_flips = [int((a != b).sum()) for a, b in
                  zip(routes["cuda"][0], routes["cpu"][0])]
    pool_flips = [int((a != b).sum()) for a, b in
                  zip(routes["cuda"][1], routes["cpu"][1])]
    relu_units = sum(a.numel() for a in routes["cpu"][0])
    del routes
    taps = {"step": _tap_flips(torch, sound["card"][1], sound["cpu"][1],
                               sound["cpu"][2], H, W),
            "heads_on_card_map": _tap_flips(
                torch, heads["cuda"][1], heads["cpu"][1], heads["cpu"][2],
                H, W)}
    # the RoI head's labels (IoU >= 0.5) of both devices' proposals, and
    # its ReLUs on one input, the card's pooled features
    labels = [D.assign_targets(heads[d][1], batches["cpu"].boxes,
                               batches["cpu"].node_mask, 0.5, 0.5,
                               allow_low_quality=False)[0]
              for d in ("cuda", "cpu")]
    label_flips = int(((labels[0] != labels[1]) & heads["cpu"][2]).sum())
    with torch.no_grad():
        pooled = D.roi_align(fmap, heads["cuda"][1].cuda().contiguous(),
                             spatial_scale=1 / 16, pooled=7)
        pooled = pooled.reshape(*pooled.shape[:2], -1)
        signs = {}
        for d in ("cuda", "cpu"):
            fc6 = copy.deepcopy(init.box_head.fc6).to(d)
            fc7 = copy.deepcopy(init.box_head.fc7).to(d)
            h6 = fc6(pooled.to(d))
            signs[d] = ((h6 > 0).cpu(), (fc7(h6.relu()) > 0).cpu())
            del fc6, fc7, h6
        head_relu_flips = [int((a != b).sum())
                           for a, b in zip(signs["cuda"], signs["cpu"])]
        del pooled, signs
    torch.cuda.empty_cache()
    print(f"phase 8 pretrain step card vs CPU (f32, 2 images, full width, "
          f"the card's proposal slots and the same draws): losses rel err "
          f"{json.dumps(loss_err)}; gradients rel err in norm by part "
          f"{json.dumps(grad_err)} (worst tensor {worst[1]} "
          f"{worst[0]:.3g}; limit {GRAD_LIMIT:g}); the fault (RoIAlign's "
          f"boxes detached on the card) {json.dumps(fault_err)}; updated "
          f"parameters' difference beyond lr x the gradients' in roundings "
          f"{par_excess:.3g} (limit 1); card {t_card:.2f} s, CPU "
          f"{t_cpu:.2f} s", flush=True)
    print(f"phase 8 where the gap comes from: heads of both devices on the "
          f"card's map, gradients rel err in norm {json.dumps(head_err)}, "
          f"the map's gradient {gmap_err:.3g}; trunks' backward from the "
          f"card's map gradient {trunk_err:.3g}; samples on another tap "
          f"{json.dumps(taps)}; ReLU signs that differ by layer "
          f"{json.dumps(relu_flips)} of {relu_units}; max-pool picks that "
          f"differ by pool {json.dumps(pool_flips)}; RoI-head labels that "
          f"differ {label_flips}; box-head ReLU signs that differ on the "
          f"card's pooled features (fc6, fc7) {json.dumps(head_relu_flips)}"
          f" of {heads['cpu'][1].shape[0] * heads['cpu'][1].shape[1]} x "
          f"{init.box_head.fc6.out_features} each", flush=True)
    check(all(v <= 1e-5 for v in loss_err.values()),
          f"card vs CPU pretraining losses differ: {loss_err}")
    check(all(v <= GRAD_LIMIT for v in grad_err.values()),
          f"card vs CPU pretraining gradients differ: {grad_err}")
    check(fault_err["rpn"] > GRAD_LIMIT,
          f"the gradient check does not see RoIAlign's boxes detached: "
          f"{fault_err}")
    check(par_excess <= 1.0,
          f"card vs CPU updates differ beyond their gradients: "
          f"{par_excess}")


def phase_pretrain(torch, peaks, rows):
    """Phase 8: detector pretraining at full width."""
    import shutil
    import tempfile

    from sgg_torch.data.synthetic import synthetic_splits

    splits = synthetic_splits(num_train=PRETRAIN_IMAGES, num_eval=4)
    ckdir = tempfile.mkdtemp(prefix="sgg_pretrain_")
    paths = {}
    try:
        det, paths["pretrain"] = pretrain_run(torch, splits, ckdir)
        paths["pretrain_sgdet_eval"] = pretrain_eval(torch, ckdir)
    finally:
        shutil.rmtree(ckdir)
    fmap, props = pretrain_step_profile(torch, det, splits)
    del det
    torch.cuda.empty_cache()
    for name, row in pretrain_kernels(torch, peaks, fmap, props).items():
        source, replaces = BWD_META[name]
        rows[name] = dict(name=name, route="cuda", source=source,
                          replaces=replaces, **row)
    del fmap, props
    torch.cuda.empty_cache()
    pretrain_card_vs_cpu(torch, splits)
    return paths


# ---------------------------------------------------------------------------
# phase 9: ResNet50-FPN (relation model, SGDet, detector pretraining) and
# edge_model="raw_boxes"

# FPN pretraining: batch 3 (the reference's VG batch), 18 images, 2 epochs
# (12 steps); the card-vs-CPU step's gradients, relative in norm by part,
# are held at FPN_GRAD_LIMIT, which both faults exceed
FPN_IMAGES, FPN_EPOCHS = 18, 2
FPN_DEADLINE_S = 480
FPN_GRAD_LIMIT = 2e-3
FPN_LEVELS = (("p2", 4), ("p3", 8), ("p4", 16), ("p5", 32))
# a step's launches of each kernel on the FPN paths: multiscale_roi_align
# pools P2-P5 (4 K1 launches) and its backward takes both gradients there
FPN_STEP = {"roi_align": 4, "roi_align_bwd_fmap": 4,
            "roi_align_bwd_boxes": 4, "vgg_conv1": 0, "vgg_conv1_bwd": 0,
            "conv_epilogue": 0}
FPN_ROUTES = {"roi_align": "bf16", "roi_align_bwd_fmap": "bf16-mma",
              "roi_align_bwd_boxes": "bf16"}


def _fpn_groups(named):
    """Parameter names of the FPN detector by part."""
    out = {}
    for n in named:
        head = n.split(".")[0]
        part = (n.split(".")[1] if head == "backbone"
                else head if head in ("rpn", "box_head") else "classifier")
        out.setdefault(part, []).append(n)
    return out


def fpn_pretrain_run(torch, splits, ckdir):
    """9a: ``pretrain`` with its default detector, the ResNet50-FPN one, at
    full width, counted: K1 and both backward kernels 4 times a step on
    their bf16 routes, K2 never; finite losses; every parameter moved
    (the BatchNorms' scales and biases among them), their statistics
    not."""
    from sgg_torch.models.detector import FasterRCNNFPN, init_detector_weights
    from sgg_torch.pretrain_detector import pretrain

    init_det = init_detector_weights(FasterRCNNFPN(151), 0)
    init = {n: p.detach().clone() for n, p in init_det.named_parameters()}
    stats0 = {n: b.clone() for n, b in init_det.named_buffers()}
    del init_det
    steps = FPN_EPOCHS * (FPN_IMAGES // PRETRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (det, state), n, routes = _counted(torch, lambda: pretrain(
        splits, num_epochs=FPN_EPOCHS, batch_size=PRETRAIN_BATCH,
        save_dir=ckdir, steps_per_print=2, device="cuda"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = dict(det.named_parameters())
    groups = _fpn_groups(params)
    moved = {g: sum(not torch.equal(params[k].detach().cpu(), init[k])
                    for k in names) for g, names in groups.items()}
    sizes = {g: len(names) for g, names in groups.items()}
    stats_kept = all(torch.equal(b.cpu(), stats0[k])
                     for k, b in det.named_buffers())
    losses = [{k: round(v, 5) for k, v in h.items()} for h in state.history]
    print(f"phase 9 FPN pretrain (pretrain(detector=None) = "
          f"FasterRCNNFPN(151), {CANVAS} px, batch {PRETRAIN_BATCH}, "
          f"{FPN_IMAGES} images, {FPN_EPOCHS} epochs, bf16 over f32 "
          f"masters): {state.step} steps in {wall:.2f} s with set-up = "
          f"{state.step * PRETRAIN_BATCH / wall:.2f} images/s, the last "
          f"interval {PRETRAIN_BATCH / state.history[-1]['s_per_batch']:.2f}"
          f" images/s (host included); peak device memory {peak:.2f} GiB; "
          f"losses by interval {json.dumps(losses)}; launches "
          f"{json.dumps(n)} by route {json.dumps(routes)}; parameters "
          f"moved {json.dumps(moved)} of {json.dumps(sizes)}; BatchNorm "
          f"statistics unchanged: {stats_kept}", flush=True)
    check(type(det).__name__ == "FasterRCNNFPN", f"pretrained {type(det)}")
    check(state.step == steps, f"{state.step} steps, want {steps}")
    check(all(math.isfinite(v) for h in state.history for v in h.values()),
          "non-finite FPN pretraining losses")
    check(all(p.dtype == torch.float32 for p in params.values()),
          "master weights are not float32")
    check(moved == sizes, f"parameters that did not move: {moved} of "
                          f"{sizes}")
    check(stats_kept, "FPN pretraining changed BatchNorm statistics")
    want = {k: steps * v for k, v in FPN_STEP.items()}
    want_routes = {k: ({FPN_ROUTES[k]: want[k]} if want[k] else {})
                   for k in want}
    check(n == want and routes == want_routes,
          f"FPN pretraining launched {n} by route {routes}; want {want} by "
          f"route {want_routes}")
    return det, n


def fpn_step_profile(torch, det, splits):
    """9b: one FPN pretraining step under ``set_sync_debug_mode("error")``,
    whole steps by the host clock, a step by stage with CUDA events, the
    profiler's kernels and the peak memory; returns the step's pyramid and
    proposals."""
    from torch.profiler import ProfilerActivity, profile

    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.models.detector import (balanced_draws, roi_head_losses,
                                           rpn_losses)
    from sgg_torch.pretrain_detector import (DetectorOptimizer,
                                             make_detector_train_step)

    batch = next(iter(BatchLoader(splits["train"], batch_size=PRETRAIN_BATCH,
                                  max_nodes=64, max_edges=1,
                                  seed=0))).to("cuda")
    opt = DetectorOptimizer(det, lambda count: 5e-6)
    step = make_detector_train_step(det, opt)
    gen = torch.Generator(device="cuda").manual_seed(3)
    step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms.sort()
    names = ("backbone_forward", "heads_forward", "losses", "backward",
             "optimizer")
    totals = dict.fromkeys(names, 0.0)
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    for it in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        opt.zero_grad()
        ev[0].record()
        pyramid = det.backbone(batch.images)
        ev[1].record()
        out = det(None, batch.im_hw, pyramid=pyramid, gt_boxes=batch.boxes,
                  gt_mask=batch.node_mask)
        ev[2].record()
        losses = rpn_losses(
            balanced_draws(gen, out["rpn_obj_logits"].shape, "cuda"),
            out["anchors"], out["rpn_obj_logits"], out["rpn_deltas"],
            batch.boxes, batch.node_mask)
        losses.update(roi_head_losses(
            balanced_draws(gen, out["prop_mask"].shape, "cuda"),
            out["proposals"], out["prop_mask"], out["class_logits"],
            out["box_deltas"], batch.boxes, batch.classes, batch.node_mask))
        total = sum(losses.values())
        ev[3].record()
        total.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        torch.cuda.synchronize()
        if it:
            for i, k in enumerate(names):
                totals[k] += ev[i].elapsed_time(ev[i + 1]) / iters
    peak = torch.cuda.max_memory_allocated() / 2**30
    del out, losses, total, pyramid
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch, gen)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    med = step_ms[len(step_ms) // 2]
    print(f"phase 9 FPN pretrain step (batch {PRETRAIN_BATCH}, {CANVAS} px, "
          f"bf16) on a batch on the card: {med:.3f} ms median of 5 (min "
          f"{step_ms[0]:.3f}, max {step_ms[-1]:.3f}) = "
          f"{PRETRAIN_BATCH * 1e3 / med:.2f} images/s; by stage "
          + json.dumps({k: round(v, 3) for k, v in totals.items()})
          + f" ms; peak device memory {peak:.2f} GiB; no host sync under "
          f"set_sync_debug_mode('error'); kernels "
          + (f"{sum(per_kernel.values()):.3f} ms busy, top "
             + json.dumps({k[:80]: round(v, 4) for k, v in top})
             if per_kernel else "not measured (no device events)"),
          flush=True)
    with torch.no_grad():
        pyramid = det.backbone(batch.images)
        props = det(None, batch.im_hw, pyramid=pyramid, gt_boxes=batch.boxes,
                    gt_mask=batch.node_mask)["proposals"]
    return pyramid, props.contiguous()


def fpn_kernels(torch, peaks, pyramid, props):
    """9c: K1, K1-bwd-fmap and K1-bwd-boxes at each of P2-P5's shapes (the
    step's 512 proposal slots an image, C = 256) as
    ``multiscale_roi_align`` calls them, the gradient's rows zero outside
    the level's own ROIs; and K1 on the relation head's stride-64 ``pool``
    level at the sgcls training shape (batch 24, 10 x 10 x 256, nodes R=40
    + unions R=256). Each against its plain version (f32 and bf16, the
    limits of phases 3 and 8), both backward kernels twice for the same
    bits, times on the bf16 routes beside the bounds (the backward kernels'
    operations counted over the level's own ROIs, the only ones whose
    gradient is not zero)."""
    from sgg_torch.models.resnet import roi_level_assignment
    from sgg_torch.ops import roi_align as K1
    g_ = torch.Generator().manual_seed(11)
    B, R = props.shape[:2]
    C = pyramid["p2"].shape[-1]
    levels = roi_level_assignment(props)
    out = {"roi_align": {}, "roi_align_bwd_fmap": {},
           "roi_align_bwd_boxes": {}}
    n_boxes = props.numel() * 4
    for lvl, (name, stride) in enumerate(FPN_LEVELS):
        f16 = pyramid[name].contiguous()
        H, W = f16.shape[1:3]
        scale = 1.0 / stride
        sel = levels == lvl
        f32 = torch.randn(B, H, W, C, generator=g_).cuda()
        g32 = torch.randn(B, R, 7, 7, C, generator=g_).cuda() \
            * sel[..., None, None, None]
        want = K1.roi_align_reference(f32, props, spatial_scale=scale)
        err = float((K1.roi_align(f32, props, spatial_scale=scale)
                     - want).abs().max())
        rel = rel_err(torch, K1.roi_align(f32.bfloat16(), props,
                                          spatial_scale=scale), want)
        check(err <= 1e-5 and rel <= 2e-2,
              f"roi_align at {name}: f32 max|err| {err}, bf16 rel {rel}")
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            f, g = f32.to(dtype), g32.to(dtype)
            want_f = K1.roi_align_backward_reference(
                g, props, (H, W), dtype, spatial_scale=scale)
            want_b = K1.roi_align_boxes_grad_reference(g, f, props,
                                                       spatial_scale=scale)
            got = [(K1._grad_fmap_kernel(g, props, (B, H, W, C), dtype,
                                         scale, 7, 2),
                    K1._grad_boxes_kernel(g, f, props, scale, 7, 2))
                   for _ in range(2)]
            torch.cuda.synchronize()
            check(torch.equal(got[0][0], got[1][0])
                  and torch.equal(got[0][1], got[1][1]),
                  f"{name}: two launches of the backward kernels on the "
                  f"same inputs differ ({dtype})")
            errs[dtype] = (
                float((got[0][0].float() - want_f.float()).abs().max()),
                rel_err(torch, got[0][0], want_f),
                float((got[0][1] - want_b).abs().max()),
                rel_err(torch, got[0][1], want_b))
            del want_f, want_b, got
        e32, e16 = errs[torch.float32], errs[torch.bfloat16]
        check(e32[1] <= 1e-5 and e16[1] <= 1e-2,
              f"roi_align_bwd_fmap at {name}: rel err f32 {e32[1]}, bf16 "
              f"{e16[1]}")
        check(e32[3] <= 1e-4 and e16[3] <= 1e-4,
              f"roi_align_bwd_boxes at {name}: rel err f32 {e32[3]}, bf16 "
              f"{e16[3]}")
        g16 = g32.bfloat16()
        n_out = B * R * 49 * C
        fwd_bytes = f16.numel() * 2 + n_boxes + n_out * 2
        bms, bby = bound_ms(fwd_bytes, n_out * 32, peaks, bf16=True)
        shape = (f"{B}x{H}x{W}x{C} bf16 at 1/{stride}, {R} proposal slots "
                 f"an image, {int(sel.sum())} of {B * R} on this level")
        out["roi_align"][name] = dict(
            max_abs_err=err, bf16_rel_err=rel,
            ms=time_ms(lambda: K1.roi_align(f16, props, spatial_scale=scale)),
            plain_ms=time_ms(lambda: K1.roi_align_reference(
                f16, props, spatial_scale=scale), iters=3, warmup=1),
            bound_ms=bms, bound_by=bby, library_ms=None, shape=shape)
        ny, nx, dy, dx = _tap_counts(torch, props, H, W, scale)
        m = sel.cpu().double()
        fmap_ops = 2 * C * float((ny.sum(-1) * nx.sum(-1) * m).sum())
        boxes_ops = 3 * C * float(((dy * nx.sum(-1) + dx * ny.sum(-1))
                                   * m).sum())
        for kname, fn, plain, n_bytes, ops, e in (
                ("roi_align_bwd_fmap",
                 lambda: K1._grad_fmap_kernel(g16, props, (B, H, W, C),
                                              torch.bfloat16, scale, 7, 2),
                 lambda: K1.roi_align_backward_reference(
                     g16, props, (H, W), torch.bfloat16,
                     spatial_scale=scale),
                 g16.numel() * 2 + n_boxes + f16.numel() * 2, fmap_ops,
                 (e32[0], e32[1], e16[1])),
                ("roi_align_bwd_boxes",
                 lambda: K1._grad_boxes_kernel(g16, f16, props, scale, 7, 2),
                 lambda: K1.roi_align_boxes_grad_reference(
                     g16, f16, props, spatial_scale=scale),
                 g16.numel() * 2 + f16.numel() * 2 + 2 * n_boxes, boxes_ops,
                 (e32[2], e32[3], e16[3]))):
            bms, bby = bound_ms(n_bytes, ops, peaks, bf16=False)
            out[kname][name] = dict(
                max_abs_err=e[0], f32_rel_err=e[1], bf16_rel_err=e[2],
                ms=time_ms(fn), plain_ms=time_ms(plain, iters=3, warmup=1),
                bound_ms=bms, bound_by=bby, library_ms=None, shape=shape)
        del f32, g32, g16, want
        torch.cuda.empty_cache()

    # the relation head: the pool level at the sgcls training shape
    Bt, side = TRAIN_BATCH, pyramid["pool"].shape[1]
    pool32 = torch.randn(Bt, side, side, C, generator=g_).cuda()
    nodes = eval_boxes(g_, Bt, TRAIN_NODES, CANVAS).cuda()
    unions = eval_boxes(g_, Bt, TRAIN_EDGES, CANVAS).cuda()
    err, rel = 0.0, 0.0
    for bx in (nodes, unions):
        want = K1.roi_align_reference(pool32, bx, spatial_scale=1 / 64)
        err = max(err, float((K1.roi_align(pool32, bx, spatial_scale=1 / 64)
                              - want).abs().max()))
        rel = max(rel, rel_err(torch, K1.roi_align(
            pool32.bfloat16(), bx, spatial_scale=1 / 64), want))
    check(err <= 1e-5 and rel <= 2e-2,
          f"roi_align on the pool level: f32 max|err| {err}, bf16 rel {rel}")
    p16 = pool32.bfloat16()
    n_out = Bt * (TRAIN_NODES + TRAIN_EDGES) * 49 * C
    n_bytes = 2 * p16.numel() * 2 + (nodes.numel() + unions.numel()) * 4 \
        + n_out * 2
    bms, bby = bound_ms(n_bytes, n_out * 32, peaks, bf16=True)
    out["roi_align"]["pool_relation"] = dict(
        max_abs_err=err, bf16_rel_err=rel,
        ms=time_ms(lambda: [K1.roi_align(p16, x, spatial_scale=1 / 64)
                            for x in (nodes, unions)]),
        plain_ms=time_ms(lambda: [K1.roi_align_reference(
            p16, x, spatial_scale=1 / 64) for x in (nodes, unions)]),
        bound_ms=bms, bound_by=bby, library_ms=None,
        shape=f"{Bt}x{side}x{side}x{C} bf16 at 1/64; nodes R={TRAIN_NODES}"
              f" + unions R={TRAIN_EDGES} (one forward's two launches)")
    del pool32, p16
    torch.cuda.empty_cache()
    for kname, row in out.items():
        for shape, m in row.items():
            extra = (f", f32 rel {m['f32_rel_err']:.3g}"
                     if "f32_rel_err" in m else "")
            print(f"phase 9 {kname} ({shape}): {m['ms']:.4f} ms, bound "
                  f"{m['bound_ms']:.4f} ms ({m['bound_by']}), plain "
                  f"{m['plain_ms']:.4f} ms; max|err| f32 "
                  f"{m['max_abs_err']:.3g}{extra}, bf16 rel "
                  f"{m['bf16_rel_err']:.3g} [{m['shape']}]", flush=True)
    return out


def fpn_card_vs_cpu(torch, splits):
    """9d: one f32 FPN detector step at full width, 2 images, on the card
    and on the CPU from the same weights, on the card's proposal slots and
    the same draws: losses within 1e-5 relative, each part's gradient
    (``p.grad``) within ``FPN_GRAD_LIMIT`` in norm. Two faults on the card
    calibrate the limit, and both must exceed it: the FPN's top-down
    upsampling with torch's ``nearest`` (not JAX's rule) and RoIAlign's
    boxes detached."""
    import copy

    import torch.nn.functional as F

    import sgg_torch.models.detector as D
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.models.detector import (FasterRCNNFPN, balanced_draws,
                                           init_detector_weights)
    from sgg_torch.pretrain_detector import (DetectorOptimizer,
                                             detector_losses)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    init = init_detector_weights(FasterRCNNFPN(151), 1)
    parts = _fpn_groups(dict(init.named_parameters()))
    batch = next(iter(BatchLoader(splits["train"], batch_size=2,
                                  max_nodes=64, max_edges=1,
                                  shuffle=False)))
    batches = {"cuda": batch.to("cuda"), "cpu": batch.to("cpu")}
    card = copy.deepcopy(init).cuda()
    with torch.no_grad():
        out = card(batches["cuda"].images, batches["cuda"].im_hw,
                   gt_boxes=batches["cuda"].boxes,
                   gt_mask=batches["cuda"].node_mask)
    index = (out["proposal_index"], out["rpn_prop_mask"])
    gen = torch.Generator().manual_seed(4)
    draws = {"rpn": balanced_draws(gen, out["rpn_obj_logits"].shape, "cpu"),
             "roi": balanced_draws(gen, out["prop_mask"].shape, "cpu")}
    del out

    def run(det, d):
        opt = DetectorOptimizer(det, lambda count: LR_CHECK)
        opt.zero_grad()
        losses, _ = detector_losses(
            det, batches[d],
            draws={k: tuple(u.to(d) for u in v) for k, v in draws.items()},
            proposal_index=tuple(t.to(d) for t in index))
        sum(losses.values()).backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 .detach().cpu().clone() for n, p in det.named_parameters()}
        if d == "cuda":
            torch.cuda.synchronize()
        return {k: v.detach().cpu() for k, v in losses.items()}, grads

    t0 = time.perf_counter()
    l_card, g_card = run(card, "cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    l_cpu, g_cpu = run(copy.deepcopy(init), "cpu")
    t_cpu = time.perf_counter() - t0
    loss_err = {k: float((l_card[k] - v).abs() / v.abs().clamp(min=1e-12))
                for k, v in l_cpu.items()}
    grad_err = _part_err(torch, g_card, g_cpu, parts)
    del card
    faults = {}
    interpolate, msra = F.interpolate, D.multiscale_roi_align
    try:
        F.interpolate = lambda x, size=None, mode=None, **k: interpolate(
            x, size=size, mode="nearest")
        faults["upsample nearest"] = run(copy.deepcopy(init).cuda(), "cuda")
    finally:
        F.interpolate = interpolate
    try:
        D.multiscale_roi_align = lambda maps, boxes, *a, **k: msra(
            maps, boxes.detach(), *a, **k)
        faults["boxes detached"] = run(copy.deepcopy(init).cuda(), "cuda")
    finally:
        D.multiscale_roi_align = msra
    fault_err = {name: {"losses": max(
        float((fl[k] - v).abs() / v.abs().clamp(min=1e-12))
        for k, v in l_cpu.items()), **_part_err(torch, fg, g_cpu, parts)}
        for name, (fl, fg) in faults.items()}
    torch.cuda.empty_cache()
    print(f"phase 9 FPN pretrain step card vs CPU (f32, 2 images, full "
          f"width, the card's proposal slots and the same draws): losses "
          f"rel err {json.dumps(loss_err)}; gradients rel err in norm by "
          f"part {json.dumps(grad_err)} (limit {FPN_GRAD_LIMIT:g}); the "
          f"faults on the card read {json.dumps(fault_err)}; card "
          f"{t_card:.2f} s, CPU {t_cpu:.2f} s", flush=True)
    check(all(v <= 1e-5 for v in loss_err.values()),
          f"card vs CPU FPN losses differ: {loss_err}")
    check(all(v <= FPN_GRAD_LIMIT for v in grad_err.values()),
          f"card vs CPU FPN gradients differ: {grad_err}")
    for name, e in fault_err.items():
        check(max(v for k, v in e.items() if k != "losses")
              > FPN_GRAD_LIMIT,
              f"the gradient check does not see the fault '{name}': {e}")


def fpn_relation(torch, splits):
    """9e: ``-backbone resnet50`` sgcls training at the main command's
    shape (``main.py -m sgcls -loss dnorm -b 24``; obj_dim 1024, relation
    features from the stride-64 pool level), a warm-up epoch then a counted
    one; a step's time on a batch on the card under the sync check; then
    the dual predcls/sgcls evaluation, counted."""
    from sgg_torch.config import Config
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.eval.driver import val_epoch
    from sgg_torch.train.trainer import Trainer

    config = Config(mode="sgcls", loss="dnorm", batch_size=TRAIN_BATCH,
                    max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                    compute_dtype="bfloat16", device="cuda",
                    print_interval=2, num_workers=4, backbone="resnet50")
    trainer = Trainer(config, splits)
    model = trainer.model
    steps = trainer.steps_per_epoch
    check(model.stride == 64 and model.roi_fmap.fc6.in_features == 49 * 256
          and model.roi_fmap.fc7.out_features == 1024,
          "the resnet50 relation model is not the stride-64, 256-channel, "
          "1024-d one")
    trunk0 = _snapshot(model, lambda n: n.startswith("trunk."))
    trainer.train_epoch(0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, n_epoch, routes = _counted(torch, lambda: trainer.train_epoch(1))
    loop_s = time.perf_counter() - t0
    batch = next(iter(BatchLoader(splits["train"], batch_size=TRAIN_BATCH,
                                  max_nodes=TRAIN_NODES,
                                  max_edges=TRAIN_EDGES,
                                  seed=config.seed))).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(batch, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms.sort()
    med = step_ms[len(step_ms) // 2]
    with torch.no_grad():
        trunk_ms = time_ms(lambda: model.trunk.pool(batch.images), iters=5,
                           warmup=1)
    changed = [n for n, t in _snapshot(model, trunk0.__contains__).items()
               if not torch.equal(t, trunk0[n])]
    print(f"phase 9 resnet50 sgcls train_epoch (-backbone resnet50 -loss "
          f"dnorm -b {TRAIN_BATCH}): {steps} steps in {loop_s:.3f} s = "
          f"{steps * TRAIN_BATCH / loop_s:.2f} train images/s (host "
          f"included); one step on a batch on the card {med:.3f} ms median "
          f"of 5 (min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}), the "
          f"trunk's pool level alone {trunk_ms:.3f} ms; no host sync under "
          f"set_sync_debug_mode('error'); losses {json.dumps(losses)}; "
          f"launches {json.dumps(n_epoch)} by route {json.dumps(routes)}; "
          f"trunk bit-unchanged: {not changed}", flush=True)
    check(all(math.isfinite(v) for v in losses.values()),
          f"non-finite resnet50 losses {losses}")
    check(not changed, f"the resnet50 trunk changed: {changed[:5]}")
    want = {"roi_align": 2 * steps, "vgg_conv1": 0, **NO_BACKWARD,
            "conv_epilogue": 0}
    check(n_epoch == want and routes["roi_align"] == {"bf16": 2 * steps},
          f"resnet50 train launched {n_epoch} by route {routes}; want "
          f"{want}, bf16")
    test = splits["test_alls"]
    res, n_eval, routes = _counted(torch, lambda: val_epoch(
        model, test, config, "test_alls", verbose=False, device="cuda"))
    thr, cnt = res["_throughput"], res.get("_counters", {})
    forwards = cnt.get("eval_ladder_batches", 0) \
        + cnt.get("eval_dedup_fallback", 0)
    rates = {m: round(thr[m]["images"] / thr[m]["seconds"], 2) for m in thr}
    recalls = {k: v for k, v in res.items() if "R@" in k}
    print(f"phase 9 resnet50 eval (predcls + sgcls, {len(test)} images): "
          f"images/s {json.dumps(rates)} (host evaluator included); "
          f"counters {json.dumps(cnt)}; launches {json.dumps(n_eval)} by "
          f"route {json.dumps(routes)}", flush=True)
    check(recalls and all(math.isfinite(v) for v in recalls.values()),
          "resnet50 recalls missing or not finite")
    check(n_eval == {"roi_align": 2 * forwards, "vgg_conv1": 0,
                     **NO_BACKWARD, "conv_epilogue": 0} and forwards > 0,
          f"resnet50 eval launched {n_eval} for {forwards} forwards")
    del trainer, model, batch
    torch.cuda.empty_cache()
    return {"resnet50_train_epoch": n_epoch, "resnet50_eval": n_eval}


def fpn_sgdet(torch, ckdir):
    """9f: ``python -m sgg_torch.main -m sgdet -backbone resnet50 -nepoch
    0 -ckpt <dir>`` on the payload FPN pretraining wrote, counted (a
    detector barely trained may put no class above the 0.01 retry floor:
    the CLI then stops with "evaluated zero images", read as zero
    detections); then one relation train step at batch 6 on that frozen
    detector, counted: 4 K1 launches for its proposals, 2 for the relation
    head's nodes and unions on the pool level."""
    from sgg_torch import main as cli
    from sgg_torch.config import Config
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.models.detector import FasterRCNNFPN
    from sgg_torch.train.checkpoint import load_detector
    from sgg_torch.train.trainer import Trainer

    argv = ["-m", "sgdet", "-backbone", "resnet50", "-nepoch", "0", "-ckpt",
            ckdir, "-split", "synthetic", "-val_size", "16", "-nwork", "4"]

    def evaluate():
        try:
            return cli.main(argv)
        except RuntimeError as e:
            if "evaluated zero images" not in str(e):
                raise
            return None

    t0 = time.perf_counter()
    res, n, routes = _counted(torch, evaluate)
    wall = time.perf_counter() - t0
    if res is None:
        what = ("the CLI stopped at a split that evaluated zero images (no "
                "class above the 0.01 retry floor)")
    else:
        ap, n_img, n_det = _det_ap(res["_detections"])
        thr = res["_throughput"]
        images = sum(t["sgdet"]["images"] for t in thr.values())
        secs = sum(t["sgdet"]["seconds"] for t in thr.values())
        what = (f"{n_img} images, {n_det} detections, {images / secs:.2f} "
                f"images/s in the eval loops; DetectionEvaluator "
                f"{json.dumps(ap)}")
    print(f"phase 9 sgdet eval on the FPN detector (main -m sgdet -backbone "
          f"resnet50 -nepoch 0 -ckpt <pretraining's dir>): {what} in "
          f"{wall:.1f} s; launches {json.dumps(n)} by route "
          f"{json.dumps(routes)}", flush=True)
    check(n["roi_align"] > 0 and n["roi_align"] % 2 == 0
          and n["vgg_conv1"] == 0 and all(n[k] == 0 for k in NO_BACKWARD),
          f"FPN sgdet eval launched {n}")
    n_scaled = fpn_sgdet_scaled(torch, argv)

    splits = synthetic_splits(num_train=SGDET_TRAIN_BATCH, num_eval=2)
    config = Config(mode="sgdet", loss="dnorm", batch_size=SGDET_TRAIN_BATCH,
                    compute_dtype="bfloat16", device="cuda",
                    backbone="resnet50", num_workers=2)
    payload, _ = load_detector(ckdir)
    trainer = Trainer(config, splits, detector=FasterRCNNFPN(151),
                      det_state=payload)
    batch = next(iter(BatchLoader(splits["train"],
                                  batch_size=SGDET_TRAIN_BATCH,
                                  max_nodes=config.max_nodes,
                                  max_edges=config.max_edges,
                                  seed=config.seed))).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    trainer.train_step(batch, gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, n_step, routes = _counted(torch, lambda: trainer.train_step(batch, gen))
    step_ms = (time.perf_counter() - t0) * 1e3
    metrics = {k: float(v) for k, v in m.items()}
    print(f"phase 9 sgdet train step on the FPN detector (batch "
          f"{SGDET_TRAIN_BATCH}, bf16): {step_ms:.3f} ms with the count's "
          f"read; metrics {json.dumps(metrics)}; launches "
          f"{json.dumps(n_step)} by route {json.dumps(routes)}", flush=True)
    check(all(math.isfinite(v) for v in metrics.values()),
          f"non-finite FPN sgdet metrics {metrics}")
    check(n_step == {"roi_align": 6, "vgg_conv1": 0, **NO_BACKWARD,
                     "conv_epilogue": 0}
          and routes["roi_align"] == {"bf16": 6},
          f"FPN sgdet train step launched {n_step} by route {routes}")
    del trainer, batch
    torch.cuda.empty_cache()
    return {"fpn_sgdet_eval": n, "fpn_sgdet_eval_scaled": n_scaled,
            "fpn_sgdet_train_step": n_step}


def fpn_sgdet_scaled(torch, argv):
    """9f: the same CLI on a seeded random ``FasterRCNNFPN(151)`` whose
    classifier's weights are scaled by ``CLS_SCALE`` (as phase 7's VGG
    detector), so that detections reach the relation head and the
    evaluator: K1 4 times a detector pass (P2-P5) and twice a relation
    pass (nodes and unions on the pool level), counted against the retry
    counters; at least half the images evaluated; finite recalls."""
    import shutil
    import tempfile

    from sgg_torch import main as cli
    from sgg_torch.models.detector import FasterRCNNFPN, init_detector_weights
    from sgg_torch.train.checkpoint import save_detector

    det = init_detector_weights(FasterRCNNFPN(151), 0)
    with torch.no_grad():
        det.cls_score.weight.mul_(CLS_SCALE)
    ckdir = tempfile.mkdtemp(prefix="sgg_fpn_scaled_")
    try:
        save_detector(ckdir, det)
        del det
        args = list(argv)
        args[args.index("-ckpt") + 1] = ckdir
        t0 = time.perf_counter()
        res, n, routes = _counted(torch, lambda: cli.main(args))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir)
    thr, cnt, dets = res["_throughput"], res["_counters"], res["_detections"]
    images = sum(t["sgdet"]["images"] for t in thr.values())
    secs = sum(t["sgdet"]["seconds"] for t in thr.values())
    n_det = [d for v in dets.values() for d in v["n_det"]]
    batches = sum(c.get("sgdet_batches", 0) for c in cnt.values())
    redetect = sum(c.get("sgdet_nms_unconverged", 0)
                   + c.get("sgdet_nms_cand_overflow", 0)
                   for c in cnt.values())
    recalls = {k: v for k, v in res.items()
               if k.startswith("sgdet/test_alls_R@")}
    ap, n_img, n_total = _det_ap(dets)
    print(f"phase 9 sgdet eval on a random FPN detector, classifier x"
          f"{CLS_SCALE:g} (main -m sgdet -backbone resnet50 -nepoch 0): "
          f"{images} of {len(n_det)} images reached the evaluator, "
          f"{images / secs:.2f} images/s in the eval loops ({wall:.1f} s "
          f"with model building); detections an image min {min(n_det)} "
          f"median {sorted(n_det)[len(n_det) // 2]} max {max(n_det)}; "
          f"counters {json.dumps(cnt)}; DetectionEvaluator over {n_img} "
          f"images, {n_total} detections {json.dumps(ap)}; launches "
          f"{json.dumps(n)} by route {json.dumps(routes)}", flush=True)
    check(images >= 0.5 * len(n_det),
          f"only {images} of {len(n_det)} images reached the evaluator")
    check(recalls and all(math.isfinite(v) for v in recalls.values()),
          f"recalls missing or not finite: {recalls}")
    want = {"roi_align": 4 * (batches + redetect) + 2 * batches,
            "vgg_conv1": 0, **NO_BACKWARD, "conv_epilogue": 0}
    check(n == want and set(routes["roi_align"]) == {"bf16"},
          f"FPN sgdet eval launched {n} by route {routes}; {batches} "
          f"batches with {redetect} re-detections want {want}")
    return n


def raw_boxes_paths(torch, splits):
    """9g: ``-edge_model raw_boxes`` on the VGG16 model: one sgcls train
    step at the training shape and one eval forward of 16 images, counted
    (2 K1 + 1 K2 each), finite."""
    from sgg_torch.config import Config
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.train.state import Optimizer
    from sgg_torch.train.step import make_eval_step, make_train_step
    from sgg_torch.train.trainer import build_model

    config = Config(mode="sgcls", loss="dnorm", batch_size=TRAIN_BATCH,
                    max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                    compute_dtype="bfloat16", device="cuda",
                    edge_model="raw_boxes")
    model = build_model(config, splits["train"], device="cuda", seed=0)
    check(model.union_feats.edge_model == "raw_boxes",
          "the model does not rasterize raw boxes")
    step = make_train_step(model, config, Optimizer(config, model))
    batch = next(iter(BatchLoader(splits["train"], batch_size=TRAIN_BATCH,
                                  max_nodes=TRAIN_NODES,
                                  max_edges=TRAIN_EDGES,
                                  seed=0))).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    step(batch, gen)  # warm-up
    m, n_train, r_train = _counted(torch, lambda: step(batch, gen))
    metrics = {k: float(v) for k, v in m.items()}
    test = next(iter(BatchLoader(splits["test_alls"], batch_size=16,
                                 max_nodes=64, max_edges=config.max_edges,
                                 shuffle=False, drop_last=False)))
    evaluate = make_eval_step(model, mode="sgcls", max_pairs=512,
                              device="cuda")
    out, n_eval, r_eval = _counted(torch, lambda: evaluate(test))
    finite = bool(torch.isfinite(out["rel_dists"]).all()
                  and torch.isfinite(out["obj_logits"]).all())
    print(f"phase 9 raw_boxes (-edge_model raw_boxes, VGG16, bf16): train "
          f"step metrics {json.dumps(metrics)}, launches "
          f"{json.dumps(n_train)} by route {json.dumps(r_train)}; eval "
          f"forward of 16 images finite: {finite}, launches "
          f"{json.dumps(n_eval)} by route {json.dumps(r_eval)}", flush=True)
    want = {"roi_align": 2, "vgg_conv1": 1, **NO_BACKWARD,
            "conv_epilogue": 12}
    check(all(math.isfinite(v) for v in metrics.values()) and finite,
          f"raw_boxes: non-finite outputs {metrics}")
    check(n_train == want and n_eval == want,
          f"raw_boxes launched {n_train} (train) and {n_eval} (eval); want "
          f"{want}")
    del model, batch, out
    torch.cuda.empty_cache()
    return {"raw_boxes_train_step": n_train, "raw_boxes_eval": n_eval}


def phase_resnet(torch, peaks, rows, splits):
    """Phase 9: ResNet50-FPN at full width (FPN pretraining, its kernels
    at the pyramid's shapes, a card-vs-CPU step, the resnet50 relation
    model, SGDet on the FPN detector) and the raw_boxes edge model."""
    import shutil
    import tempfile

    from sgg_torch.data.synthetic import synthetic_splits

    det_splits = synthetic_splits(num_train=FPN_IMAGES, num_eval=4)
    ckdir = tempfile.mkdtemp(prefix="sgg_fpn_")
    paths = {}
    try:
        det, paths["fpn_pretrain"] = fpn_pretrain_run(torch, det_splits,
                                                      ckdir)
        pyramid, props = fpn_step_profile(torch, det, det_splits)
        del det
        torch.cuda.empty_cache()
        for name, row in fpn_kernels(torch, peaks, pyramid, props).items():
            rows[name]["fpn"] = row
        del pyramid, props
        torch.cuda.empty_cache()
        paths.update(fpn_sgdet(torch, ckdir))
    finally:
        shutil.rmtree(ckdir)
    fpn_card_vs_cpu(torch, det_splits)
    paths.update(fpn_relation(torch, splits))
    paths.update(raw_boxes_paths(torch, splits))
    return paths


# ---------------------------------------------------------------------------
# phase 10: real inputs (the reference checkpoints' import, the dataset
# parsers and image decoding where h5py and PIL are installed)

REAL_DEADLINE_S = 300
REAL_EVAL_SIZE = 24


def _check_imported(torch, kind, model, sd):
    """Every tensor of ``sd`` that the import's map reads sits in ``model``
    bit for bit after its layout change (fc6: the CHW -> HWC permutation of
    its input axis); returns their count."""
    from sgg_torch.train.checkpoint import reference_flat_updates
    state = model.state_dict()
    flat = reference_flat_updates(kind, sd)
    for name, want in flat.items():
        check(torch.equal(state[name], want),
              f"import {kind}: {name} is not its source bit for bit")
    return len(flat)


def import_reference(torch, kind, sd, tmp, wrap=False):
    """10a: ``sd`` saved as a reference ``.pth`` (``{"state_dict": sd}``
    with ``wrap``, as a vgrel.pth) and imported by ``python -m
    sgg_torch.import_reference_ckpt <kind>`` in-process; checked bitwise;
    the skipped names printed. Returns (imported model, payload dir)."""
    from sgg_torch import import_reference_ckpt as tool
    pth, out_dir = os.path.join(tmp, f"{kind}.pth"), os.path.join(tmp, kind)
    torch.save({"state_dict": sd} if wrap else sd, pth)
    t0 = time.perf_counter()
    res = tool.main([kind, pth, out_dir])
    secs = time.perf_counter() - t0
    os.remove(pth)
    n = _check_imported(torch, kind, res["model"], sd)
    stats = res["stats"]
    print(f"phase 10 import {kind}: {len(sd)} reference tensors, {n} "
          f"bitwise equal to their sources after the layout change, in "
          f"{secs:.1f} s; skipped: {len(stats['missing'])} names kept their "
          f"initial values {json.dumps(stats['missing'])}, "
          f"{len(stats['unused'])} checkpoint tensors without a home "
          f"{json.dumps(stats['unused'])}", flush=True)
    check(not stats["unused"], f"import {kind}: tensors without a home")
    return res["model"], out_dir


def _jpeg_splits(splits, root):
    """``splits`` with every image a JPEG under ``root``, written by the
    port's fixture writer: smooth random background and a class-coded
    shape at each box. The synthetic splits are file-less and feed blank
    canvases, on which a random RPN scores every interior anchor alike."""
    import dataclasses

    import numpy as np

    from sgg_torch.data.fixtures import _write_jpeg
    rng = np.random.RandomState(10)
    out = {}
    for name, ds in splits.items():
        files = []
        for i, (boxes, classes) in enumerate(zip(ds.gt_boxes,
                                                 ds.gt_classes)):
            files.append(f"{name}_{i}.jpg")
            _write_jpeg(os.path.join(root, files[-1]), rng, CANVAS, CANVAS,
                        boxes, classes)
        out[name] = dataclasses.replace(ds, filenames=files,
                                        images_dir=root)
    return out


def imported_sgdet_cli(torch, ckdir, tmp):
    """10b: ``main -m sgdet -nepoch 0 -ckpt <imported dir> -split
    synthetic`` on the card, its splits' images written as JPEGs under
    ``tmp`` and decoded by the loader, counted: K1 and K2 launch as in
    phase 7."""
    from sgg_torch import main as cli
    argv = ["-m", "sgdet", "-nepoch", "0", "-ckpt", ckdir, "-split",
            "synthetic", "-val_size", str(REAL_EVAL_SIZE), "-nwork", "4"]
    real_load = cli.load_splits
    cli.load_splits = lambda config: _jpeg_splits(real_load(config), tmp)
    t0 = time.perf_counter()
    try:
        res, n, routes = _counted(torch, lambda: cli.main(argv))
    finally:
        cli.load_splits = real_load
    wall = time.perf_counter() - t0
    thr, cnt, dets = res["_throughput"], res["_counters"], res["_detections"]
    images = sum(t["sgdet"]["images"] for t in thr.values())
    secs = sum(t["sgdet"]["seconds"] for t in thr.values())
    n_det = [d for v in dets.values() for d in v["n_det"]]
    batches = sum(c.get("sgdet_batches", 0) for c in cnt.values())
    redetect = sum(c.get("sgdet_nms_unconverged", 0)
                   + c.get("sgdet_nms_cand_overflow", 0)
                   for c in cnt.values())
    recalls = {k: v for k, v in res.items()
               if k.startswith("sgdet/test_alls_R@")}
    print(f"phase 10 sgdet eval on the imported VGG16 detector, classifier "
          f"x{CLS_SCALE:g} (main -m sgdet -nepoch 0 -ckpt <imported>): "
          f"{images} of {len(n_det)} JPEG images reached the evaluator, "
          f"{images / secs:.2f} CLI eval images/s in the eval loops with "
          f"{redetect} of {batches} batches re-detected with sequential NMS "
          f"({wall:.1f} s with JPEG writing and model building); "
          f"detections an image min "
          f"{min(n_det)} max {max(n_det)}; counters {json.dumps(cnt)}; "
          f"launches {json.dumps(n)} by route {json.dumps(routes)}",
          flush=True)
    check(images >= 0.5 * len(n_det),
          f"only {images} of {len(n_det)} images reached the evaluator")
    check(recalls and all(math.isfinite(v) for v in recalls.values()),
          f"recalls missing or not finite: {recalls}")
    want = {"vgg_conv1": batches + redetect,
            "roi_align": batches + redetect + 2 * batches, **NO_BACKWARD,
            "conv_epilogue": 12 * (batches + redetect)}
    check(n == want and n["roi_align"] > 0 and n["vgg_conv1"] > 0,
          f"imported sgdet eval launched {n}; {batches} batches with "
          f"{redetect} re-detections want {want}")
    return n


def imported_relmodel_card_vs_cpu(torch, model, tmp):
    """10c: one sgcls eval forward of the imported relation model (f32, 2
    JPEG images decoded under ``tmp``, full width), card against CPU under
    phase 6's limit."""
    import copy

    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.step import make_eval_step

    test = _jpeg_splits({"rel": synthetic_splits(num_eval=2)["test_alls"]},
                        tmp)["rel"]
    batch = next(iter(BatchLoader(test, batch_size=2, max_nodes=64,
                                  max_edges=576, shuffle=False,
                                  drop_last=False)))
    card = copy.deepcopy(model).cuda().eval()
    got, n, routes = _counted(torch, lambda: make_eval_step(
        card, mode="sgcls", max_pairs=512, device="cuda")(batch))
    want = make_eval_step(model.eval(), mode="sgcls", max_pairs=512,
                          device="cpu")(batch)
    errs = {k: float((got[k].cpu() - want[k]).abs().max())
            for k in ("obj_logits", "rel_dists")}
    print(f"phase 10 imported relation model, sgcls eval forward card vs "
          f"CPU (f32, 2 JPEG images, full width, frequency bias): "
          f"max|err| "
          f"{json.dumps(errs)}; launches {json.dumps(n)} by route "
          f"{json.dumps(routes)}", flush=True)
    check(all(math.isfinite(v) and v <= 1e-3 for v in errs.values()),
          f"imported relation model: card vs CPU outputs differ: {errs}")
    check(n["roi_align"] == 2 and n["vgg_conv1"] == 1,
          f"imported relation model launched {n}")
    del card
    torch.cuda.empty_cache()
    return n


def imported_fpn_card_vs_cpu(torch, fpn_dir):
    """10c: a ``FasterRCNNFPN(151)`` whose backbone is the imported
    payload (loaded strictly), one f32 forward of 2 images at full width,
    card against CPU, the CPU held on the card's proposals: the pyramid,
    RPN and box-head outputs within 1e-3 of their size (phase 7's limit)."""
    import copy

    from sgg_torch.models.detector import FasterRCNNFPN, init_detector_weights
    from sgg_torch.train.checkpoint import restore_payload

    payload, _ = restore_payload(fpn_dir)
    det = init_detector_weights(FasterRCNNFPN(151), 0).eval()
    det.backbone.load_state_dict({**payload["params"],
                                  **payload["batch_stats"]}, strict=True)
    card = copy.deepcopy(det).cuda().eval()
    g = torch.Generator().manual_seed(4)
    images = torch.randn(2, CANVAS, CANVAS, 3, generator=g)
    im_hw = torch.tensor([[CANVAS, CANVAS], [0.75 * CANVAS, CANVAS]],
                         dtype=torch.float32)
    with torch.no_grad():
        got, n, routes = _counted(torch, lambda: card(images.cuda(),
                                                      im_hw.cuda()))
        got = {k: (v.cpu() if torch.is_tensor(v) else
                   {lv: x.cpu() for lv, x in v.items()})
               for k, v in got.items()}
        want = det(images, im_hw, proposal_index=(got["proposal_index"],
                                                  got["rpn_prop_mask"]))
    errs = {f"pyramid {lv}": rel_err(torch, got["pyramid"][lv],
                                     want["pyramid"][lv])
            for lv in want["pyramid"]}
    errs.update({k: rel_err(torch, got[k], want[k])
                 for k in ("rpn_obj_logits", "rpn_deltas", "class_logits",
                           "box_deltas")})
    print(f"phase 10 detector on the imported ResNet50-FPN backbone, forward "
          f"card vs CPU (f32, 2 images, full width; the CPU on the card's "
          f"proposals): rel err {json.dumps(errs)}; detections "
          f"{got['mask'].sum(1).tolist()}; launches {json.dumps(n)} by route "
          f"{json.dumps(routes)}", flush=True)
    check(all(math.isfinite(v) and v <= 1e-3 for v in errs.values()),
          f"imported FPN detector: card vs CPU outputs differ: {errs}")
    check(n["roi_align"] == 4, f"imported FPN detector launched {n}")
    del card
    torch.cuda.empty_cache()
    return n


def _fixture_run(torch, tree, name, argv):
    """``main`` on a fixture tree on the card, counted; its recalls
    finite."""
    from sgg_torch import main as cli
    t0 = time.perf_counter()
    res, n, routes = _counted(torch, lambda: cli.main(
        argv + ["-data", tree, "-b", "3", "-nepoch", "1", "-val_size", "2",
                "-p", "1", "-nwork", "2", "-save_dir",
                os.path.join(tree, f"run_{name}")]))
    recalls = {k: v for k, v in res.items()
               if k.startswith("sgcls/test_alls_R@")}
    thr = res["_throughput"]["test_alls"]["sgcls"]
    print(f"phase 10 {' '.join(argv)} on a {name} fixture tree (JPEGs "
          f"decoded with PIL; 2 train steps and the eval, "
          f"{time.perf_counter() - t0:.1f} s; sgcls test_alls "
          f"{thr['images'] / thr['seconds']:.2f} images/s): recalls "
          f"{json.dumps(recalls)}; launches {json.dumps(n)} by route "
          f"{json.dumps(routes)}", flush=True)
    check(recalls and all(math.isfinite(v) for v in recalls.values()),
          f"{name} fixture: recalls {recalls}")
    check(n["roi_align"] > 0 and NO_BACKWARD.items() <= n.items(),
          f"{name} fixture launched {n}")
    return n


def real_data_packages(torch):
    """10d: with h5py and PIL, ``main -split stanford`` on a VG fixture
    tree on the card (two train steps and the eval); without either, the
    parsers still import, and ``-split stanford`` raises ImportError naming
    what is missing before any work on the card. With PIL, ``-split gqa``
    (JSON scene graphs, no h5py) on a GQA fixture tree on the card."""
    import importlib
    import shutil
    import tempfile

    import sgg_torch.data.visual_genome  # noqa: F401  (needs neither)
    from sgg_torch import main as cli
    from sgg_torch.data import fixtures
    from sgg_torch.train import trainer as trainer_mod

    have = {}
    for name in ("h5py", "PIL"):
        try:
            importlib.import_module(name)
            have[name] = True
        except ImportError:
            have[name] = False
    print(f"phase 10 data packages: {json.dumps(have)}", flush=True)
    tree = tempfile.mkdtemp(prefix="sgg_data_")
    paths = {}
    try:
        if all(have.values()):
            fixtures.write_vg_fixture(tree, n_train=8, n_test=4)
            old = os.environ.get("SGG_CHECK_SIZES")
            os.environ["SGG_CHECK_SIZES"] = "0"
            try:
                paths["stanford_fixture"] = _fixture_run(
                    torch, tree, "VG", ["-m", "sgcls", "-split", "stanford"])
            finally:
                if old is None:
                    del os.environ["SGG_CHECK_SIZES"]
                else:
                    os.environ["SGG_CHECK_SIZES"] = old
        else:
            built = []
            real_trainer = trainer_mod.Trainer
            trainer_mod.Trainer = lambda *a, **k: built.append(a)
            allocs = torch.cuda.memory_stats().get(
                "allocation.all.allocated", 0)
            try:
                cli.main(["-split", "stanford", "-data", tree])
                raise RuntimeError("-split stanford ran without h5py or PIL")
            except ImportError as e:
                msg = str(e)
            finally:
                trainer_mod.Trainer = real_trainer
            missing = [k for k, v in have.items() if not v]
            after = torch.cuda.memory_stats().get(
                "allocation.all.allocated", 0)
            print(f"phase 10 -split stanford without {missing}: ImportError "
                  f"{msg!r}; trainer built {len(built)} times, card "
                  f"allocations {after - allocs}", flush=True)
            check(all(m in msg for m in missing),
                  f"the ImportError does not name {missing}: {msg!r}")
            check(not built and after == allocs,
                  "-split stanford worked on the card before it raised")
        if have["PIL"]:
            fixtures.write_gqa_fixture(tree, n_train=8, n_val=4)
            paths["gqa_fixture"] = _fixture_run(
                torch, tree, "GQA", ["-m", "sgcls", "-split", "gqa",
                                     "-backbone", "resnet50"])
        return paths
    finally:
        shutil.rmtree(tree)


def phase_real_inputs(torch):
    """Phase 10: torchvision-format reference checkpoints (seeded) built,
    saved and imported in-process (a VGG16 FasterRCNN, a vgrel.pth
    relation model, a maskrcnn_resnet50_fpn backbone); SGDet on the
    imported detector through the CLI; the imported relation model and
    FPN detector card against CPU; the data packages' branch."""
    import shutil
    import tempfile

    from sgg_torch import import_reference_ckpt as tool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(10)
    tmp = tempfile.mkdtemp(prefix="sgg_import_")
    paths = {}
    try:
        sd = tool.reference_state_dict(
            "detector", tool.build_model("detector", 151), g)
        # a random 151-way classifier scores near 1/151, under every
        # threshold: scaled as phase 7's, detections clear them
        sd["roi_heads.box_predictor.cls_score.weight"] *= CLS_SCALE
        _, det_dir = import_reference(torch, "detector", sd, tmp)
        del sd
        paths["import_sgdet_eval"] = imported_sgdet_cli(torch, det_dir,
                                                        tmp)
        sd = tool.reference_state_dict(
            "relmodel", tool.build_model("relmodel", 151, use_bias=True), g)
        rel, _ = import_reference(torch, "relmodel", sd, tmp, wrap=True)
        del sd
        paths["import_relmodel_eval"] = imported_relmodel_card_vs_cpu(
            torch, rel, tmp)
        del rel
        sd = tool.reference_state_dict(
            "resnet_fpn", tool.build_model("resnet_fpn"), g)
        _, fpn_dir = import_reference(torch, "resnet_fpn", sd, tmp)
        del sd
        paths["import_fpn_forward"] = imported_fpn_card_vs_cpu(torch,
                                                               fpn_dir)
    finally:
        shutil.rmtree(tmp)
    paths.update(real_data_packages(torch))
    print(f"phase 10 real inputs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 11: GAN-augmented training (-gan -largeD -perturb graphn)

GAN_DEADLINE_S = 360
# the second paper's command without the feature bank (-vis_cond)
GAN_ARGV = ["-m", "sgcls", "-loss", "dnorm", "-b", str(TRAIN_BATCH), "-gan",
            "-largeD", "-perturb", "graphn", "-L", "0.2", "-topk", "5",
            "-graphn_a", "2", "-split", "synthetic"]
# per step: K2 and two K1 launches on the real bf16 map (F), four K1
# launches on the f32 fake map (the attached fake forward, the detached rec
# forward) and K1-bwd-fmap twice on f32-staged (the adversarial losses
# through the fake map's node and union pools); the boxes are constants
GAN_ROUTES = {"roi_align": {"bf16": 2, "f32": 4},
              "roi_align_bwd_fmap": {"f32-staged": 2},
              "roi_align_bwd_boxes": {}, "vgg_conv1": {"bf16": 1},
              "vgg_conv1_bwd": {}, "conv_epilogue": trunk_routes(1)}
GAN_KEYS = ("obj_loss", "rel_loss", "grad_norm", "G_obj", "G_rel", "G_fmap",
            "obj_loss_rec", "rel_loss_rec", "D_obj", "D_rel", "D_fmap",
            "grad_norm_G", "grad_norm_D", "total")
# the card-vs-CPU GAN step: losses relative, gradients (and their global
# norms) relative in norm by part (phase 6's limits); G's gradient and the
# rec update's, which pass backward through G's or the union BatchNorms
# in train mode, within GAN_G_LIMIT: G's backward alone from one fixed map
# gradient differs card vs CPU by 2.0e-3 to 4.0e-3 by part, and the step
# reads the same with K1-bwd-fmap's plain version on the card (printed by
# gan_card_vs_cpu; measured on an NVIDIA H100 80GB HBM3 at 700.00 W)
GAN_LOSS_LIMIT, GAN_GRAD_LIMIT, GAN_G_LIMIT = 1e-4, 1e-3, 1e-2


def gan_config(**kw):
    from sgg_torch.config import config_from_args
    return config_from_args(GAN_ARGV + [
        "-max_nodes", str(TRAIN_NODES), "-max_edges", str(TRAIN_EDGES),
        "-p", "2", "-nwork", "4"]).replace(**kw)


def gan_train(torch, splits):
    """11a: ``Trainer`` with the command above on the card: a warm-up epoch,
    then one counted and timed epoch; a step under
    ``set_sync_debug_mode("error")``; a step timed by phase with CUDA
    events and its peak memory; what moved. Returns the counted epoch's
    launches, a host batch and the epoch's train images/s."""
    from sgg_torch import constants
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.train.trainer import Trainer

    # PyTorch's defaults, as a user's run has them (phase 3 turned TF32
    # off): cuDNN's convolutions may take TF32, cuBLAS's matmuls not
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gan_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, splits)
    model, gan = trainer.model, trainer.gan
    steps = trainer.steps_per_epoch
    print(f"phase 11 GAN trainer built in {time.perf_counter() - t0:.1f} s: "
          f"{' '.join(GAN_ARGV)}; relation model "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params "
          f"(bf16), GAN {sum(p.numel() for p in gan.parameters()) / 1e6:.2f}"
          f" M (f32, {gan.fmap_sz}x{gan.fmap_sz}x{gan.n_ch} maps); "
          f"{len(splits['train'])} train images, {steps} steps an epoch",
          flush=True)
    check(all(p.dtype == torch.float32 for p in gan.parameters()),
          "GAN parameters are not float32")
    check(trainer.perturber is not None, "no perturber under -perturb")
    trunk0 = _snapshot(model, lambda n: n.startswith("trunk."))
    heads0 = _snapshot(model, lambda n: not n.startswith("trunk.")
                       and "num_batches" not in n)
    gan0 = {n: p.detach().clone() for n, p in gan.named_parameters()}

    trainer.train_epoch(0)  # warm-up: first launches, cuDNN/cuBLAS set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses, n, routes = _counted(torch, lambda: trainer.train_epoch(1))
    loop_s = time.perf_counter() - t0
    peak_epoch = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 11 GAN train_epoch: {steps} steps x {TRAIN_BATCH} images "
          f"in {loop_s:.3f} s = {steps * TRAIN_BATCH / loop_s:.2f} train "
          f"images/s (host included); losses {json.dumps(losses)}; launches "
          f"{json.dumps(n)} by route {json.dumps(routes)}; peak device "
          f"memory {peak_epoch:.2f} GiB", flush=True)
    check(all(k in losses and math.isfinite(losses[k]) for k in GAN_KEYS),
          f"GAN losses missing or not finite: {losses}")
    want = {k: {r: c * steps for r, c in v.items()}
            for k, v in GAN_ROUTES.items()}
    check(routes == want and n == {k: sum(v.values())
                                   for k, v in want.items()},
          f"{steps} GAN steps launched {n} by route {routes}; want {want}")

    host = next(iter(BatchLoader(
        splits["train"], batch_size=TRAIN_BATCH, max_nodes=TRAIN_NODES,
        max_edges=TRAIN_EDGES, shuffle=False, im_scale=constants.IM_SCALE,
        image_format=cfg.image_format)))
    item = trainer._gan_host_inputs(host, 2).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    trainer.gan_step(item.batch, item.fake_classes, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.gan_step(item.batch, item.fake_classes, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("phase 11 a GAN step under set_sync_debug_mode('error'): no host "
          "sync", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    by_phase = {"F": [], "G": [], "D": [], "wall": []}
    for _ in range(5):
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in ("start", "F", "G", "D")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev["start"].record()
        trainer.gan_step(item.batch, item.fake_classes, gen,
                         mark=lambda phase, ev=ev: ev[phase].record())
        torch.cuda.synchronize()
        by_phase["wall"].append((time.perf_counter() - t0) * 1e3)
        for a, b in (("start", "F"), ("F", "G"), ("G", "D")):
            by_phase[b].append(ev[a].elapsed_time(ev[b]))
    peak_step = torch.cuda.max_memory_allocated() / 2**30
    med = {k: sorted(v)[len(v) // 2] for k, v in by_phase.items()}
    print(f"phase 11 one GAN step on a batch on the card (bf16 relation "
          f"model, f32 GAN, batch {TRAIN_BATCH}), median of 5 by phase (CUDA "
          f"events from the host's issue points): F {med['F']:.3f} ms, G "
          f"{med['G']:.3f} ms, D {med['D']:.3f} ms; the step {med['wall']:.3f}"
          f" ms wall (min {min(by_phase['wall']):.3f}, max "
          f"{max(by_phase['wall']):.3f}); peak device memory of a step "
          f"{peak_step:.2f} GiB", flush=True)

    changed = [k for k, t in _snapshot(model, trunk0.__contains__).items()
               if not torch.equal(t, trunk0[k])]
    check(not changed, f"trunk changed: {changed[:5]}")
    still = [k for k, t in _snapshot(model, heads0.__contains__).items()
             if torch.equal(t, heads0[k])]
    check(not still, f"relation-head tensors did not move: {still[:5]}")
    still = [k for k, p in gan.named_parameters()
             if torch.equal(p.detach(), gan0[k])]
    check(not still, f"GAN parameters did not move: {still[:5]}")
    print(f"phase 11 trunk bit-unchanged ({len(trunk0)} tensors); all "
          f"{len(heads0)} relation-head parameters and BN statistics and all "
          f"{len(gan0)} G and D parameters moved", flush=True)
    del trainer, model, gan, item
    torch.cuda.empty_cache()
    return n, host, steps * TRAIN_BATCH / loop_s


def gan_kernels(torch, peaks, host):
    """11b: K1 (f32) and K1-bwd-fmap (f32-staged; bf16-mma for a bf16
    GAN) at the GAN step's shape, against their plain versions (phase 3's
    and phase 8's limits): a 24 x 37 x 37 x 512 fake map, the batch's 40
    node boxes and the union boxes of 256 sampled pairs an image; each
    launched twice for the same bits; times and bounds per launch pair."""
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops.boxes import union_boxes
    from sgg_torch.train.assign import sample_edges
    b = host.to("cpu")
    sampled, _ = sample_edges(torch.Generator().manual_seed(2), b.rels,
                              b.rel_mask, b.node_mask, max_out=TRAIN_EDGES)
    nodes = b.boxes.float().contiguous().cuda()
    unions = union_boxes(b.boxes.float(), sampled[..., 0],
                         sampled[..., 1]).contiguous().cuda()
    B, H, C, s = TRAIN_BATCH, CANVAS // 16, 512, 1 / 16
    g_ = torch.Generator().manual_seed(11)
    fmap = torch.rand(B, H, H, C, generator=g_).cuda()
    out = {}
    err = rel = 0.0
    for bx in (nodes, unions):
        want = K1.roi_align_reference(fmap, bx, spatial_scale=s)
        got = [K1.roi_align(fmap, bx, spatial_scale=s) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(got[0], got[1]), "roi_align f32: two launches "
                                           "differ")
        err = max(err, float((got[0] - want).abs().max()))
    check(err <= 1e-5, f"roi_align f32 at the GAN shape: max |err| {err}")
    del want, got
    n_pool = B * (nodes.shape[1] + unions.shape[1]) * 49 * C
    k1_bytes = 2 * fmap.numel() * 4 + (nodes.numel() + unions.numel()) * 4 \
        + n_pool * 4
    bms, bby = bound_ms(k1_bytes, n_pool * 32, peaks, bf16=False)
    out["roi_align"] = dict(
        max_abs_err=err, ms=time_ms(lambda: (
            K1.roi_align(fmap, nodes, spatial_scale=s),
            K1.roi_align(fmap, unions, spatial_scale=s))),
        plain_ms=time_ms(lambda: (
            K1.roi_align_reference(fmap, nodes, spatial_scale=s),
            K1.roi_align_reference(fmap, unions, spatial_scale=s)),
            iters=3, warmup=1),
        bound_ms=bms, bound_by=bby, library_ms=None, bytes=k1_bytes,
        flops=n_pool * 32, route="f32",
        shape=f"f32 fake map {B}x{H}x{H}x{C}; nodes R={nodes.shape[1]} + "
              f"unions R={unions.shape[1]} (the step's launch pair)")
    taps = 0.0
    for bx in (nodes, unions):
        ny, nx, _, _ = _tap_counts(torch, bx, H, H)
        taps += float((ny.sum(-1) * nx.sum(-1)).sum())
    K1.KERNEL_BWD_FMAP.reset_counts()
    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        worst = 0.0
        for bx in (nodes, unions):
            g = torch.randn(B, bx.shape[1], 7, 7, C, generator=g_).to(
                "cuda", dtype)
            want = K1.roi_align_backward_reference(
                g, bx, (H, H), dtype, spatial_scale=s)
            got = [K1._grad_fmap_kernel(g, bx, (B, H, H, C), dtype, s, 7, 2)
                   for _ in range(2)]
            torch.cuda.synchronize()
            check(torch.equal(got[0], got[1]),
                  f"roi_align_bwd_fmap {dtype}: two launches differ")
            worst = max(worst, rel_err(torch, got[0], want.float()))
            if dtype == torch.float32:
                errs["max_abs_err"] = max(errs.get("max_abs_err", 0.0), float(
                    (got[0] - want).abs().max()))
            del want, got, g
        errs[dtype] = worst
        check(worst <= tol, f"roi_align_bwd_fmap {dtype} at the GAN shape: "
                            f"rel err {worst} > {tol}")
    routes = dict(K1.KERNEL_BWD_FMAP.routes)
    check(routes == {"f32-staged": 4, "bf16-mma": 4},
          f"roi_align_bwd_fmap routes {routes}")
    rows = {}
    for dtype, route in ((torch.float32, "f32-staged"),
                         (torch.bfloat16, "bf16-mma")):
        gs = [torch.randn(B, bx.shape[1], 7, 7, C, generator=g_).to(
            "cuda", dtype) for bx in (nodes, unions)]
        size = gs[0].element_size()
        n_bytes = sum(g.numel() for g in gs) * size + 2 * fmap.numel() * size \
            + (nodes.numel() + unions.numel()) * 4
        ops = 2 * C * taps
        bms, bby = bound_ms(n_bytes, ops, peaks, bf16=False)
        rows[route] = dict(
            ms=time_ms(lambda: [K1._grad_fmap_kernel(
                g, bx, (B, H, H, C), dtype, s, 7, 2)
                for g, bx in zip(gs, (nodes, unions))]),
            plain_ms=time_ms(lambda: [K1.roi_align_backward_reference(
                g, bx, (H, H), dtype, spatial_scale=s)
                for g, bx in zip(gs, (nodes, unions))], iters=3, warmup=1),
            bound_ms=bms, bound_by=bby, bytes=n_bytes, flops=ops)
        del gs
    out["roi_align_bwd_fmap"] = dict(
        max_abs_err=errs["max_abs_err"], f32_rel_err=errs[torch.float32],
        bf16_rel_err=errs[torch.bfloat16], route="f32-staged",
        **rows["f32-staged"], library_ms=None, bf16_mma=rows["bf16-mma"],
        shape=f"g {B}x({nodes.shape[1]} | {unions.shape[1]})x7x7x{C} into a "
              f"{B}x{H}x{H}x{C} map (the step's launch pair)")
    for name, m in out.items():
        extra = (f"; bf16-mma {m['bf16_mma']['ms']:.4f} ms, bound "
                 f"{m['bf16_mma']['bound_ms']:.4f} ms, plain "
                 f"{m['bf16_mma']['plain_ms']:.4f} ms"
                 if "bf16_mma" in m else "")
        print(f"phase 11 {name} at the GAN shape on {m['route']}: "
              f"{m['ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
              f"({m['bound_by']}), plain {m['plain_ms']:.4f} ms; max|err| "
              f"{m['max_abs_err']:.3g}{extra}; the same bits from two "
              f"launches [{m['shape']}]", flush=True)
    del fmap, nodes, unions
    torch.cuda.empty_cache()
    return out


def _grads_received(torch, opts):
    """Each optimizer's gradients as it received them (zeros for none),
    recorded by wrapping its ``apply_gradients``: {tag: [{name: tensor on
    the CPU}, ...]}."""
    log = {}
    for tag, opt in opts.items():
        def apply(real=opt.apply_gradients, opt=opt, tag=tag):
            # copies: the optimizer clips the gradients in place
            log.setdefault(tag, []).append({
                n: (p.grad.detach().float().to("cpu", copy=True)
                    if p.grad is not None else torch.zeros(p.shape))
                for n, p in opt.named})
            return real()
        opt.apply_gradients = apply
    return log


def _gan_parts(names):
    """Parameter names by part: the relation model's top module; G's and
    the Ds' first two (``G.gcn``, ``D_edges.SNConv_0``)."""
    parts = {}
    for n in names:
        p = n.split(".")
        parts.setdefault(".".join(p[:2]) if p[0][0] in "GD" else p[0],
                         []).append(n)
    return parts


def gan_card_vs_cpu(torch, splits, bank=None, phase="11"):
    """11c (and 12d with ``bank``): one f32 GAN step of 2 images at full
    width, card (kernels) against CPU (plain versions), same weights, the
    same sampled edges and perturbed classes (and, with ``bank``, a
    ``vis_cond`` G and the same sample of the bank), dropout off, TF32
    off: losses within ``GAN_LOSS_LIMIT`` relative, the gradients each
    optimizer receives, and their global norms, within ``GAN_GRAD_LIMIT``
    in norm by part (G's and the rec update's within ``GAN_G_LIMIT``)."""
    import copy

    from sgg_torch import constants
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.models.backbone import Dropout
    from sgg_torch.models.gan import GANModel, init_gan_weights
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.assign import sample_edges
    from sgg_torch.train.gan_step import (create_gan_optimizers,
                                          make_gan_train_step)
    from sgg_torch.train.state import Optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    train = splits["train"]
    rel = init_weights(RelModelIMP(num_classes=train.num_classes,
                                   num_predicates=train.num_predicates), 1)
    for mod in rel.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    gan = init_gan_weights(GANModel(train.num_classes, train.num_predicates,
                                    fmap_sz=CANVAS // 16, largeD=True,
                                    vis_cond=bank is not None), 2)
    batch = next(iter(BatchLoader(train, batch_size=2, max_nodes=TRAIN_NODES,
                                  max_edges=TRAIN_EDGES, shuffle=False,
                                  im_scale=constants.IM_SCALE)))
    host = batch.to("cpu")
    edges = sample_edges(torch.Generator().manual_seed(0), host.rels,
                         host.rel_mask, host.node_mask, max_out=TRAIN_EDGES)
    fake = host.classes.clone()
    fake[host.node_mask] = fake[host.node_mask] % (train.num_classes - 1) + 1
    vis = None if bank is None else torch.from_numpy(
        bank.sample(fake.numpy(), host.node_mask.numpy()))

    def run(dev):
        m = copy.deepcopy(rel).to(dev)
        gm = copy.deepcopy(gan).to(dev)
        cfg = gan_config(device=dev, batch_size=2, compute_dtype="float32")
        opt = Optimizer(cfg, m)
        g_opt, d_opt = create_gan_optimizers(cfg, gm)
        got = _grads_received(torch, {"sgg": opt, "G": g_opt, "D": d_opt})
        step = make_gan_train_step(m, gm, cfg, opt, g_opt, d_opt)
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in step(
            batch, fake, None, edges=edges, vis_features=vis).items()}
        return metrics, got, time.perf_counter() - t0

    out, grads, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        out[dev], grads[dev], secs[dev] = run(dev)
    torch.cuda.empty_cache()
    loss_err = {k: abs(out["cuda"][k] - out["cpu"][k])
                / max(abs(out["cpu"][k]), 1e-30) for k in out["cpu"]}
    check(set(out["cuda"]) == set(out["cpu"]) == set(GAN_KEYS),
          f"GAN step keys {sorted(out['cuda'])}")
    counts = {t: len(v) for t, v in grads["cpu"].items()}
    check(counts == {t: len(v) for t, v in grads["cuda"].items()}
          == {"sgg": 2, "G": 1, "D": 1}, f"optimizer updates {counts}")
    grad_err = {}
    for tag in ("sgg", "G", "D"):
        for i, (g, w) in enumerate(zip(grads["cuda"][tag],
                                       grads["cpu"][tag])):
            for p, e in _part_err(torch, g, w, _gan_parts(w)).items():
                grad_err[f"{tag}{i}:{p}"] = e
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:6]
    print(f"phase {phase} GAN step card vs CPU (f32, 2 images, full width, "
          f"largeD{', vis_cond' if bank else ''}, same edges and classes"
          f"{' and vis' if bank else ''}, TF32 off): losses rel err "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in loss_err.items()})}"
          f"; gradients rel err in norm, the largest of "
          f"{len(grad_err)} parts {json.dumps({k: float(f'{v:.3g}') for k, v in worst})}"
          f"; card {secs['cuda']:.2f} s, CPU {secs['cpu']:.2f} s",
          flush=True)
    check(all(v <= (GAN_GRAD_LIMIT if k.startswith("grad_norm")
                    else GAN_LOSS_LIMIT) for k, v in loss_err.items()),
          f"GAN card vs CPU losses differ: {loss_err}")
    check(all(v <= (GAN_G_LIMIT if k.startswith(("G", "sgg1"))
                    else GAN_GRAD_LIMIT) for k, v in grad_err.items()),
          f"GAN card vs CPU gradients differ: {worst}")

    # where G's gap comes from: the card's step again with K1-bwd-fmap's
    # plain version in place of the kernel; and G's backward alone from
    # one fixed map gradient, card against CPU
    from sgg_torch.ops import roi_align as K1
    kernel = K1._grad_fmap_kernel
    K1._grad_fmap_kernel = lambda g, b, shape, dtype, scale, pooled, ratio: \
        K1.roi_align_backward_reference(g, b, shape[1:3], dtype,
                                        spatial_scale=scale, pooled=pooled,
                                        ratio=ratio)
    try:
        plain_g = run("cuda")[1]["G"][0]
    finally:
        K1._grad_fmap_kernel = kernel
    gfix = torch.randn(2, CANVAS // 16, CANVAS // 16, gan.n_ch,
                       generator=torch.Generator().manual_seed(3))
    alone = {}
    for dev in ("cuda", "cpu"):
        gm = copy.deepcopy(gan).to(dev).train()
        fmap = gm.generate(fake.to(dev), (host.boxes / float(CANVAS)).to(dev),
                           host.rels.to(dev), host.node_mask.to(dev),
                           host.rel_mask.to(dev),
                           None if vis is None else vis.to(dev))
        (fmap * gfix.to(dev)).sum().backward()
        alone[dev] = {n: p.grad.float().cpu()
                      for n, p in gm.named_parameters() if n.startswith("G.")}
        del gm, fmap
    torch.cuda.empty_cache()
    fmt = lambda d: json.dumps(  # noqa: E731
        {k: float(f"{v:.3g}") for k, v in sorted(d.items())})
    print(f"phase {phase} where G's gap comes from, rel err in norm by part: "
          f"the step with K1-bwd-fmap's plain version on the card "
          f"{fmt(_part_err(torch, plain_g, grads['cpu']['G'][0], _gan_parts(plain_g)))}"
          f"; G's backward alone from one fixed map gradient "
          f"{fmt(_part_err(torch, alone['cuda'], alone['cpu'], _gan_parts(alone['cpu'])))}",
          flush=True)


def phase_gan(torch, peaks, rows, splits):
    """Phase 11: GAN-augmented training at full width."""
    t0 = time.perf_counter()
    n, host, rate = gan_train(torch, splits)
    for name, m in gan_kernels(torch, peaks, host).items():
        rows[name]["gan"] = m
    gan_card_vs_cpu(torch, splits)
    print(f"phase 11 GAN training in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"gan_train_epoch": n}, rate


# ---------------------------------------------------------------------------
# phase 12: the GAN's feature-bank conditioning (-vis_cond) and its analysis

VIS_DEADLINE_S = 300
EXTRACT_BATCH = 8  # extract_features' batch
# the extraction forward, card against CPU (f32, TF32 off, 2 images): the
# pools' largest difference over their largest magnitude
POOL_LIMIT = 1e-4
# the distance matrices card against CPU, squared (near 0 the square root
# magnifies the rounding of |a|^2 + |b|^2 - 2ab), relative to the largest
DIST_LIMIT = 1e-4
# per step as phase 11: the bank's features add no kernel launch
VIS_ROUTES = GAN_ROUTES
# an extraction batch: K2 once and K1 twice (nodes and unions), bf16
EXTRACT_ROUTES = {"roi_align": {"bf16": 2}, "roi_align_bwd_fmap": {},
                  "roi_align_bwd_boxes": {}, "vgg_conv1": {"bf16": 1},
                  "vgg_conv1_bwd": {}, "conv_epilogue": trunk_routes(1)}


def vis_extract(torch, splits):
    """12a: ``extract_features``' forward (batch 8, bf16) over the train
    split on the card, counted, with images/s and the pools' copy to the
    host; the pools card against CPU on 2 images (f32); one forward under
    ``set_sync_debug_mode("error")``. Returns the launches and the pools by
    class name, (n, 7 * 7 * 512) float32 rows as the writer stores them."""
    import copy

    import numpy as np

    from sgg_torch import constants
    from sgg_torch.config import config_from_args
    from sgg_torch.data.pipeline import BatchLoader, to_image_dtype
    from sgg_torch.extract_features import batch_pools, make_pools_step
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config_from_args(["-m", "sgcls", "-max_nodes", str(TRAIN_NODES),
                            "-max_edges", str(TRAIN_EDGES)])
    trainer = Trainer(cfg, splits)
    train = splits["train"]
    list(batch_pools(trainer, n_batches=1, batch_size=EXTRACT_BATCH))
    torch.cuda.synchronize()
    by_class = {}
    t0 = time.perf_counter()

    def run():
        for pools, classes, mask in batch_pools(trainer,
                                                batch_size=EXTRACT_BATCH):
            for c in np.unique(classes[mask]):
                by_class.setdefault(train.ind_to_classes[c], []).append(
                    pools[mask & (classes == c)].reshape(-1, 7 * 7 * 512))

    _, n, routes = _counted(torch, run)
    secs = time.perf_counter() - t0
    pools = {k: np.concatenate(v) for k, v in by_class.items()}
    n_rows = sum(len(v) for v in pools.values())
    batches = math.ceil(len(train) / EXTRACT_BATCH)
    want = {k: {r: c * batches for r, c in v.items()}
            for k, v in EXTRACT_ROUTES.items()}
    check(routes == want, f"extraction launched {routes}; want {want}")
    check(n_rows == sum(len(c) for c in train.gt_classes)
          and all(np.isfinite(v).all() for v in pools.values()),
          f"{n_rows} pooled rows, not finite or not one an object")

    host = next(iter(BatchLoader(train, batch_size=EXTRACT_BATCH,
                                 max_nodes=TRAIN_NODES,
                                 max_edges=TRAIN_EDGES, shuffle=False,
                                 im_scale=constants.IM_SCALE)))
    host = to_image_dtype(host, cfg.compute_dtype)
    step = make_pools_step(trainer.model, "cuda")
    dev_pools = step(host)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dev_pools.cpu()
    copy_ms = (time.perf_counter() - t1) * 1e3
    step(host)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"phase 12 extract_features forward over {len(train)} images "
          f"(batch {EXTRACT_BATCH}, bf16): {secs:.3f} s = "
          f"{len(train) / secs:.2f} images/s with the host; {n_rows} pooled "
          f"objects in {len(pools)} classes; launches {json.dumps(n)} by "
          f"route {json.dumps(routes)}; the copy of a batch's pools to the "
          f"host ({dev_pools.numel() * 4 / 2**20:.1f} MiB f32) {copy_ms:.3f} "
          f"ms; a forward under set_sync_debug_mode('error'): no host sync",
          flush=True)
    del trainer, step, dev_pools

    torch.backends.cudnn.allow_tf32 = False
    two = next(iter(BatchLoader(train, batch_size=2, max_nodes=TRAIN_NODES,
                                max_edges=TRAIN_EDGES, shuffle=False,
                                im_scale=constants.IM_SCALE)))
    model = init_weights(RelModelIMP(num_classes=train.num_classes,
                                     num_predicates=train.num_predicates), 3)
    got = make_pools_step(copy.deepcopy(model).cuda(), "cuda")(two).cpu()
    want = make_pools_step(model, "cpu")(two)
    err = rel_err(torch, got, want)
    print(f"phase 12 extraction forward card vs CPU (f32, 2 images, TF32 "
          f"off): pools max|err| / max|pool| {err:.3g} (limit {POOL_LIMIT})",
          flush=True)
    check(err <= POOL_LIMIT, f"extraction pools card vs CPU: {err}")
    del model, got, want
    torch.cuda.empty_cache()
    return n, pools


def vis_bank(torch, splits, pools, seed):
    """12b: the reservoirs filled from 12a's pools through the draw that
    ``FeatureBank`` runs after its h5 read; one ``sample`` at 24 x 40 and
    its pinned copy, timed."""
    import numpy as np

    from sgg_torch import constants
    from sgg_torch.augment.feature_bank import FeatureBank
    from sgg_torch.data.pipeline import BatchLoader

    train = splits["train"]
    t0 = time.perf_counter()
    bank = FeatureBank._from_pools(pools, train.ind_to_classes, seed=seed)
    fill_ms = (time.perf_counter() - t0) * 1e3
    host = next(iter(BatchLoader(train, batch_size=TRAIN_BATCH,
                                 max_nodes=TRAIN_NODES,
                                 max_edges=TRAIN_EDGES, shuffle=False,
                                 im_scale=constants.IM_SCALE)))
    classes, mask = np.asarray(host.classes), np.asarray(host.node_mask)
    sample_ms, pin_ms, copy_ms = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        vis = bank.sample(classes, mask)
        t1 = time.perf_counter()
        pinned = torch.from_numpy(vis).pin_memory()
        t2 = time.perf_counter()
        pinned.to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        sample_ms.append((t1 - t0) * 1e3)
        pin_ms.append((t2 - t1) * 1e3)
        copy_ms.append((t3 - t2) * 1e3)
    check(vis.shape == (TRAIN_BATCH, TRAIN_NODES, 7, 7, 512)
          and vis[mask].any(axis=(1, 2, 3)).all() and not vis[~mask].any(),
          "bank samples: a valid node without features or padding with")
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    print(f"phase 12 bank from 12a's pools: {len(bank.reservoir)} classes, "
          f"{sum(len(r) for r in bank.reservoir.values())} reservoir rows, "
          f"filled in {fill_ms:.1f} ms; one sample at {TRAIN_BATCH} x "
          f"{TRAIN_NODES} ({vis.nbytes / 1e6:.1f} MB f32), median of 5: "
          f"{med(sample_ms):.2f} ms numpy gather, {med(pin_ms):.2f} ms into "
          f"pinned memory, {med(copy_ms):.2f} ms copy to the card", flush=True)
    return bank


def vis_train(torch, splits, bank, gan_rate):
    """12c: ``Trainer`` with phase 11's command and ``-vis_cond`` (the bank
    of 12b in place of the file's read): a warm-up epoch, one counted and
    timed epoch, a step under ``set_sync_debug_mode("error")``, a step
    timed by phase with its peak memory, what moved."""
    import sgg_torch.augment.feature_bank as fb
    from sgg_torch import constants
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gan_config(vis_cond="<12b's bank>")
    real_bank = fb.FeatureBank
    fb.FeatureBank = lambda path, names, pool_sz, n_ch, seed: bank
    try:
        trainer = Trainer(cfg, splits)
    finally:
        fb.FeatureBank = real_bank
    model, gan = trainer.model, trainer.gan
    steps = trainer.steps_per_epoch
    check(trainer.feature_bank is bank and gan.G.vis_cond
          and gan.G.proj.in_channels == gan.n_ch + gan.G.hidden_dim,
          "the conditioned GAN is not wired to the bank")
    trunk0 = _snapshot(model, lambda n: n.startswith("trunk."))
    proj0 = gan.G.proj.weight.detach().clone()
    host_s = []
    real_inputs = trainer._gan_host_inputs

    def timed_inputs(batch, epoch):
        t0 = time.perf_counter()
        out = real_inputs(batch, epoch)
        host_s.append(time.perf_counter() - t0)
        return out

    trainer._gan_host_inputs = timed_inputs
    trainer.train_epoch(0)
    torch.cuda.synchronize()
    host_s.clear()
    t0 = time.perf_counter()
    losses, n, routes = _counted(torch, lambda: trainer.train_epoch(1))
    loop_s = time.perf_counter() - t0
    rate = steps * TRAIN_BATCH / loop_s
    print(f"phase 12 conditioned GAN train_epoch: {steps} steps x "
          f"{TRAIN_BATCH} images in {loop_s:.3f} s = {rate:.2f} train "
          f"images/s (host included), phase 11's unconditioned "
          f"{gan_rate:.2f} in this run ({100 * (rate / gan_rate - 1):+.1f}%); "
          f"the host's perturbation and bank sample "
          f"{1e3 * sum(host_s) / len(host_s):.2f} ms a batch; losses "
          f"{json.dumps(losses)}; launches {json.dumps(n)} by route "
          f"{json.dumps(routes)}", flush=True)
    check(all(k in losses and math.isfinite(losses[k]) for k in GAN_KEYS),
          f"conditioned GAN losses missing or not finite: {losses}")
    want = {k: {r: c * steps for r, c in v.items()}
            for k, v in VIS_ROUTES.items()}
    check(routes == want and n == {k: sum(v.values())
                                   for k, v in want.items()},
          f"{steps} conditioned GAN steps launched {n} by route {routes}; "
          f"want {want}")
    # the host inputs in the trainer's thread against inline in this one
    # (the trainer's ``background`` replaced by the identity), in turns
    import sgg_torch.train.trainer as trainer_mod
    threaded = trainer_mod.background
    turns = {"thread": [], "inline": []}
    for i, mode in enumerate(("thread", "inline", "inline", "thread")):
        if mode == "inline":
            trainer_mod.background = lambda items, size=2: items
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for epoch in (2 + 2 * i, 3 + 2 * i):  # 2 epochs a turn
                trainer.train_epoch(epoch)
            torch.cuda.synchronize()
            turns[mode].append(2 * steps * TRAIN_BATCH
                               / (time.perf_counter() - t0))
        finally:
            trainer_mod.background = threaded
    print(f"phase 12 conditioned GAN epochs in turns (thread, inline, "
          f"inline, thread), train images/s with the host: the host inputs "
          f"in the trainer's thread {[round(r, 2) for r in turns['thread']]}"
          f", inline in the loop's {[round(r, 2) for r in turns['inline']]}",
          flush=True)

    host = next(iter(BatchLoader(
        splits["train"], batch_size=TRAIN_BATCH, max_nodes=TRAIN_NODES,
        max_edges=TRAIN_EDGES, shuffle=False, im_scale=constants.IM_SCALE,
        image_format=cfg.image_format)))
    item = real_inputs(host, 2).to("cuda")
    check(item.vis is not None
          and item.vis.device == item.fake_classes.device,
          "the bank's sample did not reach the card with the batch")
    gen = torch.Generator(device="cuda").manual_seed(1)
    step = lambda **kw: trainer.gan_step(  # noqa: E731
        item.batch, item.fake_classes, gen, vis_features=item.vis, **kw)
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    by_phase = {"F": [], "G": [], "D": [], "wall": []}
    for _ in range(5):
        ev = {k: torch.cuda.Event(enable_timing=True)
              for k in ("start", "F", "G", "D")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev["start"].record()
        step(mark=lambda phase, ev=ev: ev[phase].record())
        torch.cuda.synchronize()
        by_phase["wall"].append((time.perf_counter() - t0) * 1e3)
        for a, b in (("start", "F"), ("F", "G"), ("G", "D")):
            by_phase[b].append(ev[a].elapsed_time(ev[b]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = {k: sorted(v)[len(v) // 2] for k, v in by_phase.items()}
    print(f"phase 12 one conditioned GAN step on a batch on the card, median "
          f"of 5 by phase (CUDA events): F {med['F']:.3f} ms, G "
          f"{med['G']:.3f} ms, D {med['D']:.3f} ms; the step "
          f"{med['wall']:.3f} ms wall; peak device memory {peak:.2f} GiB; a "
          f"step under set_sync_debug_mode('error'): no host sync",
          flush=True)
    changed = [k for k, t in _snapshot(model, trunk0.__contains__).items()
               if not torch.equal(t, trunk0[k])]
    check(not changed, f"trunk changed: {changed[:5]}")
    check(not torch.equal(gan.G.proj.weight.detach(), proj0),
          "G's projection did not move")
    print(f"phase 12 trunk bit-unchanged ({len(trunk0)} tensors); G's "
          f"{tuple(proj0.shape)} projection moved", flush=True)
    gan.eval()
    return n, trainer


def vis_analysis(torch, splits, bank, trainer, e):
    """12e: FID and PRDC between the bank's real node pools and K1's node
    pools of the trained G's fake maps over the train split (each pool's
    7 x 7 mean, 512-d), the distance matrices on the card against the CPU;
    and the on-device Recall@K on phase 4's eval batch ``e`` against the
    numpy evaluator."""
    import numpy as np

    from sgg_torch import constants
    from sgg_torch.augment import gan_eval
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.eval.recall_jit import batch_recall
    from sgg_torch.eval.sgg_eval import SGGEvaluator
    from sgg_torch.eval.surgery import filter_dets
    from sgg_torch.ops import roi_align as K1

    gan = trainer.gan
    fake_rows = []
    loader = BatchLoader(splits["train"], batch_size=TRAIN_BATCH,
                         max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                         shuffle=False, im_scale=constants.IM_SCALE)
    with torch.no_grad():
        for host in loader:
            item = trainer._gan_host_inputs(host, 3).to("cuda")
            b = item.batch
            fmap = gan.generate(item.fake_classes, b.boxes / float(CANVAS),
                                b.rels, b.node_mask, b.rel_mask,
                                item.vis)
            pools = K1.roi_align(fmap, b.boxes.float().contiguous(),
                                 spatial_scale=1 / 16)
            fake_rows.append(pools[b.node_mask].mean(dim=(1, 2)).cpu())
    fake = torch.cat(fake_rows).numpy()
    real = np.concatenate([r.reshape(-1, 49, 512).mean(1)
                           for r in bank.reservoir.values()])
    fid = gan_eval.compute_fid(fake, real)
    prdc = {dev: gan_eval.compute_prdc(real, fake, device=dev)
            for dev in ("cuda", "cpu")}
    err = 0.0
    for a, b_ in ((real, None), (real, fake), (fake, None)):
        d = {dev: gan_eval._pairwise_distance(a, b_, device=dev).astype(
            np.float64) ** 2 for dev in ("cuda", "cpu")}
        err = max(err, float(np.abs(d["cuda"] - d["cpu"]).max()
                             / d["cpu"].max()))
    print(f"phase 12 FID {fid:.4f} and PRDC {json.dumps(prdc['cuda'])} of "
          f"{len(fake)} fake node pools (K1 on the trained G's maps) "
          f"against {len(real)} real ones (the bank), 512-d pool means; the "
          f"squared distances card vs CPU max rel err {err:.3g} (limit "
          f"{DIST_LIMIT}); PRDC card "
          f"{'==' if prdc['cuda'] == prdc['cpu'] else '!='} CPU", flush=True)
    check(math.isfinite(fid) and fid >= 0, f"FID {fid}")
    check(err <= DIST_LIMIT, f"distances card vs CPU: {err}")
    check(prdc["cuda"] == prdc["cpu"],
          f"PRDC card {prdc['cuda']} vs CPU {prdc['cpu']}")

    ks = (20, 50, 100)
    h = {k: v.cpu().numpy() for k, v in e.items()}
    # the sgcls regime as evaluated, and predcls on the same relation
    # scores (the GT classes, unit object scores), where there are hits
    regimes = {"sgcls": (e["obj_preds"], e["obj_scores"]),
               "predcls": (e["classes"], torch.ones_like(e["obj_scores"]))}
    for mode, (cls, scores) in regimes.items():
        args = (e["boxes"], cls, scores, e["pairs"], e["pair_mask"],
                e["rel_dists"], e["boxes"], e["classes"], e["rels"],
                e["rel_mask"])
        got = batch_recall(*args, ks=ks)
        rec_ms = time_ms(lambda: batch_recall(*args, ks=ks), iters=10)
        hc, hs = cls.cpu().numpy(), scores.cpu().numpy()
        t0 = time.perf_counter()
        host_r, imgs = {k: [] for k in ks}, []
        for i in range(len(h["boxes"])):
            n_i, rm = int(h["node_mask"][i].sum()), h["rel_mask"][i]
            if not rm.any():
                continue
            pm = h["pair_mask"][i]
            ev = SGGEvaluator(mode, ks=ks)
            ev.add_image({"gt_relations": h["rels"][i][rm],
                          "gt_boxes": h["boxes"][i][:n_i],
                          "gt_classes": h["classes"][i][:n_i]},
                         filter_dets(h["boxes"][i][:n_i], hs[i][:n_i],
                                     hc[i][:n_i], h["pairs"][i][pm],
                                     h["rel_dists"][i][pm],
                                     np.ones(pm.sum(), bool)))
            imgs.append(i)
            for k in ks:
                host_r[k].append(ev.recalls[k][0])
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_r = {k: got[k].cpu().numpy()[imgs] for k in ks}
        print(f"phase 12 on-device graph-constrained recall ({mode} regime) "
              f"over phase 4's eval batch ({len(imgs)} images with "
              f"relations): R@20/50/100 "
              f"{[float(dev_r[k].mean()) for k in ks]}, the numpy "
              f"evaluator's {[float(np.mean(host_r[k])) for k in ks]}; "
              f"batch_recall {rec_ms:.3f} ms on the card, the host evaluator "
              f"{host_ms:.1f} ms", flush=True)
        check(imgs and all(np.allclose(dev_r[k], host_r[k], atol=1e-6)
                           for k in ks),
              f"{mode}: on-device recall {dev_r} != the evaluator's "
              f"{host_r}")


def phase_vis_cond(torch, splits, gan_rate, eval_batch):
    """Phase 12: the GAN's feature-bank conditioning and its analysis at
    full width (``eval_batch``: phase 4's, for the recall)."""
    t0 = time.perf_counter()
    n_extract, pools = vis_extract(torch, splits)
    bank = vis_bank(torch, splits, pools, seed=gan_config().seed)
    del pools
    n_train, trainer = vis_train(torch, splits, bank, gan_rate)
    vis_analysis(torch, splits, bank, trainer, eval_batch)
    del trainer
    torch.cuda.empty_cache()
    gan_card_vs_cpu(torch, splits, bank=bank, phase="12")
    print(f"phase 12 feature-bank conditioning in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"extract_features": n_extract,
            "gan_vis_cond_train_epoch": n_train}

# ---------------------------------------------------------------------------
# phase 13: data-parallel training and evaluation (sgg_torch.parallel)

DP_DEADLINE_S = 300
# each spawned rank ends within this, or the phase fails
DP_JOIN_S = 240
# 13b: two ranks of 12 images against one process of 24, f32 with TF32
# off: the losses relative; the updated tensors' largest difference over
# the largest update (cuBLAS may tile a 12-row and a 24-row product
# differently); the GAN's losses relative (tests/test_distributed.py's)
DP_LOSS_LIMIT, DP_UPDATE_LIMIT, DP_GAN_LIMIT = 1e-5, 1e-5, 2e-4
# an sgcls step in f32: K2 once, K1 twice; a GAN step in f32 adds four K1
# launches on the fake map and K1-bwd-fmap twice
DP_ROUTES = {"roi_align": {"f32": 2}, "vgg_conv1": {"f32": 1},
             "conv_epilogue": trunk_routes(1, "f32")}
DP_GAN_ROUTES = {"roi_align": {"f32": 6},
                 "roi_align_bwd_fmap": {"f32-staged": 2},
                 "vgg_conv1": {"f32": 1},
                 "conv_epilogue": trunk_routes(1, "f32")}


def _state(trainer):
    """Every trainable tensor, BatchNorm statistic and momentum buffer of
    the relation model (the frozen trunk left out), cloned."""
    out = {n: t.detach().clone() for n, t in
           list(trainer.model.named_parameters())
           + list(trainer.model.named_buffers())
           if not n.startswith("trunk.")}
    out.update({f"momentum/{n}": t.clone()
                for n, t in trainer.optimizer.state_dict().items()})
    return out


def _bits(torch, t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def dp_one_rank(torch, splits, train_rate):
    """13a: phase 5's training (bf16, batch 24) and one sgcls
    ``val_epoch`` batch under a 1-rank NCCL group and with no group, from
    the same state, under deterministic algorithms: the same bits."""
    import shutil
    import tempfile

    from sgg_torch import parallel
    from sgg_torch.config import Config
    from sgg_torch.eval.driver import val_epoch
    from sgg_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="sgg_dp1_")
    # the host group's gloo meets on the loopback: one host, no network
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    group = parallel.init_group(f"file://{tmp}/store", 1, 0,
                                torch.device("cuda", 0), "nccl",
                                timeout_s=DP_DEADLINE_S)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        config = Config(mode="sgcls", loss="dnorm", batch_size=TRAIN_BATCH,
                        max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES,
                        compute_dtype="bfloat16", device="cuda",
                        print_interval=2, num_workers=4)
        t0 = time.perf_counter()
        trainer = Trainer(config, splits, group=group)
        build_s = time.perf_counter() - t0
        steps = trainer.steps_per_epoch
        snap = _snapshot_all(trainer)
        trainer.train_epoch(0)  # warm-up of the group's collectives
        runs = {}
        for name, g in (("group", group), ("none", None)):
            _restore_all(trainer, snap)
            trainer.group = g
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, n, routes = _counted(
                torch, lambda: trainer.train_epoch(0))
            dt = time.perf_counter() - t0
            res, n_eval, _ = _counted(torch, lambda: val_epoch(
                trainer.model, splits["test_alls"], config, "test_alls",
                n_batches=1, verbose=False, device="cuda", group=g))
            runs[name] = {"losses": losses, "state": _state(trainer),
                          "metrics": {k: v for k, v in res.items()
                                      if not k.startswith("_")},
                          "n": n, "routes": routes, "n_eval": n_eval,
                          "s": dt}
        a, b = runs["group"], runs["none"]
        differ = [k for k, t in a["state"].items()
                  if not torch.equal(_bits(torch, t),
                                     _bits(torch, b["state"][k]))]
        rate = {k: steps * TRAIN_BATCH / r["s"] for k, r in runs.items()}
        print(f"phase 13a 1-rank NCCL group against no group ({steps} "
              f"steps x {TRAIN_BATCH} images, bf16, dropout on, the sampler "
              f"drawing; deterministic algorithms): losses "
              f"{json.dumps(a['losses'])} group, "
              f"{json.dumps(b['losses'])} none; {len(a['state'])} tensors, "
              f"{len(differ)} differ in bits; sgcls val_epoch (1 batch of "
              f"16) metrics {'==' if a['metrics'] == b['metrics'] else '!='};"
              f" launches train {json.dumps(a['n'])} by route "
              f"{json.dumps(a['routes'])}, eval {json.dumps(a['n_eval'])}; "
              f"trainer built in {build_s:.1f} s", flush=True)
        print(f"phase 13a train images/s (host included) group "
              f"{rate['group']:.2f} ({a['s'] / steps * 1e3:.1f} ms a step),"
              f" no group {rate['none']:.2f} "
              f"({b['s'] / steps * 1e3:.1f} ms), both under deterministic "
              f"algorithms; phase 5's in this run {train_rate:.2f}",
              flush=True)
        check(a["losses"] == b["losses"],
              f"losses differ: {a['losses']} vs {b['losses']}")
        check(not differ, f"state differs in bits: {differ[:5]}")
        check(a["metrics"] == b["metrics"] and a["metrics"],
              "val_epoch metrics differ under the group")
        check(a["n"] == b["n"] == {**{k: 0 for k in a["n"]},
                                   "roi_align": 2 * steps,
                                   "vgg_conv1": steps,
                                   "conv_epilogue": 12 * steps}
              and a["routes"]["roi_align"] == {"bf16": 2 * steps}
              and a["routes"]["vgg_conv1"] == {"bf16": steps},
              f"{steps} steps launched {a['n']} by route {a['routes']}")
        check(a["n_eval"] == b["n_eval"] and a["n_eval"]["vgg_conv1"] == 2
              and a["n_eval"]["roi_align"] == 4,
              f"one eval batch, two regimes: launches {a['n_eval']}")
        del trainer
        torch.cuda.empty_cache()
        return {"dp_train_1rank": a["n"], "dp_eval_1rank": a["n_eval"]}
    finally:
        torch.use_deterministic_algorithms(False)
        parallel.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def _snapshot_all(trainer):
    """Everything a step changes (the models, the optimizers' states and
    counts), copied."""
    import copy
    snap = {"model": trainer.model.state_dict(),
            "opt": trainer.optimizer.state_dict(),
            "count": trainer.optimizer.count}
    if trainer.gan is not None:
        snap.update(gan=trainer.gan.state_dict(),
                    g_opt=trainer.g_opt.state_dict(),
                    d_opt=trainer.d_opt.state_dict())
    return copy.deepcopy(snap)


def _restore_all(trainer, snap):
    trainer.model.load_state_dict(snap["model"])
    trainer.optimizer.load_state_dict(snap["opt"])
    trainer.optimizer.count = snap["count"]
    if trainer.gan is not None:
        trainer.gan.load_state_dict(snap["gan"])
        trainer.g_opt.load_state_dict(snap["g_opt"])
        trainer.d_opt.load_state_dict(snap["d_opt"])


def _dp_step(torch, trainer):
    """One counted, timed epoch (one step) of ``trainer``: the losses, the
    launches, their routes, the seconds and the state after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, n, routes = _counted(torch, lambda: trainer.train_epoch(0))
    dt = time.perf_counter() - t0
    after = _state(trainer)
    if trainer.gan is not None:
        after.update({f"gan/{k}": v.detach().clone()
                      for k, v in trainer.gan.state_dict().items()})
    return {"losses": losses, "n": n, "routes": routes, "s": dt,
            "after": after}


def _update_err(before, dp, ref, keep):
    """Over the relation model's tensors that ``keep`` names: the largest
    difference from one process over the largest update, and where."""
    diff, upd, where = 0.0, 0.0, ""
    for k, want in ref.items():
        if not keep(k):
            continue
        upd = max(upd, float((want - before[k]).abs().max()))
        d = float((dp[k] - want).abs().max())
        if d > diff:
            diff, where = d, k
    return diff / max(upd, 1e-30), where


def dp_rank(group):
    """13b, one rank of two sharing the card over gloo: the sgcls step,
    then the GAN step, each on the rank's 12 rows of a 24-image batch;
    rank 0 then takes the same step from the same state as one process
    on all 24 and compares. Returns what the parent prints and checks."""
    import torch
    from sgg_torch import parallel
    from sgg_torch.config import Config
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    splits = synthetic_splits(num_train=TRAIN_BATCH, num_eval=4)
    one_step = dict(compute_dtype="float32", device="cuda:0",
                    print_interval=1, val_size=0, notest=True)
    cfg = Config(mode="sgcls", loss="dnorm", batch_size=TRAIN_BATCH,
                 max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES, num_workers=4,
                 **one_step)
    gcfg = gan_config(**one_step)
    out = {}
    for kind, c in (("sgcls", cfg), ("gan", gcfg)):
        t0 = time.perf_counter()
        trainer = Trainer(c, splits, group=group)
        build_s = time.perf_counter() - t0
        snap, before = _snapshot_all(trainer), _state(trainer)
        dp = _dp_step(torch, trainer)
        # both ranks hold the same state after the step
        differ = sum(not parallel.bits_equal_to_rank0(t, group)
                     for t in dp["after"].values())
        out[kind] = {"losses": dp["losses"], "n": dp["n"],
                     "routes": dp["routes"], "s": dp["s"],
                     "build_s": build_s, "differ_from_rank0": differ}
        if group.rank == 0:
            _restore_all(trainer, snap)
            trainer.group = None
            ref = _dp_step(torch, trainer)
            # the updated parameters and BatchNorm statistics; and the
            # momentum buffers (the clipped gradients plus weight decay)
            def stats(k):
                return not (k.startswith(("momentum/", "gan/"))
                            or "num_batches" in k)

            out[kind].update(
                ref_losses=ref["losses"], ref_s=ref["s"],
                update_err=_update_err(before, dp["after"], ref["after"],
                                       stats),
                momentum_err=_update_err(
                    before, dp["after"], ref["after"],
                    lambda k: k.startswith("momentum/")))
        del trainer
        torch.cuda.empty_cache()
        parallel.sync_processes(f"dp_{kind}")
    return out


def _loss_errs(got, want):
    """Each loss's relative difference from one process's (the gradient
    norms left out)."""
    return {k: abs(got[k] - w) / max(abs(w), 1e-30) for k, w in want.items()
            if not k.startswith("grad")}


def dp_two_ranks(torch):
    """13b: two ranks sharing the one card over gloo (spawned; a file store
    in a temporary directory), f32 with TF32 off, against one process on
    the same global batch: the sgcls step and a ``-gan -largeD -perturb
    graphn`` step."""
    from sgg_torch import parallel

    t0 = time.perf_counter()
    res = parallel.spawn(dp_rank, 2, device="cuda:0", backend="gloo",
                         timeout_s=DP_JOIN_S,
                         collective_timeout_s=DP_JOIN_S)
    paths = {}
    for kind, routes_a_step, limit in (("sgcls", DP_ROUTES, DP_LOSS_LIMIT),
                                       ("gan", DP_GAN_ROUTES, DP_GAN_LIMIT)):
        r0 = res[0][kind]
        ref = r0["ref_losses"]
        errs = _loss_errs(r0["losses"], ref)
        print(f"phase 13b {kind} step, 2 ranks x {TRAIN_BATCH // 2} images "
              f"against 1 process x {TRAIN_BATCH} (f32, TF32 off, dropout "
              f"on, the sampler drawing): losses rel err "
              f"{json.dumps(errs)} (limit {limit}); the updated relation "
              f"model's parameters and BatchNorm statistics: the largest "
              f"difference from one process over the largest update "
              f"{r0['update_err'][0]:.3g} (at {r0['update_err'][1]}; limit "
              f"{DP_UPDATE_LIMIT}), its momentum buffers' "
              f"{r0['momentum_err'][0]:.3g} (at {r0['momentum_err'][1]}); "
              f"trainers built in "
              f"{json.dumps([round(r[kind]['build_s'], 1) for r in res])} s;"
              f" launches "
              f"a rank {json.dumps([r[kind]['n'] for r in res])} by route "
              f"{json.dumps([r[kind]['routes'] for r in res])}; step "
              f"{json.dumps([round(r[kind]['s'] * 1e3, 1) for r in res])} "
              f"ms a rank, 1 process {r0['ref_s'] * 1e3:.1f} ms (2 ranks on "
              f"one card over gloo: not a scaling figure)", flush=True)
        check(res[0][kind]["losses"] == res[1][kind]["losses"],
              f"{kind}: the ranks log different losses")
        check(all(r[kind]["differ_from_rank0"] == 0 for r in res),
              f"{kind}: the ranks' states differ after the step")
        check(all(e <= limit for e in errs.values()),
              f"{kind}: losses {r0['losses']} vs one process {ref}")
        if kind == "sgcls":
            check(r0["update_err"][0] <= DP_UPDATE_LIMIT,
                  f"update differs from one process: {r0['update_err']}")
        for rk, r in enumerate(res):
            want = {k: routes_a_step.get(k, {}) for k in r[kind]["routes"]}
            check(r[kind]["routes"] == want,
                  f"{kind} rank {rk} launched by route "
                  f"{r[kind]['routes']}, want {want}")
        paths[f"dp_{kind}_2ranks"] = {
            k: sum(r[kind]["n"][k] for r in res) for k in res[0][kind]["n"]}
    print(f"phase 13b two ranks in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


def phase_data_parallel(torch, splits, train_rate):
    """Phase 13: data-parallel training and evaluation. Returns the paths'
    launches."""
    t0 = time.perf_counter()
    paths = dp_one_rank(torch, splits, train_rate)
    paths.update(dp_two_ranks(torch))
    print(f"phase 13 data parallel in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 14: multi-process SGDet training

MESH_DEADLINE_S = 300
# each spawned rank ends within this, or the phase fails
MESH_JOIN_S = 240
# 14a: SGDet steps under a 1-rank NCCL group, at phase 7's train shape
SGDET_DP_STEPS = 2
# 14b: two ranks against one process, f32 with TF32 off: the losses
# relative; the updated tensors within DP_UPDATE_LIMIT (13b's) of the
# largest update
MESH_LOSS_LIMIT = 1e-6
# a step a rank in f32: SGDet's K1 on the detector's RoIs, the nodes and
# the unions, K2 once
SGDET_ROUTES = {"roi_align": {"f32": 3}, "vgg_conv1": {"f32": 1},
                "conv_epilogue": trunk_routes(1, "f32")}


def _sgdet_config(**kw):
    from sgg_torch.config import Config
    return Config(mode="sgdet", loss="dnorm", batch_size=SGDET_TRAIN_BATCH,
                  print_interval=1, num_workers=4, **kw)


def sgdet_one_rank(torch):
    """14a: phase 7's SGDet training (VGG16 detector, batch 6, bf16) for
    ``SGDET_DP_STEPS`` steps under a 1-rank NCCL group and with no group,
    from the same state, under deterministic algorithms: the same bits."""
    import shutil
    import tempfile

    from sgg_torch import parallel
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="sgg_sgdet1_")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    group = parallel.init_group(f"file://{tmp}/store", 1, 0,
                                torch.device("cuda", 0), "nccl",
                                timeout_s=MESH_DEADLINE_S)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        splits = synthetic_splits(
            num_train=SGDET_DP_STEPS * SGDET_TRAIN_BATCH, num_eval=4)
        config = _sgdet_config(compute_dtype="bfloat16", device="cuda")
        trainer = Trainer(config, splits, detector=sgdet_detector(
            torch, splits["train"].num_classes), group=group)
        steps = trainer.steps_per_epoch
        snap = _snapshot_all(trainer)
        runs = {}
        for name, g in (("group", group), ("none", None)):
            _restore_all(trainer, snap)
            trainer.group = g
            losses, n, routes = _counted(
                torch, lambda: trainer.train_epoch(0))
            runs[name] = {"losses": losses, "state": _state(trainer),
                          "n": n, "routes": routes}
        a, b = runs["group"], runs["none"]
        differ = [k for k, t in a["state"].items()
                  if not torch.equal(_bits(torch, t),
                                     _bits(torch, b["state"][k]))]
        print(f"phase 14a sgdet under a 1-rank NCCL group against no group "
              f"({steps} steps x {SGDET_TRAIN_BATCH} images, VGG16 "
              f"detector, bf16, dropout on, the sampler drawing; "
              f"deterministic algorithms): losses {json.dumps(a['losses'])} "
              f"group, {json.dumps(b['losses'])} none; {len(a['state'])} "
              f"relation-model tensors and momentum buffers, {len(differ)} "
              f"differ in bits; launches {json.dumps(a['n'])} by route "
              f"{json.dumps(a['routes'])}", flush=True)
        check(steps == SGDET_DP_STEPS, f"{steps} steps, want "
              f"{SGDET_DP_STEPS}")
        check(a["losses"] == b["losses"],
              f"losses differ: {a['losses']} vs {b['losses']}")
        check(not differ, f"state differs in bits: {differ[:5]}")
        check(a["n"] == b["n"] == {"roi_align": 3 * steps,
                                   "vgg_conv1": steps, **NO_BACKWARD,
                                   "conv_epilogue": 12 * steps}
              and a["routes"]["roi_align"] == {"bf16": 3 * steps}
              and a["routes"]["vgg_conv1"] == {"bf16": steps},
              f"{steps} steps launched {a['n']} by route {a['routes']}")
        del trainer
        torch.cuda.empty_cache()
        return {"sgdet_train_1rank": a["n"]}
    finally:
        torch.use_deterministic_algorithms(False)
        parallel.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def _recording_detector(trainer, out):
    """Record the boxes and labels of each detector pass of ``trainer``
    in ``out`` (host copies)."""
    det = trainer.detector
    forward = det.forward

    def recorded(*a, **kw):
        res = forward(*a, **kw)
        out.append({k: res[k].cpu().numpy() for k in ("boxes", "labels")})
        return res

    det.forward = recorded


class _ReluGates:
    """Every ``F.relu`` of ``models/backbone.py`` and ``models/relhead.py``
    on a (B, R, D) input (the RoI heads of the detector and of the
    relation model, IMP's edge projection) inside the block: with
    ``record``, each input is appended to it (a copy); with ``force``, a
    list of masks in call order, each ReLU passes its input where the mask
    holds and gives 0 elsewhere (a ReLU with those gates). In f32 an input
    within rounding of 0 can gate one way on the ranks and the other in
    one process; the one process's run with the ranks' gates computes
    what the ranks compute, up to rounding."""

    def __init__(self, torch, record=None, force=None):
        self.torch, self.record, self.force = torch, record, force

    def relu(self, x, *a, **kw):
        if x.dim() != 3:
            return self.F.relu(x, *a, **kw)
        if self.record is not None:
            self.record.append(x.detach().clone())
        if self.force is not None:
            return self.torch.where(next(self.forced), x,
                                    self.torch.zeros_like(x))
        return self.F.relu(x, *a, **kw)

    def __enter__(self):
        import types

        import torch.nn.functional as F

        from sgg_torch.models import backbone, relhead
        self.F, self.mods = F, (backbone, relhead)
        self.forced = iter(self.force or ())
        ns = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                      if not k.startswith("_")})
        ns.relu = self.relu
        for m in self.mods:
            m.F = ns
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.F = self.F
        return False


def _gates_over_ranks(torch, rec):
    """The ReLU inputs ``rec`` of every rank, assembled into the one
    process's shapes (host float32 arrays): the ranks' rows concatenated.
    A collective."""
    from sgg_torch import parallel
    return [parallel.gather_rows({"x": x.float().cpu().numpy()})["x"]
            for x in rec]


def _gate_flips(mesh, ref):
    """For each ReLU: its input's shape, the gates that differ between the
    ranks' inputs ``mesh`` and one process's ``ref``, the largest |input|
    at them in one process, and the largest difference of the inputs."""
    import numpy as np
    rows = []
    for a, b in zip(mesh, ref):
        b = b.float().cpu().numpy()
        d = (a > 0) != (b > 0)
        rows.append((list(a.shape), int(d.sum()),
                     float(np.abs(b[d]).max()) if d.any() else 0.0,
                     float(np.abs(a - b).max())))
    return rows


def _forced_ref(torch, mesh, run):
    """``run()`` (one process) with the ranks' ReLU gates."""
    masks = [torch.from_numpy(a > 0).to(device="cuda:0") for a in mesh]
    with _ReluGates(torch, force=masks):
        return run()


def sgdet_rank(torch, group):
    """14b on one rank: the SGDet step (``Trainer``, one step of 3 images
    a rank) and, on rank 0, the same step from the same state as one
    process of 6."""
    from sgg_torch import parallel
    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.trainer import Trainer

    splits = synthetic_splits(num_train=SGDET_TRAIN_BATCH, num_eval=4)
    cfg = _sgdet_config(compute_dtype="float32", device="cuda:0",
                        val_size=0, notest=True)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, splits, detector=sgdet_detector(
        torch, splits["train"].num_classes), group=group)
    build_s = time.perf_counter() - t0
    snap, before = _snapshot_all(trainer), _state(trainer)
    dets, rec = [], []
    _recording_detector(trainer, dets)
    with _ReluGates(torch, record=rec):
        dp = _dp_step(torch, trainer)
    out = {"losses": dp["losses"], "n": dp["n"], "routes": dp["routes"],
           "s": dp["s"], "build_s": build_s, "dets": list(dets),
           "differ_from_rank0": sum(
               not parallel.bits_equal_to_rank0(t, group)
               for t in dp["after"].values())}
    gates = _gates_over_ranks(torch, rec)
    if group.rank == 0:
        def ref_step():
            _restore_all(trainer, snap)
            trainer.group = None
            return _dp_step(torch, trainer)

        dets.clear()
        ref_rec = []
        with _ReluGates(torch, record=ref_rec):
            ref = ref_step()
        out["ref_dets"] = list(dets)
        forced = _forced_ref(torch, gates, ref_step)
        relation = lambda k: not (k.startswith("momentum/")  # noqa: E731
                                  or "num_batches" in k)
        out.update(ref_losses=ref["losses"], ref_s=ref["s"],
                   flips=_gate_flips(gates, ref_rec),
                   update_err=_update_err(before, dp["after"], ref["after"],
                                          relation),
                   forced_err=_update_err(before, dp["after"],
                                          forced["after"], relation),
                   momentum_err=_update_err(
                       before, dp["after"], forced["after"],
                       lambda k: k.startswith("momentum/")))
    del trainer
    torch.cuda.empty_cache()
    parallel.sync_processes("mesh_sgdet")
    return out


def mesh_rank(group):
    """14b on one rank of two sharing the card over gloo, f32 with TF32
    off."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"sgdet": sgdet_rank(torch, group)}


def _flips_text(r):
    """What ``_gate_flips`` found, for a phase 14 line."""
    flips = [f for f in r["flips"] if f[1]]
    return (f"ReLU gates that differ from one process "
            f"{sum(f[1] for f in flips)} in {len(r['flips'])} RoI-head and "
            f"IMP ReLUs (at each: its shape, the gates, the largest |input| "
            f"there in one process, the largest input difference "
            f"{json.dumps(flips)})")


def _check_flips(what, r):
    """Each gate that differs is a rounding flip: its input in one process
    is within the largest difference of its ReLU's inputs."""
    bad = [f for f in r["flips"] if f[1] and f[2] > f[3]]
    check(not bad, f"{what}: ReLU gates differ beyond rounding: {bad}")


def mesh_two_ranks(torch):
    """14b: two ranks sharing the card over gloo (spawned; a file store in
    a temporary directory) against one process."""
    import numpy as np

    from sgg_torch import parallel

    t0 = time.perf_counter()
    res = parallel.spawn(mesh_rank, 2, device="cuda:0", backend="gloo",
                         timeout_s=MESH_JOIN_S,
                         collective_timeout_s=MESH_JOIN_S)
    s0 = res[0]["sgdet"]
    errs = _loss_errs(s0["losses"], s0["ref_losses"])
    per = SGDET_TRAIN_BATCH // 2
    same_dets = all(
        np.array_equal(mine[k], whole[k][r * per:(r + 1) * per])
        for r, x in enumerate(res)
        for mine, whole in zip(x["sgdet"]["dets"], s0["ref_dets"])
        for k in ("boxes", "labels"))
    print(f"phase 14b sgdet step, 2 ranks x {per} images against 1 process "
          f"x {SGDET_TRAIN_BATCH} (VGG16 detector, f32, TF32 off, dropout "
          f"on, the sampler drawing): losses rel err {json.dumps(errs)} "
          f"(limit {MESH_LOSS_LIMIT}); the ranks' detections are the "
          f"process's rows bit for bit: {same_dets}; {_flips_text(s0)}; "
          f"the updated relation model's parameters and BatchNorm "
          f"statistics: the largest difference from one process over the "
          f"largest update {s0['update_err'][0]:.3g} (at "
          f"{s0['update_err'][1]}), from one process with the ranks' gates "
          f"{s0['forced_err'][0]:.3g} (at {s0['forced_err'][1]}; limit "
          f"{DP_UPDATE_LIMIT}), its momentum buffers' "
          f"{s0['momentum_err'][0]:.3g}; trainers built in "
          f"{json.dumps([round(r['sgdet']['build_s'], 1) for r in res])} s;"
          f" launches a rank {json.dumps([r['sgdet']['n'] for r in res])} "
          f"by route {json.dumps([r['sgdet']['routes'] for r in res])}; "
          f"step {json.dumps([round(r['sgdet']['s'] * 1e3, 1) for r in res])}"
          f" ms a rank (one-step epochs, host included), 1 process "
          f"{s0['ref_s'] * 1e3:.1f} ms", flush=True)
    check(res[0]["sgdet"]["losses"] == res[1]["sgdet"]["losses"],
          "sgdet: the ranks log different losses")
    check(all(r["sgdet"]["differ_from_rank0"] == 0 for r in res),
          "sgdet: the ranks' states differ after the step")
    check(all(e <= MESH_LOSS_LIMIT for e in errs.values()),
          f"sgdet: losses {s0['losses']} vs one process {s0['ref_losses']}")
    _check_flips("sgdet", s0)
    check(s0["forced_err"][0] <= DP_UPDATE_LIMIT,
          f"sgdet: update differs from one process with the ranks' gates: "
          f"{s0['forced_err']}")
    for rk, r in enumerate(res):
        want = {k: SGDET_ROUTES.get(k, {}) for k in r["sgdet"]["routes"]}
        check(r["sgdet"]["routes"] == want,
              f"sgdet rank {rk} launched by route {r['sgdet']['routes']}, "
              f"want {want}")
    paths = {"sgdet_2ranks": {k: sum(r["sgdet"]["n"][k] for r in res)
                              for k in res[0]["sgdet"]["n"]}}
    print(f"phase 14b two ranks in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


def phase_mesh(torch):
    """Phase 14: multi-process SGDet training."""
    t0 = time.perf_counter()
    paths = sgdet_one_rank(torch)
    paths.update(mesh_two_ranks(torch))
    print(f"phase 14 sgdet data parallel in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 15: the tools and examples (sgg_torch/tools, sgg_torch/examples)

TOOLS_DEADLINE_S = 480
TOOL_TIMEOUT_S = 240
TOOL_ITERS = "3"
# per tool, the stages that must launch each kernel (at least once a call)
TOOL_LAUNCHES = {
    "profile_step": {"trunk fwd": ("vgg_conv1",), "K1 nodes": ("roi_align",),
                     "K1 unions": ("roi_align",),
                     "full forward": ("roi_align", "vgg_conv1"),
                     "full train step": ("roi_align", "vgg_conv1")},
    "profile_trunk": {"baseline": ("vgg_conv1",),
                      "batch B=24": ("vgg_conv1",)},
    "profile_relhead": {"K1 nodes": ("roi_align",),
                        "K1 unions": ("roi_align",),
                        "K1 unions (dedup'd half)": ("roi_align",)},
    "profile_sgdet": {"trunk fwd": ("vgg_conv1",),
                      "detector full (trunk+RPN+NMS+head)":
                          ("roi_align", "vgg_conv1"),
                      "detector sans trunk (fmap given)": ("roi_align",),
                      "rel head (pair budget)": ("roi_align",),
                      "full retry eval step": ("roi_align", "vgg_conv1")},
    "profile_pretrain": {
        "trunk fwd": ("vgg_conv1",),
        "detector fwd (trunk+RPN+NMS+head)": ("roi_align", "vgg_conv1"),
        "fwd + bwd (grad)": ("roi_align", "vgg_conv1", "roi_align_bwd_fmap",
                             "roi_align_bwd_boxes", "vgg_conv1_bwd"),
        "FULL pretrain step": ("roi_align", "vgg_conv1",
                               "roi_align_bwd_fmap", "roi_align_bwd_boxes",
                               "vgg_conv1_bwd")},
    "profile_gan": {"phase F: SGG fwd+bwd+update": ("roi_align",
                                                    "vgg_conv1"),
                    "SGG fwd on fake fmap (per call)": ("roi_align",),
                    "FULL GAN F/G/D step": ("roi_align", "vgg_conv1",
                                            "roi_align_bwd_fmap")},
    "e2e_throughput": {"epoch 1": ("roi_align", "vgg_conv1")},
    "soak": {"fit": ("roi_align", "vgg_conv1")},
}
TOOL_ARGS = {"profile_step": ["--iters", TOOL_ITERS],
             "profile_trunk": ["--quick", "--iters", TOOL_ITERS],
             "profile_relhead": ["--iters", TOOL_ITERS],
             "profile_sgdet": ["--iters", TOOL_ITERS],
             "profile_pretrain": ["--iters", TOOL_ITERS],
             "profile_gan": ["--iters", TOOL_ITERS],
             "e2e_throughput": [],
             "soak": ["48", "1"]}


def run_processes(cmds, timeout: float):
    """Run ``cmds`` (name -> argv) at once from the checkout's root, each
    in its own session; returns name -> (exit code, output). Every process
    is killed if one overruns ``timeout`` or the phase ends early."""
    procs = {}
    t0 = time.monotonic()
    try:
        for name, cmd in cmds.items():
            procs[name] = subprocess.Popen(
                cmd, cwd=HERE, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        out = {}
        for name, proc in procs.items():
            left = max(timeout - (time.monotonic() - t0), 1)
            try:
                text, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"{name} passed its {timeout:.0f} s")
            out[name] = (proc.returncode, text)
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def _module(name: str):
    return [sys.executable, "-m", f"sgg_torch.tools.{name}"]


def _tool_line(name, rc, out):
    check(rc == 0, f"{name} exited {rc}:\n{out[-3000:]}")
    line = json.loads(out.strip().splitlines()[-1])
    for text in out.strip().splitlines()[:-1]:
        print(f"  {name}| {text}", flush=True)
    return line


def check_tool(name, line):
    """Every stage's times finite and positive, no MFU over 100%, and each
    kernel the stage goes through launched."""
    for stage, st in line["stages"].items():
        for key in ("card_ms", "wall_ms"):
            v = st[key]
            check(v is None or (math.isfinite(v) and v > 0),
                  f"{name} {stage}: {key} {v}")
        check(st["mfu"] is None or st["mfu"] <= 1.0,
              f"{name} {stage}: MFU {st['mfu']} over 100%")
        for k in TOOL_LAUNCHES.get(name, {}).get(stage, ()):
            check(st["launches"].get(k, 0) > 0,
                  f"{name} {stage}: {k} launched nothing "
                  f"({st['launches']})")
    for stage in TOOL_LAUNCHES.get(name, {}):
        check(stage in line["stages"], f"{name}: no stage {stage!r}")
    return {k: v["launches"] for k, v in line["launches"].items()}


def tools_profilers():
    """15a, b: the six profilers at full width, then the end-to-end
    throughput and the soak, each alone on the card."""
    paths = {}
    for name, args in TOOL_ARGS.items():
        t0 = time.perf_counter()
        (rc, out), = run_processes({name: _module(name) + args},
                                   TOOL_TIMEOUT_S).values()
        line = _tool_line(name, rc, out)
        paths[f"tool_{name}"] = check_tool(name, line)
        st = line["stages"]
        extra = {k: line[k] for k in ("shares", "phases_ms",
                                      "train_images_per_s", "results",
                                      "detections", "variant_rel_err")
                 if k in line}
        print(f"phase 15 {name} ({time.perf_counter() - t0:.1f} s): "
              f"{len(st)} stages, launches "
              f"{json.dumps(paths[f'tool_{name}'])}; {json.dumps(extra)}",
              flush=True)
        print(f"phase 15 {name} json {json.dumps(line)}", flush=True)
    return paths


def _fake_vg_tree(root):
    """The VG tree's files as placeholders: the preflight reaches the HDF5
    read, which needs h5py."""
    base = os.path.join(root, "VG", "stanford_filtered")
    os.makedirs(base)
    os.makedirs(os.path.join(root, "VG", "VG_100K"))
    for f, text in (("VG-SGG.h5", ""), ("VG-SGG-dicts.json", "{}"),
                    ("image_data.json", "[]")):
        with open(os.path.join(base, f), "w") as fh:
            fh.write(text)


def _results_finite(path):
    check(os.path.isfile(path), f"the dress rehearsal wrote no {path}")
    with open(path) as f:
        res = json.load(f)
    nums = [v for v in res.values() if isinstance(v, (int, float))]
    check(nums and all(math.isfinite(v) for v in nums),
          f"{path}: not finite numbers")
    return res


def tools_host_and_chain():
    """15c: at once, ``reprobe_gates`` (each stage its own process), the
    dress rehearsal's GQA chain on a fixture tree at 592 px, the preflight
    on a VG tree (no h5py here: a BLOCKER naming it), ``perturbations_demo``
    and ``gan_feature_quality``. The gates' times are then read beside the
    rehearsal's work on the card: the run checks that every gate finishes,
    and the gates' clean times come from ``reprobe_gates`` run alone."""
    import importlib.util
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="sgg_tools_")
    paths = {}
    try:
        vg = os.path.join(tmp, "vg")
        _fake_vg_tree(vg)
        data, runs = os.path.join(tmp, "data"), os.path.join(tmp, "runs")
        (rc, out), = run_processes({"fixture": _module(
            "make_fixture_dataset") + [data, "gqa", "0.25"]}, 120).values()
        check(rc == 0, f"make_fixture_dataset exit {rc}:\n{out[-2000:]}")
        t0 = time.perf_counter()
        res = run_processes({
            "reprobe_gates": _module("reprobe_gates"),
            "rehearsal": ["bash", os.path.join(
                HERE, "sgg_torch", "tools", "dress_rehearsal.sh"), data,
                runs, "gqa"],
            "preflight": _module("preflight_real_data") + ["-data", vg],
            "perturbations_demo": [sys.executable, "-m",
                                   "sgg_torch.examples.perturbations_demo"],
            "gan_feature_quality": [sys.executable, "-m",
                                    "sgg_torch.examples.gan_feature_quality"]},
            TOOL_TIMEOUT_S + 60)
        gates = _tool_line("reprobe_gates", *res["reprobe_gates"])
        print(f"phase 15 reprobe_gates, the dress rehearsal, the preflight "
              f"and two examples at once in {time.perf_counter() - t0:.1f} "
              f"s; the gates (beside the rehearsal's work): "
              f"{json.dumps(gates['gates'])}", flush=True)
        for gate, r in gates["gates"].items():
            if "n/a" in r:
                continue
            for k, v in r.items():
                if k.endswith("_ms"):
                    check(isinstance(v, float) and v > 0,
                          f"gate {gate} {k}: {v}")
        check(gates["launches"].get("roi_align", 0) > 0
              and gates["launches"].get("vgg_conv1", 0) > 0,
              f"reprobe_gates launched {gates['launches']}")
        paths["tool_reprobe_gates"] = gates["launches"]
        rc, out = res["preflight"]
        has_h5py = importlib.util.find_spec("h5py") is not None
        blockers = [ln for ln in out.splitlines() if "BLOCKER:" in ln]
        print(f"phase 15 preflight_real_data (h5py here: {has_h5py}): exit "
              f"{rc}; {blockers}; verdict "
              f"{out.strip().splitlines()[-len(blockers) - 1]}", flush=True)
        check(rc == 1 and blockers and "Traceback" not in out,
              f"preflight exit {rc}:\n{out[-2000:]}")
        check(has_h5py or "h5py" in blockers[0],
              f"the preflight's first BLOCKER names no h5py: {blockers}")
        rc, out = res["perturbations_demo"]
        check(rc == 0 and out.count("===") == 6 and "  ->  " in out,
              f"perturbations_demo exit {rc}:\n{out[-2000:]}")
        print(f"phase 15 perturbations_demo: {out.count('  ->  ')} "
              f"triplets perturbed", flush=True)
        rc, out = res["rehearsal"]
        check(rc == 0 and out.rstrip().endswith("ALL GREEN"),
              f"dress rehearsal exit {rc}:\n{out[-3000:]}")
        got = _results_finite(os.path.join(runs, "gqa", "test_results.json"))
        print(f"phase 15 dress rehearsal (gqa: pretrain_detector gqa -> "
              f"-m sgcls -split gqa -backbone resnet50 -exclude_left_right "
              f"-> -m sgdet -split gqa): "
              f"{len(got)} results, avg/test_alls_R "
              f"{got.get('avg/test_alls_R')}", flush=True)
        rc, out = res["gan_feature_quality"]
        fid = [ln for ln in out.splitlines() if ln.startswith("FID")]
        check(rc == 0 and fid and math.isfinite(float(fid[0].split()[-1])),
              f"gan_feature_quality exit {rc}:\n{out[-2000:]}")
        print(f"phase 15 gan_feature_quality: {' '.join(out.split())}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


def phase_tools(torch):
    """Phase 15: the port's tools and examples, each a process of its own
    (``python -m sgg_torch.tools.<name>``)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    paths = tools_profilers()
    paths.update(tools_host_and_chain())
    print(f"phase 15 tools and examples in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 16: the native host library (``sgg_torch.native``) and the sgcls
# main path from JPEGs through it

NATIVE_DEADLINE_S = 240
NATIVE_IMAGES = 64  # 16a: seeded uint8 images, 300-1024 px a side
NATIVE_SHARE = 1e-4  # the plain prep: off by 1 on at most this share
LOADER_THREADS = 4  # phase 5's num_workers
# 16d: GQA JPEGs larger than the canvas; 4 of the train scene graphs go to
# val (-val_size), 96 train images make 4 steps an epoch at batch 24
GQA_TRAIN, GQA_VAL, GQA_VAL_SIZE, GQA_SIDES = 100, 16, 4, (640, 1024)


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _pil_canvas(img, ch, cw, flip):
    """The uint8 canvas by PIL's resize: the route the port took before
    its native prep, and the JAX package's fall-back."""
    import numpy as np

    from sgg_torch.data.pipeline import IMAGENET_MEAN, _resized
    out = _resized(img, ch, cw)
    if flip:
        out = out[:, ::-1]
    canvas = np.empty((CANVAS, CANVAS, 3), np.uint8)
    canvas[:] = (IMAGENET_MEAN * 255).astype(np.uint8)
    canvas[:ch, :cw] = np.round(out * 255).astype(np.uint8)
    return canvas


def _ms_per_item(fn, items, threads):
    """Wall ms an item of ``fn`` over ``items``, inline or on
    ``threads`` threads (the loader's pool)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    if threads == 1:
        for it in items:
            fn(it)
    else:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(fn, items))
    return (time.perf_counter() - t0) * 1e3 / len(items)


def native_prep():
    """16a: a fresh build of the library, timed; 64 seeded uint8 images
    through ``prepare_image_u8`` and its plain version (within 1 per byte
    on at most ``NATIVE_SHARE`` of the bytes); ms an image inline and on
    the loader's threads beside PIL's route for the same images."""
    import shutil
    import tempfile

    import numpy as np

    from sgg_torch import native
    from sgg_torch.data.pipeline import IMAGENET_MEAN, content_size
    tmp = tempfile.mkdtemp(prefix="sgg_native_")
    try:
        t0 = time.perf_counter()
        native.Library(native.build(tmp))
        build_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    lib = native.load()
    print(f"phase 16 host CPU {native.host_cpu()!r}; card {smi_line()}",
          flush=True)
    print(f"phase 16 native library built with {native.CXX} "
          f"{' '.join(native.CXX_FLAGS)} in {build_s:.2f} s (a fresh "
          f"build); the package's {lib.path.name} loaded", flush=True)
    rng = np.random.RandomState(16)
    mean_u8 = (IMAGENET_MEAN * 255).astype(np.uint8)
    items = []
    for i in range(NATIVE_IMAGES):
        h, w = (int(v) for v in rng.randint(300, 1025, 2))
        ch, cw, _ = content_size(h, w, CANVAS)
        items.append((rng.randint(0, 256, (h, w, 3), np.uint8), ch, cw,
                      bool(i % 2)))
    worst, off, n_bytes = 0, 0, 0
    for img, ch, cw, flip in items:
        got = native.prepare_image_u8(img, CANVAS, ch, cw, flip, mean_u8)
        want = native.prepare_image_u8_plain(img, CANVAS, ch, cw, flip,
                                             mean_u8)
        check((got[ch:] == mean_u8).all() and (got[:, cw:] == mean_u8).all(),
              f"{img.shape} -> {ch}x{cw}: padding is not the mean")
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        worst = max(worst, int(diff.max()))
        off += int((diff > 0).sum())
        n_bytes += ch * cw * 3
    share = off / n_bytes
    print(f"phase 16a prepare_image_u8 against its plain version on "
          f"{NATIVE_IMAGES} seeded uint8 images (300-1024 px a side, half "
          f"flipped, {CANVAS} px canvas): max|diff| {worst}, {off} of "
          f"{n_bytes} content bytes off ({share:.3g})", flush=True)
    check(worst <= 1 and share <= NATIVE_SHARE,
          f"native prep vs plain: max {worst}, share {share}")

    def nat(it):
        return native.prepare_image_u8(it[0], CANVAS, it[1], it[2], it[3],
                                       mean_u8)

    def pil(it):
        return _pil_canvas(*it)

    nat(items[0]), pil(items[0])  # warm
    ms = {"native_1_thread": _ms_per_item(nat, items, 1),
          f"native_{LOADER_THREADS}_threads": _ms_per_item(
              nat, items, LOADER_THREADS),
          "pil_1_thread": _ms_per_item(pil, items, 1),
          f"pil_{LOADER_THREADS}_threads": _ms_per_item(
              pil, items, LOADER_THREADS)}
    print(f"phase 16a host ms an image ({CANVAS} px canvas, the same "
          f"{NATIVE_IMAGES} images; CPU {native.host_cpu()!r}, "
          f"{os.cpu_count()} cores): {json.dumps(ms)}", flush=True)
    return ms


def _ragged_batch(rng, B, max_nodes, max_edges):
    """Concatenated graphs of ``B`` images, each over both caps, with
    relation ends that point past the cut or below 0."""
    import numpy as np
    counts = rng.randint(max_nodes // 2, 2 * max_nodes, B)
    rel_counts = rng.randint(max_edges // 2, 4 * max_edges, B)
    boxes = (rng.rand(counts.sum(), 4) * CANVAS).astype(np.float32)
    classes = rng.randint(1, 151, counts.sum()).astype(np.int32)
    rels = np.concatenate([
        np.stack([rng.randint(-2, n + 2, r), rng.randint(-2, n + 2, r),
                  rng.randint(1, 51, r)], 1)
        for n, r in zip(counts, rel_counts)]).astype(np.int32)
    offsets = [np.concatenate([[0], np.cumsum(c)]).astype(np.int64)
               for c in (counts, rel_counts)]
    return boxes, classes, offsets[0], rels, offsets[1]


def native_pack():
    """16b: phase 5's train shape (24 images, 40 nodes, 256 edges) packed
    from ragged graphs that overflow both caps, native against plain:
    equal buffers and dropped counts; ms a batch of each."""
    import numpy as np

    from sgg_torch import native
    rng = np.random.RandomState(160)
    batches = [_ragged_batch(rng, TRAIN_BATCH, TRAIN_NODES, TRAIN_EDGES)
               for _ in range(8)]
    dropped = []
    for args in batches:
        got = native.pack_graph_batch(*args, TRAIN_NODES, TRAIN_EDGES)
        want = native.pack_graph_batch_plain(*args, TRAIN_NODES, TRAIN_EDGES)
        check(all(g.dtype == w.dtype and np.array_equal(g, w)
                  for g, w in zip(got[:5], want[:5])) and got[5] == want[5],
              "pack_graph_batch differs from its plain version")
        check(got[2].all(1).any() and got[4].all(1).any() and got[5] > 0,
              "the ragged batch did not overflow both caps")
        dropped.append(got[5])

    def run(fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            for args in batches:
                fn(*args, TRAIN_NODES, TRAIN_EDGES)
        return (time.perf_counter() - t0) * 1e3 / (reps * len(batches))

    ms = {"native": run(native.pack_graph_batch, 20),
          "plain": run(native.pack_graph_batch_plain, 1)}
    print(f"phase 16b pack_graph_batch at {TRAIN_BATCH} images x "
          f"{TRAIN_NODES} nodes x {TRAIN_EDGES} edges, {len(batches)} "
          f"ragged batches over both caps (dropped {dropped}): equal to "
          f"its plain version; host ms a batch {json.dumps(ms)}",
          flush=True)
    return ms


def native_rects(torch):
    """16c: the card's rasterizer (``ops/rects.py``) on phase 5's 6,144
    pairs within 1e-4 of ``draw_union_rects_native``."""
    import numpy as np

    from sgg_torch import native
    from sgg_torch.constants import RECT_SIZE
    from sgg_torch.ops.rects import draw_union_rects
    g = torch.Generator().manual_seed(161)
    boxes = eval_boxes(g, TRAIN_BATCH, TRAIN_NODES, CANVAS)
    # well-formed boxes: the oracle divides by the union's extent
    xy = boxes[..., :2].clamp(0, CANVAS - 9)
    boxes = torch.cat([xy, torch.maximum(boxes[..., 2:], xy + 8)], -1)
    pairs = torch.randint(0, TRAIN_NODES, (TRAIN_BATCH, TRAIN_EDGES, 2),
                          generator=g)
    b = torch.arange(TRAIN_BATCH)[:, None]
    pb = torch.cat([boxes[b, pairs[..., 0]], boxes[b, pairs[..., 1]]], -1)
    pb = pb.reshape(-1, 8).contiguous()
    want = native.draw_union_rects_native(pb.numpy(), RECT_SIZE)
    got = draw_union_rects(pb.cuda(), RECT_SIZE).cpu().numpy()
    err = float(np.abs(got - want).max())
    print(f"phase 16c the card's rasterizer on {pb.shape[0]} pairs "
          f"({TRAIN_BATCH} x {TRAIN_EDGES}) against the native oracle: "
          f"max|err| {err:.3g}", flush=True)
    check(np.isfinite(want).all() and err <= 1e-4,
          f"rasterizer vs native oracle: {err}")


def native_gqa(torch, train_rate):
    """16d: ``main -m sgcls -loss dnorm -b 24`` (VGG16, 592 px,
    ``-image_format uint8``) on the GQA splits of a fixture tree of JPEGs
    larger than the canvas, 2 epochs of 4 steps and the evals, counted:
    every uint8 image (the training's) through the native prep and PIL
    only for the evals' float32 canvases, every batch through the native
    packer, K2 and K1 launched. Then the host's ms to
    assemble a train batch of 24 on the uint8 (native) and float32 (PIL)
    routes. The CLI refuses ``-split gqa`` with VGG16 (the reference's rule
    against a VG-pretrained detector on GQA, whose test images VG's train
    split may hold; the weights here are seeded), so the run passes
    ``-split synthetic`` and its ``load_splits`` answers with the CLI's
    own GQA branch on the tree."""
    import shutil
    import tempfile
    import types

    from sgg_torch import constants, native
    from sgg_torch import main as cli
    from sgg_torch.data import fixtures
    from sgg_torch.data import pipeline
    from sgg_torch.train import trainer as trainer_mod

    tree = tempfile.mkdtemp(prefix="sgg_gqa_")
    seen = {"uint8_images": 0, "other_images": 0, "pil_resizes": 0,
            "batches": 0}
    epochs, splits = [], {}
    saved = (pipeline.prepare_example, pipeline._resized,
             pipeline.pack_ragged, trainer_mod.Trainer.train_epoch,
             cli.load_splits)

    def prepare_example(image, *a, uint8=False, **k):
        key = ("uint8_images" if uint8 and image.dtype.name == "uint8"
               else "other_images")
        seen[key] += 1
        return saved[0](image, *a, uint8=uint8, **k)

    def resized(*a, **k):
        seen["pil_resizes"] += 1
        return saved[1](*a, **k)

    def pack_ragged(*a, **k):
        seen["batches"] += 1
        return saved[2](*a, **k)

    def train_epoch(self, epoch):
        t0 = time.perf_counter()
        out = saved[3](self, epoch)
        epochs.append((time.perf_counter() - t0, self.steps_per_epoch))
        return out

    def load_splits(config):
        gqa = types.SimpleNamespace(**{**vars(config), "split": "gqa",
                                       "data": tree})
        splits.update(saved[4](gqa))
        return splits

    try:
        t0 = time.perf_counter()
        fixtures.write_gqa_fixture(tree, n_train=GQA_TRAIN, n_val=GQA_VAL,
                                   image_sizes=GQA_SIDES)
        print(f"phase 16d GQA fixture: {GQA_TRAIN + GQA_VAL} JPEGs of "
              f"{GQA_SIDES[0]}-{GQA_SIDES[1] - 1} px a side in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        argv = ["-m", "sgcls", "-loss", "dnorm", "-b", str(TRAIN_BATCH),
                "-split", "synthetic", "-nepoch", "2", "-val_size",
                str(GQA_VAL_SIZE), "-p", "2", "-nwork", str(LOADER_THREADS)]
        (pipeline.prepare_example, pipeline._resized, pipeline.pack_ragged,
         trainer_mod.Trainer.train_epoch, cli.load_splits) = (
            prepare_example, resized, pack_ragged, train_epoch, load_splits)
        lib = native.load()
        lib.reset_counts()
        t0 = time.perf_counter()
        try:
            res, n, routes = _counted(torch, lambda: cli.main(argv))
        finally:
            (pipeline.prepare_example, pipeline._resized,
             pipeline.pack_ragged, trainer_mod.Trainer.train_epoch,
             cli.load_splits) = saved
        wall = time.perf_counter() - t0
        calls = dict(lib.calls)
        steps = sum(s for _, s in epochs)
        rates = [s * TRAIN_BATCH / t for t, s in epochs]
        recalls = {k: v for k, v in res.items()
                   if k.startswith("sgcls/test_alls_R@")}
        print(f"phase 16d main {' '.join(argv)} on the GQA tree (VGG16, "
              f"{constants.IM_SCALE} px, uint8 canvases) in {wall:.1f} s: "
              f"{len(splits['train'])} train images, {steps} steps over "
              f"{len(epochs)} epochs, train images/s (host included) by "
              f"epoch {json.dumps(rates)} (phase 5's, synthetic canvases: "
              f"{train_rate:.2f}); recalls {json.dumps(recalls)}; images "
              f"and batches {json.dumps(seen)}; native calls "
              f"{json.dumps(calls)}; launches {json.dumps(n)} by route "
              f"{json.dumps(routes)}", flush=True)
        check(len(epochs) == 2 and all(s >= 4 for _, s in epochs),
              f"epochs {epochs}: want 2 of at least 4 steps")
        check(recalls and all(math.isfinite(v) for v in recalls.values()),
              f"recalls missing or not finite: {recalls}")
        # training decodes uint8 and takes the native prep; the evals
        # load float32 canvases, resized by PIL (``val_epoch``'s loader,
        # as the JAX package's)
        check(seen["uint8_images"] >= steps * TRAIN_BATCH
              and calls.get("prepare_image_u8") == seen["uint8_images"]
              and seen["pil_resizes"] == seen["other_images"],
              f"images {seen}, native calls {calls}: want every uint8 "
              f"image through the native prep and PIL only for the rest")
        check(seen["batches"] >= steps
              and calls.get("pack_graph_batch") == seen["batches"],
              f"batches {seen['batches']}, native calls {calls}: want "
              f"every batch through the native packer")
        check(n["vgg_conv1"] >= steps and n["roi_align"] >= 2 * steps
              and NO_BACKWARD.items() <= n.items(),
              f"{steps} steps and the evals launched {n}")

        host_ms, host_mb = {}, {}
        for fmt in ("uint8", "float32"):
            loader = pipeline.BatchLoader(
                splits["train"], batch_size=TRAIN_BATCH,
                max_nodes=TRAIN_NODES, max_edges=TRAIN_EDGES, seed=0,
                num_workers=LOADER_THREADS, im_scale=constants.IM_SCALE,
                image_format=fmt)
            t0 = time.perf_counter()
            batches = list(loader)
            host_ms[fmt] = (time.perf_counter() - t0) * 1e3 / len(batches)
            host_mb[fmt] = batches[0].images.nbytes / 1e6
        print(f"phase 16d host batch of {TRAIN_BATCH} GQA JPEGs (decode "
              f"included, {LOADER_THREADS} threads): assembly ms "
              f"{json.dumps(host_ms)} (uint8: the native prep; float32: "
              f"PIL), images MB {json.dumps(host_mb)}", flush=True)
        return n
    finally:
        shutil.rmtree(tree, ignore_errors=True)


def phase_native(torch, train_rate):
    """Phase 16: the native host library, then the sgcls main path from
    JPEGs through it. Returns the launches of path ``native_gqa``."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    native_prep()
    native_pack()
    native_rects(torch)
    n = native_gqa(torch, train_rate)
    print(f"phase 16 native host library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"native_gqa": n}


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "sgg_torch")):
        fail("sgg_torch/ not found beside chip_smoke.py; run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card visible to torch")
    sys.path.insert(0, HERE)
    with Deadline(TOTAL_DEADLINE_S, "chip_smoke"):
        t_all = time.perf_counter()
        phase_card(torch)
        phase_build()
        from sgg_torch.utils.profiling import card_peaks
        peaks_name, peaks = card_peaks(torch.cuda.get_device_name(0))
        print(f"peaks assumed ({peaks_name}): {peaks[0] / 1e12:.2f} TB/s, "
              f"{peaks[1] / 1e12:.0f} TFLOP/s bf16, {peaks[2] / 1e12:.0f} "
              f"TFLOP/s f32", flush=True)
        rows = phase_kernels(torch, peaks)
        from sgg_torch.data.synthetic import synthetic_splits
        splits = synthetic_splits(num_train=4 * TRAIN_BATCH, num_eval=64)
        paths = {}
        paths["eval"], eval_batch = phase_slice(torch, splits)
        train_paths, train_rate = phase_train(torch, splits)
        paths.update(train_paths)
        with Deadline(PARITY_DEADLINE_S, "phase 6"):
            phase_parity(torch, splits)
        with Deadline(SGDET_DEADLINE_S, "phase 7"):
            paths.update(phase_sgdet(torch, peaks, rows))
        with Deadline(PRETRAIN_DEADLINE_S, "phase 8"):
            paths.update(phase_pretrain(torch, peaks, rows))
        with Deadline(FPN_DEADLINE_S, "phase 9"):
            paths.update(phase_resnet(torch, peaks, rows, splits))
        with Deadline(REAL_DEADLINE_S, "phase 10"):
            paths.update(phase_real_inputs(torch))
        with Deadline(GAN_DEADLINE_S, "phase 11"):
            gan_paths, gan_rate = phase_gan(torch, peaks, rows, splits)
            paths.update(gan_paths)
        with Deadline(VIS_DEADLINE_S, "phase 12"):
            paths.update(phase_vis_cond(torch, splits, gan_rate,
                                        eval_batch))
        with Deadline(DP_DEADLINE_S, "phase 13"):
            paths.update(phase_data_parallel(torch, splits, train_rate))
        with Deadline(MESH_DEADLINE_S, "phase 14"):
            paths.update(phase_mesh(torch))
        with Deadline(TOOLS_DEADLINE_S, "phase 15"):
            paths.update(phase_tools(torch))
        with Deadline(NATIVE_DEADLINE_S, "phase 16"):
            paths.update(phase_native(torch, train_rate))
        print(f"all phases in {time.perf_counter() - t_all:.1f} s",
              flush=True)
    print("launches by path " + json.dumps(paths), flush=True)
    kernels = []
    for name, row in rows.items():
        row["launches_by_path"] = {p: n.get(name, 0)
                                   for p, n in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
