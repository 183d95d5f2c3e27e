#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sgg_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, no network and no
JAX. Phases, one or more lines each; any failure ends the run with a
non-zero exit and without the result line:

1. card facts: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build both CUDA kernels from ``sgg_torch/csrc`` (one ``nvcc`` each, in
   parallel);
3. each kernel against its plain PyTorch version at the main path's shapes,
   in f32 (TF32 off, tolerance 1e-5 abs) and in bf16 (within 2e-2 of the
   f32 plain result, relative to its largest magnitude), with timings
   (CUDA events, mean over 20 launches after warm-up) and the card's bound;
   then every other route of the kernels at small shapes, same tolerances
   (K1 at channel counts and alignments that take its narrower vector
   widths and with a whole-map ROI; K2 in both types at a ragged size),
   and K1's plain version on the card against the same call on the CPU
   (f32, 1e-6 abs);
4. the slice at full width: ``val_epoch`` in mode sgcls (predcls + sgcls
   regimes) over a 64-image synthetic split with the VG-Stanford
   vocabulary, VGG16 on 592x592 canvases in bf16, seeded random weights;
   the kernels' launch counters are zeroed just before and read just
   after, and must match the batches run;
5. one full-width eval step of 2 images in f32, card (kernels) against CPU
   (plain versions) with the same weights, under its own deadline.

Then a JSON line ``{"kernels": [...]}`` and, last, the result line
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


# Published peaks (NVIDIA data sheets, dense): HBM bytes/s, bf16 tensor
# FLOP/s, f32 FLOP/s outside the tensor cores.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12),
         "H200": (4.8e12, 989e12, 67e12),
         "H100": (3.35e12, 989e12, 67e12)}


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if all(part in name for part in key.split()):
            return key, peaks
    return "H100", PEAKS["H100"]


def bound_ms(n_bytes: float, flops: float, peaks, bf16: bool):
    bw, bf16_rate, f32_rate = peaks
    t_bytes = n_bytes / bw * 1e3
    t_ops = flops / (bf16_rate if bf16 else f32_rate) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(torch, got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max())


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


def phase_build():
    from sgg_torch.ops import _cuda, roi_align, vgg_stem
    t0 = time.perf_counter()
    _cuda.build_all([roi_align.KERNEL, vgg_stem.KERNEL])
    print(f"phase 2 build: both kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for k in (roi_align.KERNEL, vgg_stem.KERNEL):
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


def phase_kernels(torch, peaks):
    """Each kernel against its plain version on the main path's shapes."""
    from sgg_torch.ops import roi_align as K1
    from sgg_torch.ops import vgg_stem as K2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows = {}

    # K1: fmap (16, 37, 37, 512); nodes R=64, unions R=256 (the 512 rung)
    B, H, C, canvas = 16, 37, 512, 592
    fmap = torch.rand(B, H, H, C, generator=g).to(dev)
    nodes = eval_boxes(g, B, 64, canvas).to(dev)
    unions = eval_boxes(g, B, 256, canvas).to(dev)
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

    n_out = B * (64 + 256) * 49 * C
    n_bytes = 2 * fmap.numel() * 2 + (nodes.numel() + unions.numel()) * 4 \
        + n_out * 2
    bms, bby = bound_ms(n_bytes, n_out * 32, peaks, bf16=True)
    rows["roi_align"] = dict(
        name="roi_align", route="cuda", source="sgg_torch/csrc/roi_align.cu",
        replaces="sgg_tpu/ops/roi_align_pallas.py:169", max_abs_err=err,
        bf16_rel_err=rel, ms=time_ms(k1), plain_ms=time_ms(p1),
        bound_ms=bms, bound_by=bby, library_ms=None,
        shape="bf16 fmap 16x37x37x512; nodes R=64 + unions R=256 "
              "(one forward's two launches)",
        bytes=n_bytes, flops=n_out * 32)

    # K2: (16, 592, 592, 3) -> (16, 592, 592, 64)
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
        name="vgg_conv1", route="cuda", source="sgg_torch/csrc/vgg_stem.cu",
        replaces="sgg_tpu/ops/vgg_stem_pallas.py:68", max_abs_err=err2,
        bf16_rel_err=rel2,
        ms=time_ms(lambda: K2.vgg_conv1(x16, w16, b16)),
        plain_ms=time_ms(lambda: K2.vgg_conv1_reference(x16, w16, b16)),
        bound_ms=bms2, bound_by=bby2,
        library_ms=time_ms(lambda: torch.relu(
            torch.nn.functional.conv2d(xc, wc, b16, padding=1))),
        shape="bf16 16x592x592x3 -> 16x592x592x64", bytes=n_bytes2,
        flops=flops2)
    del x, x16, xc
    phase_routes(torch, K1, K2, g, dev)
    for r in rows.values():
        print(f"phase 3 {r['name']}: max|err| f32 {r['max_abs_err']:.3g}, "
              f"bf16 rel {r['bf16_rel_err']:.3g}; {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms "
              f"[{r['shape']}]", flush=True)
    torch.cuda.empty_cache()
    return rows


def phase_slice(torch, splits):
    """val_epoch (sgcls: predcls + sgcls regimes) at full width on the card."""
    from sgg_torch.config import Config
    from sgg_torch.eval.driver import val_epoch
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
    K1.KERNEL.launches = 0
    K2.KERNEL.launches = 0
    res = val_epoch(model, test, config, "test_alls", verbose=False,
                    device="cuda")
    torch.cuda.synchronize()
    launches = {"roi_align": K1.KERNEL.launches,
                "vgg_conv1": K2.KERNEL.launches}
    counters = res.get("_counters", {})
    n_batches = counters.get("eval_ladder_batches", 0)
    forwards = n_batches + counters.get("eval_dedup_fallback", 0)
    expect_batches = 2 * math.ceil(len(test) / 16)
    print(f"phase 4 counters {json.dumps(counters)}; launches "
          f"{json.dumps(launches)}; forwards {forwards}", flush=True)
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
    loop_s = sum(thr[m]["seconds"] for m in thr)
    print(f"phase 4 one eval forward (16 images, rung 512, dedup, bf16): "
          f"{fwd:.3f} ms; {forwards} forwards = "
          f"{100 * forwards * fwd / 1e3 / loop_s:.1f}% of the "
          f"{loop_s:.3f} s loop", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def phase_parity(torch, splits):
    """One full-width eval step in f32: card (kernels) against CPU."""
    from sgg_torch import constants
    from sgg_torch.data.pipeline import BatchLoader
    from sgg_torch.models.relhead import RelModelIMP, init_weights
    from sgg_torch.train.step import make_eval_step

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
    print(f"phase 5 parity card vs CPU (f32, 2 images, full width): max|err| "
          f"{json.dumps(errs)}, obj_preds equal {same}; card {t_card:.2f} s, "
          f"CPU {t_cpu:.2f} s", flush=True)
    check(all(math.isfinite(v) and v <= 1e-3 for v in errs.values()),
          f"card vs CPU outputs differ: {errs}")
    check(same, "card vs CPU obj_preds differ")


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
        peaks_name, peaks = card_peaks(torch.cuda.get_device_name(0))
        print(f"peaks assumed ({peaks_name}): {peaks[0] / 1e12:.2f} TB/s, "
              f"{peaks[1] / 1e12:.0f} TFLOP/s bf16, {peaks[2] / 1e12:.0f} "
              f"TFLOP/s f32", flush=True)
        rows = phase_kernels(torch, peaks)
        from sgg_torch.data.synthetic import synthetic_splits
        splits = synthetic_splits(num_eval=64)
        launches = phase_slice(torch, splits)
        with Deadline(PARITY_DEADLINE_S, "phase 5"):
            phase_parity(torch, splits)
        print(f"all phases in {time.perf_counter() - t_all:.1f} s",
              flush=True)
    kernels = []
    for name, row in rows.items():
        row["launches"] = launches[name]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
