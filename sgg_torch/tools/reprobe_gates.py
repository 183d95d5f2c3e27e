"""Re-probe the gated alternatives of the port on the current card.

    python -m sgg_torch.tools.reprobe_gates [-device cpu --tiny]
    python -m sgg_torch.tools.reprobe_gates <gate> <stage> [...]

Counterpart of ``tools/reprobe_gates.py``: every stage (one timed
variant of one gate) runs in its own subprocess under a hard
``PER_STAGE_TIMEOUT`` (seconds, ``SGG_GATE_TIMEOUT``, default 120, build
and warm-up included); a stage that overruns records ``timeout@<N>s`` and
the other stages' numbers still land; each stage's process reports its
kernels' launches, which the JSON line sums. The first stage of a gate is what
the port ships; the winner is the fastest stage that finished, and a gate
whose other stages fail hard (not by timeout) still has one. The port's
gates:

- ``nms``: the detector's NMS method (``FasterRCNNVGG``'s default,
  ``rounds``) against the other methods of ``ops/nms.py`` ``METHODS``,
  each composed into the whole detector forward (bf16, batch 8, 592 px);
  before timing, each method's kept indices on a seeded input must equal
  ``sequential``'s;
- ``k1``: RoIAlign's kernel K1 against its plain version (on the same
  card tensors) at the sgcls union load (24 x 37 x 37 x 512 bf16, 256
  boxes an image);
- ``k2``: the VGG stem's kernel K2 against cuDNN's ``conv2d`` + ReLU (bf16
  24 x 592 x 592 x 3 -> 64).

The JAX tool's ``outer_roi`` (an XLA formulation of RoIAlign as one
matmul) and ``s2d_stem`` (``sgg_tpu/ops/stem_conv.py``, not a module of
the port) have no counterpart: they print as ``n/a`` with that reason.
``--tiny`` runs each stage at a size the CPU tests afford. The last line
is one JSON object: per gate each stage's ms (or its error) and the
winner; the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

STAGES = {"nms": ("rounds", "sequential", "chunked", "fixpoint"),
          "k1": ("kernel", "plain"),
          "k2": ("kernel", "cudnn")}
NOT_PORTED = {
    "outer_roi": "an XLA formulation of RoIAlign (one matmul of the outer "
                 "product of the axis weights); K1 serves RoIAlign on the "
                 "card",
    "s2d_stem": "sgg_tpu/ops/stem_conv.py (space-to-depth conv1_1) is not "
                "a module of the port; K2 serves conv1_1 on the card"}
PER_STAGE_TIMEOUT = int(os.environ.get("SGG_GATE_TIMEOUT", "120"))


def _time(fn, device, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms of ``fn``: CUDA events on the card, the host clock on the
    CPU."""
    from sgg_torch.utils.profiling import stage_ms
    t = stage_ms(fn, device, iters, warmup)
    return t["card_ms"] if t["card_ms"] is not None else t["wall_ms"]


def nms_indices(device, n_boxes: int = 300) -> Dict[str, list]:
    """Each NMS method's kept indices on seeded overlapping boxes (2
    images), by method."""
    import torch

    from sgg_torch.ops.nms import METHODS, nms
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(2, n_boxes, 2, generator=g) * 400
    wh = torch.rand(2, n_boxes, 2, generator=g) * 120 + 8
    boxes = torch.cat([xy, xy + wh], -1).to(device)
    scores = torch.rand(2, n_boxes, generator=g).to(device)
    valid = (torch.rand(2, n_boxes, generator=g) < 0.9).to(device)
    out = {}
    for method in METHODS:
        idx, keep = nms(boxes, scores, valid, 0.5, 100, method=method)
        out[method] = torch.where(keep, idx, -1).tolist()
    return out


def stage_nms(stage: str, device, tiny: bool) -> float:
    from sgg_torch.tools import _common
    from sgg_torch.tools.profile_sgdet import detector
    got = nms_indices(device)
    bad = [m for m, v in got.items() if v != got["sequential"]]
    if bad:
        raise RuntimeError(f"NMS methods {bad} keep other boxes than "
                           f"sequential")
    args = _common.parser(__doc__, 2 if tiny else 8, 40, 256,
                          64 if tiny else 592).parse_args(
        ["--tiny"] if tiny else [])
    batch = _common.synthetic_batch(args, device)
    det = detector(args, device)
    import torch
    with torch.inference_mode():
        return _time(lambda: det(batch.images, batch.im_hw,
                                 nms_method=stage)["scores"], device)


def stage_k1(stage: str, device, tiny: bool) -> float:
    import torch

    from sgg_torch.ops import roi_align as K1
    B, H, C, R = (2, 5, 16, 8) if tiny else (24, 37, 512, 256)
    g = torch.Generator().manual_seed(0)
    fmap = torch.randn(B, H, H, C, generator=g).to(device, torch.bfloat16)
    rois = torch.rand(B, R, 4, generator=g) * (H * 16 - 90)
    rois[..., 2:] = rois[..., :2] + 90
    rois = rois.to(device)
    fn = K1.roi_align if stage == "kernel" else K1.roi_align_reference
    return _time(lambda: fn(fmap, rois, spatial_scale=1 / 16), device)


def stage_k2(stage: str, device, tiny: bool) -> float:
    import torch
    import torch.nn.functional as F

    from sgg_torch.ops.vgg_stem import vgg_conv1
    B, S = (2, 32) if tiny else (24, 592)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, S, 3, generator=g).to(device, torch.bfloat16)
    w = (torch.randn(3, 3, 3, 64, generator=g) * 0.1).to(device)
    b = torch.zeros(64, device=device)
    if stage == "kernel":
        return _time(lambda: vgg_conv1(x, w, b), device)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
    wc = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous()
    bc = b.to(torch.bfloat16)
    return _time(lambda: F.relu(F.conv2d(xc, wc, bc, padding=1)), device)


def run_stage(gate: str, stage: str, device: str, tiny: bool,
              timeout: Optional[float] = None,
              launches: Optional[Dict[str, int]] = None):
    """One stage in a bounded subprocess -> ms, or {"error": ...}; the
    stage's kernel launches are added to ``launches``."""
    timeout = PER_STAGE_TIMEOUT if timeout is None else timeout
    t0 = time.time()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "sgg_torch.tools.reprobe_gates", gate,
           stage, "-device", device] + (["--tiny"] if tiny else [])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=ROOT, env=env)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout@{timeout:g}s",
                "elapsed_s": round(time.time() - t0, 1)}
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("STAGE_RESULT ")]
    if proc.returncode == 0 and line:
        res = json.loads(line[0][len("STAGE_RESULT "):])
        for k, n in res["launches"].items():
            if launches is not None:
                launches[k] = launches.get(k, 0) + n
        return res["ms"]
    return {"error": f"rc={proc.returncode}",
            "tail": (proc.stdout + proc.stderr)[-400:],
            "elapsed_s": round(time.time() - t0, 1)}


def verdict(stages: Sequence[str], r: Dict) -> str:
    """The JAX tool's rule: the fastest finisher when all finish, or when
    every other stage failed hard; else no determination."""
    ok = {st: r[f"{st}_ms"] for st in stages
          if isinstance(r[f"{st}_ms"], float)}
    if len(ok) == len(stages):
        return min(ok, key=ok.get)
    if ok and all(not r[f"{st}_ms"]["error"].startswith("timeout")
                  for st in stages if st not in ok):
        return f"{min(ok, key=ok.get)} (others fail on this card)"
    bad = [st for st in stages if st not in ok]
    return (f"no_determination ({','.join(bad)} did not finish; default "
            f"{stages[0]} stays)")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gate", nargs="?", choices=tuple(STAGES))
    ap.add_argument("stage", nargs="?")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("-device", "--device", default="cuda")
    args = ap.parse_args(argv)
    from sgg_torch.device import resolve_device
    dev = resolve_device(args.device)
    if args.gate:
        from sgg_torch.utils.profiling import launch_counts
        ms = globals()[f"stage_{args.gate}"](args.stage, dev, args.tiny)
        res = {"ms": ms, "launches": {k: v["launches"]
                                      for k, v in launch_counts().items()}}
        print("STAGE_RESULT " + json.dumps(res), flush=True)
        return res

    from sgg_torch.utils.profiling import device_info
    info = device_info(dev)
    print(f"reprobe_gates on {info['name']} "
          f"({info['power_limit'] or 'no card'})", flush=True)
    results, launches = {}, {}
    for gate, stages in STAGES.items():
        t0 = time.time()
        r = {f"{st}_ms": run_stage(gate, st, args.device, args.tiny,
                                   launches=launches)
             for st in stages}
        r["winner"] = verdict(stages, r)
        r["elapsed_s"] = round(time.time() - t0, 1)
        results[gate] = r
        print(f"{gate}: {json.dumps(r)}", flush=True)
    for gate, why in NOT_PORTED.items():
        results[gate] = {"n/a": why}
        print(f"{gate}: n/a ({why})", flush=True)
    out = {"tool": "reprobe_gates", "device": info, "gates": results,
           "launches": launches}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
