"""Time of the GAN's F/G/D training step by phase and by part.

    python -m sgg_torch.tools.profile_gan [--batch 24 --nodes 40
        --edges 256 --img 592] [--iters 10] [--bf16] [-device cpu --tiny]

Counterpart of ``tools/profile_gan.py`` through the port's
``train/gan_step.py``, with the GAN the trainer builds for ``-gan
-largeD`` (``chip_smoke.py`` phase 11's command): the f32 ``GANModel``
(the JAX trainer's; a bf16 GAN exists only in ``bench.py``) beside the
bf16 VGG16 relation model, seeded random weights, one synthetic batch,
the batch's own classes painted (no perturbation), PyTorch's TF32
defaults. Stages:

- ``phase F``: the plain SGG step (``make_train_step``) on a deep copy of
  the relation model and a fresh optimizer, so that the full step starts
  from the untouched state;
- G's forward (GCN, layout, CRN) in eval mode, and its forward and
  backward (the gradient of the map's sum with respect to G);
- the relation model's forward on the fake map (run twice in the G
  phase: adversarial and reconstruction), K1 on its ``f32`` route;
- each discriminator's forward on the fake pools or map;
- ``phase D``: the three discriminators' real-and-fake BCE, forward and
  backward;
- the full step, timed in place, and the same step's phases F, G and D
  read from CUDA events at the step's own marks (host clock on the CPU).

``--bf16`` times a bf16 GAN, as the JAX tool builds one (``GANModel(dtype=
bfloat16)``, ``tools/profile_gan.py:83``; the JAX trainer never does): the
stages run under ``torch.autocast`` to bf16, so G's and the Ds' products
and convolutions compute in bf16 over their f32 weights, the fake map is
bf16 (K1 and K1-bwd-fmap take their bf16 routes), and the relation
model's f32 output layers compute in bf16 too. The JSON line says which
GAN was timed (``dtype``).

MFUs of the relation model's stages and of the full step are read
against the bf16 rate, those of G and the Ds against the TF32 rate (cuDNN
may take TF32 by default) or, with ``--bf16``, the bf16 rate. The last
line is the JSON object of ``StageProfiler.line`` with ``phases_ms`` and
the shares of the step.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Optional, Sequence

import torch

from sgg_torch.config import Config
from sgg_torch.device import resolve_device
from sgg_torch.models.gan import GANModel
from sgg_torch.models.gan.gan import init_gan_weights
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.tools import _common
from sgg_torch.train.assign import sample_edges
from sgg_torch.train.gan_step import (create_gan_optimizers,
                                      make_gan_train_step, masked_bce)
from sgg_torch.train.state import Optimizer
from sgg_torch.train.step import make_train_step
from sgg_torch.utils.profiling import StageProfiler

TINY_GAN = {"hidden_dim": 8, "n_layers_G": 2}
STAGES = ("phase F: SGG fwd+bwd+update", "G forward (GCN+layout+CRN)",
          "G fwd+bwd (grad wrt G params)", "SGG fwd on fake fmap (per call)",
          "D_nodes fwd", "D_edges fwd", "D_global fwd",
          "phase D: 3xD fwd+bwd (2 passes each)", "FULL GAN F/G/D step")


def phase_times(step, batch, gen, device, iters: int):
    """Mean ms of the step's phases F, G and D over ``iters`` steps:
    CUDA events at the step's marks (the host clock on the CPU)."""
    cuda = device.type == "cuda"
    sums = {"F": 0.0, "G": 0.0, "D": 0.0}
    for _ in range(iters):
        if cuda:
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ("start", "F", "G", "D")}
            ev["start"].record()
            step(batch, batch.classes, gen,
                 mark=lambda p: ev[p].record())
            torch.cuda.synchronize(device)
            prev = "start"
            for p in ("F", "G", "D"):
                sums[p] += ev[prev].elapsed_time(ev[p])
                prev = p
        else:
            t = {"start": time.perf_counter()}
            step(batch, batch.classes, gen,
                 mark=lambda p: t.__setitem__(p, time.perf_counter()))
            prev = "start"
            for p in ("F", "G", "D"):
                sums[p] += (t[p] - t[prev]) * 1e3
                prev = p
    return {p: v / iters for p, v in sums.items()}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = _common.parser(__doc__, 24, 40, 256, 592)
    ap.add_argument("--bf16", action="store_true",
                    help="a bf16 GAN (autocast), as the JAX tool builds it")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with (torch.autocast(dev.type, dtype=torch.bfloat16) if args.bf16
          else contextlib.nullcontext()):
        return profile(args, dev)


def profile(args, dev) -> dict:
    B = args.batch
    batch = _common.synthetic_batch(args, dev)
    cfg = Config(batch_size=B, max_nodes=args.nodes, max_edges=args.edges,
                 mode="sgcls", loss="dnorm", gan=True, largeD=True,
                 compute_dtype="bfloat16", device=args.device)
    model = init_weights(RelModelIMP(
        _common.NUM_CLASSES, _common.NUM_PREDICATES, mode="sgcls",
        **_common.widths(args)), 0).to_compute_dtype(torch.bfloat16)
    model = model.to(dev).eval()
    gan = init_gan_weights(GANModel(
        _common.NUM_CLASSES, _common.NUM_PREDICATES,
        fmap_sz=args.img // 16, largeD=True,
        **(TINY_GAN if args.tiny else {})), 1).to(dev)
    optimizer = Optimizer(cfg, model, 2)
    g_opt, d_opt = create_gan_optimizers(cfg, gan)
    gen = _common.generator(dev)
    sampled, pm = sample_edges(gen, batch.rels, batch.rel_mask,
                               batch.node_mask, max_out=args.edges)
    pairs, labels = sampled[..., :2], sampled[..., 2]
    boxes01 = batch.boxes / torch.full((), float(args.img), device=dev)
    g_in = (batch.classes, boxes01, batch.rels, batch.node_mask,
            batch.rel_mask)
    gan_dtype = "bfloat16" if args.bf16 else "float32"
    prof = StageProfiler("profile_gan", dev,
                         peak="bf16" if args.bf16 else "f32",
                         iters=args.iters, batch=B)
    print(f"GAN: {gan_dtype} ({sum(p.numel() for p in gan.parameters())} "
          f"parameters, largeD, {args.img // 16}x{args.img // 16}x"
          f"{gan.n_ch} maps); relation model bf16", flush=True)

    # F in isolation, on copies: the full step starts from the same state
    f_model = copy.deepcopy(model)
    f_step = make_train_step(f_model, cfg, Optimizer(cfg, f_model, 2))
    prof.stage("phase F: SGG fwd+bwd+update", lambda: f_step(batch, gen),
               peak="bf16")
    del f_model, f_step

    gan.eval()
    with torch.no_grad():
        fake = prof.stage("G forward (GCN+layout+CRN)",
                          lambda: gan.generate(*g_in))

    def g_grad():
        gan.zero_grad(set_to_none=True)
        gan.generate(*g_in).float().sum().backward()

    prof.stage("G fwd+bwd (grad wrt G params)", g_grad)
    gan.zero_grad(set_to_none=True)
    with torch.no_grad():
        out = prof.stage("SGG fwd on fake fmap (per call)", lambda: model(
            None, batch.boxes, batch.classes, pairs, pm, fmap=fake,
            return_feats=True), peak="bf16")
        nodes, edges = out["node_pool"], out["edge_pool"]
        real = model(batch.images, batch.boxes, batch.classes, pairs, pm,
                     return_feats=True)
        prof.stage("D_nodes fwd", lambda: gan.disc_nodes(nodes,
                                                         batch.classes))
        prof.stage("D_edges fwd", lambda: gan.disc_edges(edges, labels))
        prof.stage("D_global fwd", lambda: gan.disc_global(fake))

    def d_grad():
        gan.zero_grad(set_to_none=True)
        loss = (masked_bce(gan.disc_nodes(real["node_pool"], batch.classes),
                           1.0, batch.node_mask)
                + masked_bce(gan.disc_nodes(nodes, batch.classes), 0.0,
                             batch.node_mask)
                + masked_bce(gan.disc_edges(real["edge_pool"], labels), 1.0,
                             pm)
                + masked_bce(gan.disc_edges(edges, labels), 0.0, pm)
                + masked_bce(gan.disc_global(real["fmap"]), 1.0, None)
                + masked_bce(gan.disc_global(fake), 0.0, None))
        loss.backward()
        return loss.detach()

    prof.stage("phase D: 3xD fwd+bwd (2 passes each)", d_grad)
    gan.zero_grad(set_to_none=True)
    del out, real, nodes, edges
    step = make_gan_train_step(model, gan, cfg, optimizer, g_opt, d_opt)
    prof.stage("FULL GAN F/G/D step",
               lambda: step(batch, batch.classes, gen), peak="bf16")
    phases = phase_times(step, batch, gen, dev, args.iters)
    st = prof.stages
    key = "card_ms" if st["D_nodes fwd"]["card_ms"] is not None \
        else "wall_ms"
    full = st["FULL GAN F/G/D step"][key]
    shares = {"F": st["phase F: SGG fwd+bwd+update"][key] / full,
              "G-fwd": st["G forward (GCN+layout+CRN)"][key] / full,
              "SGG-on-fake (a call)":
                  st["SGG fwd on fake fmap (per call)"][key] / full,
              "D-phase": st["phase D: 3xD fwd+bwd (2 passes each)"][key]
              / full}
    print(f"the full step's phases ({'card' if key == 'card_ms' else 'host'}"
          f" ms): " + "  ".join(f"{p} {v:.3f}" for p, v in phases.items()),
          flush=True)
    print(f"shares of the full step ({key}): " + "  ".join(
        f"{k} {100 * v:.0f}%" for k, v in shares.items()), flush=True)
    return prof.line(sizes=vars(args), dtype=f"{gan_dtype} GAN, bfloat16 SGG",
                     phases_ms=phases, phases_of=key, shares=shares)


if __name__ == "__main__":
    main()
