"""The IMP family: the program's relation model (``RelModelIMP``: iterative
message passing, Xu et al. 2017) on the frozen VGG16 trunk, trained in
predcls or sgcls with clipped SGD, and with the ICCV 2021 GAN
(``GANModel``, Adam) where the configuration sets ``gan``; evaluated by
``val_epoch`` in predcls and sgcls. Its plain reference is
``benchmarks/reference`` (``model``, ``gan``, ``perturb``), its work counts
``benchmarks/work.py``. The interface is ``benchmarks/families``'s.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmarks import check, check_eval, evaluation, program, work
from benchmarks.reference import data as ref_data
from benchmarks.reference import gan as ref_gan
from benchmarks.reference import model as ref_model
from benchmarks.reference import perturb as ref_perturb
from benchmarks.traffic import vocabulary

CONFIG_KEYS = ("mode", "loss", "batch_size", "max_nodes", "max_edges",
               "rels_per_img", "num_workers", "print_interval",
               "image_format", "compute_dtype", "lr", "l2", "clip", "alpha",
               "beta", "gamma", "use_bias", "edge_model", "backbone", "gan",
               "ganlosses", "lrG", "lrD", "ganw", "largeD", "beta1", "beta2",
               "perturb", "L", "topk", "graphn_a", "init_embed", "attachG")
REGIMES = ("predcls", "sgcls")
ELEM = {"bfloat16": 2, "float32": 4}


# -- the program ------------------------------------------------------------

def relation_model(cfg: dict, device, weights):
    """The program's relation model on ``device``, in the configuration's
    compute type, holding ``weights``."""
    from sgg_torch.models.relhead import RelModelIMP
    dt = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" \
        else torch.float32
    with torch.device(device):
        model = RelModelIMP(
            num_classes=cfg["num_classes"],
            num_predicates=cfg["num_predicates"], mode=cfg["mode"],
            use_bias=cfg["use_bias"], backbone=cfg["backbone"],
            edge_model=cfg["edge_model"], obj_dim=cfg["obj_dim"],
            hidden_dim=cfg["hidden_dim"], mp_iter=cfg["mp_iter"])
    model = model.to_compute_dtype(dt).to(device).eval()
    program.load_weights(model, weights)
    return model


def gan_model(cfg: dict, device, weights, sn):
    """The program's GAN on ``device`` holding ``weights`` and the spectral
    norms' starting vectors ``sn``."""
    from sgg_torch.models.gan import GANModel
    with torch.device(device):
        gan = GANModel(num_classes=cfg["num_classes"],
                       num_predicates=cfg["num_predicates"],
                       fmap_sz=cfg["im_scale"] // 16, largeD=cfg["largeD"])
    gan = gan.to(device)
    program.load_weights(gan, weights)
    buffers = dict(gan.named_buffers())
    with torch.no_grad():
        for name, u in sn.items():
            buffers[name].copy_(u)
    return gan


def build(cfg: dict, device, weight_seed: int, split, image_dir: str, names,
          cfg_seed: int, log=None, tests=None) -> program.Built:
    """The trainer with the relation model's weights from ``weight_seed``
    and, with ``gan``, the GAN's from the next two seeds (the reference
    draws the same)."""
    from sgg_torch.train.trainer import Trainer
    weights = ref_model.make_weights(ref_model.param_spec(cfg), weight_seed,
                                     device, ref_model.stored_types(cfg))
    model = relation_model(cfg, device, weights)
    del weights
    gan = None
    if cfg.get("gan"):
        gan = gan_model(cfg, device,
                        ref_gan.make(ref_gan.param_spec(cfg),
                                     weight_seed + 1, device),
                        ref_gan.make(ref_gan.sn_spec(cfg), weight_seed + 2,
                                     device))
    config = program.program_config(cfg, CONFIG_KEYS, cfg_seed,
                                    torch.device(device).type, image_dir)
    ds = program.dataset(split, image_dir, names, cfg)
    if log is not None:
        log("weights made, dataset built")
    trainer = Trainer(config, {"train": ds, **(tests or {})}, model=model,
                      gan=gan)
    if gan is None:
        return program.Built(trainer, "train_step")
    return program.Built(trainer, "gan_step", [trainer.g_opt, trainer.d_opt])


# -- the reference's training steps -----------------------------------------

def reference_steps(cfg: dict, split, paths: List[str], cfg_seed: int,
                    weight_seed: int, device, low: str, n_steps: int,
                    workers: int = 8, batch_hook=None) -> dict:
    """The reference's steps (``benchmarks/families``): the relation model
    in ``low`` ("bf16" as the configuration states, "fp8" for the control,
    which also computes the GAN in bfloat16) under clipped SGD, and with
    ``gan`` the GAN under its two Adams, on GraphN's perturbed graphs."""
    num = ref_model.Numerics(low)
    P = ref_model.make_weights(ref_model.param_spec(cfg), weight_seed,
                               device, stored=ref_model.stored_types(cfg))
    gan = cfg.get("gan", False)
    if gan:
        P.update(ref_gan.make(ref_gan.param_spec(cfg), weight_seed + 1,
                              device))
        S = ref_gan.make(ref_gan.sn_spec(cfg), weight_seed + 2, device)
        names, _ = vocabulary(cfg["num_classes"], cfg["num_predicates"])
        graphn = ref_perturb.GraphN(
            ref_perturb.class_embeddings(names),
            *ref_perturb.pair_counts(split.gt_classes, split.relationships),
            L=cfg["L"], topk=cfg["topk"], alpha=cfg["graphn_a"])
    for n, t in P.items():
        t.requires_grad_(not ref_model.frozen(n))
    rel_names = [n for n, _, _ in ref_model.param_spec(cfg)
                 if not ref_model.frozen(n)]
    sgd = ref_model.ClippedSGD({n: P[n] for n in
                                [n for n, _, _ in ref_model.param_spec(cfg)]},
                               lr=cfg["lr"] * cfg["batch_size"],
                               l2=cfg["l2"], clip=cfg["clip"])
    opts = [sgd]
    if gan:
        opts += [ref_gan.Adam(P, [n for n in P if n.startswith(prefix)], lr,
                              cfg["beta1"], cfg["beta2"])
                 for prefix, lr in (("G.", cfg["lrG"]), ("D_", cfg["lrD"]))]
    init = {n: P[n].detach().clone() for n in P if not ref_model.frozen(n)}
    gen = torch.Generator(device=device).manual_seed(cfg_seed * 100003)
    losses, first = [], {}
    entry_paths = [paths[i] for i in split.entry_file]
    for k in range(n_steps):
        idx = ref_data.batch_indices(len(split), cfg["batch_size"], cfg_seed,
                                     0, k)
        nb = ref_data.batch(entry_paths, split.gt_boxes, split.gt_classes,
                            split.relationships, idx, cfg_seed, 0,
                            cfg["im_scale"], cfg["max_nodes"],
                            cfg["max_edges"], workers)
        if batch_hook is not None:
            nb = batch_hook(nb)
        tb = check.batch_tensors(nb, device)
        if gan:
            fake = graphn.batch(nb["classes"], nb["boxes"], nb["rels"],
                                nb["node_mask"], nb["rel_mask"], 0, cfg_seed)
            losses.append(ref_gan.gan_step(
                P, S, opts, tb, torch.from_numpy(fake).to(device), gen, cfg,
                num))
        else:
            losses.append(ref_model.train_step(P, sgd, tb, gen, cfg, num))
        if k == 0:
            first = {n: sgd.momentum[n] - cfg["l2"] * init[n]
                     for n in rel_names}
            for opt in opts[1:]:
                first.update({n: opt.mu[n] / (1 - opt.b1)
                              for n in opt.names})
    change = {n: P[n].detach() - init[n] for n in init}
    # SGD's momentum holds the L2 term, the Adams' first moments none
    decay = {n: 0.0 if n.startswith(("G.", "D_")) else cfg["l2"]
             for n in init}
    return {"losses": losses, "first": first, "change": change,
            "init": init, "decay": decay}


def half_batch(nb: dict) -> dict:
    """Half of the batch left out: its nodes and relations masked."""
    nb = dict(nb)
    h = nb["node_mask"].shape[0] // 2
    for k in ("node_mask", "rel_mask"):
        nb[k] = nb[k].copy()
        nb[k][h:] = False
    return nb


TRAIN_FAULTS = {"fault_half": half_batch}


# -- evaluation --------------------------------------------------------------

def eval_regimes(cfg: dict):
    return REGIMES


def eval_probe(probe) -> list:
    """Wraps ``val_epoch``'s ``make_eval_step`` (its steps counted by
    regime, each timed) and ``_to_numpy`` (a batch kept where its unions'
    dedup held; the pair slots run and the valid pairs among them
    counted, by rung)."""
    from sgg_torch.eval import driver
    make, to_numpy = driver.make_eval_step, driver._to_numpy
    rec = probe.rec

    def make_eval_step(model, mode=None, max_pairs=None, dedup=True,
                       device="cuda"):
        inner = make(model, mode=mode, max_pairs=max_pairs, dedup=dedup,
                     device=device)

        def step(batch):
            if dedup:
                probe.count[mode] = probe.count.get(mode, -1) + 1
            probe.at = (mode, probe.count.get(mode, 0))
            t0 = time.time_ns()
            out = inner(batch)
            if probe.window:
                rec.steps.append((t0, time.time_ns(), "eval_step"))
            return out

        return step

    def host(out):
        got = to_numpy(out)
        kept = "dedup_ok" not in got or bool(got["dedup_ok"].all())
        if probe.window and kept:
            mode, k = probe.at
            mask = got["pair_mask"]
            key = f"{mode} {mask.shape[1]}"
            rec.rungs[key] = rec.rungs.get(key, 0) + 1
            rec.slots += mask.size
            rec.valid += int(mask.sum())
            if k < probe.check:
                rec.outputs[(mode, k)] = got
        return got

    driver.make_eval_step = make_eval_step
    driver._to_numpy = host
    return [(driver, "make_eval_step", make), (driver, "_to_numpy", to_numpy)]


def eval_program(kept: dict, split, cfg: dict) -> dict:
    """``{(mode, entry): outputs}`` from the host outputs the window kept,
    ``{(mode, batch): val_epoch's arrays}``: each image's real objects and
    its valid pairs."""
    B = cfg["eval_batch_size"]
    out = {}
    for (mode, k), host in kept.items():
        for i, mask in enumerate(host["pair_mask"]):
            e = k * B + i
            if e >= len(split):
                break
            n = len(split.gt_classes[e])
            out[(mode, e)] = {"obj_scores": host["obj_scores"][i][:n],
                              "obj_preds": host["obj_preds"][i][:n],
                              "pairs": host["pairs"][i][mask],
                              "rel_dists": host["rel_dists"][i][mask]}
    return out


def ordered_pairs(n: int) -> np.ndarray:
    """(n(n-1), 2) every ordered pair of distinct objects, subject-major."""
    s, o = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    keep = s != o
    return np.stack([s[keep], o[keep]], 1)


def image_outputs(P, canvas: np.ndarray, boxes: np.ndarray, cfg: dict,
                  num, device) -> Dict[str, np.ndarray]:
    """The reference's eval forward of one image: sgcls's object scores
    and labels, every ordered pair and its predicate distribution."""
    pairs = ordered_pairs(len(boxes))
    pt = torch.from_numpy(pairs).to(device)[None]
    batch = {"images": torch.from_numpy(canvas).to(device)[None],
             "boxes": torch.from_numpy(boxes).to(device)[None]}
    out = ref_model.relation_model(P, batch, pt, torch.ones(
        pt.shape[:2], dtype=torch.bool, device=device), None, cfg, num)
    probs = torch.softmax(out["obj_logits"][0].float(), -1)
    scores, preds = probs[:, 1:].max(-1)
    return {"obj_scores": scores.cpu().numpy(),
            "obj_preds": (preds + 1).cpu().numpy(), "pairs": pairs,
            "rel_dists": torch.softmax(out["rel_logits"][0].float(), -1)
            .cpu().numpy()}


def eval_reference(cfg: dict, split, paths: List[str], weight_seed: int,
                   device, low: str, entries, workers: int = 8) -> dict:
    """Each entry alone, decoded and resized by the reference, every
    ordered pair of its distinct objects, no ladder, no dedup, no
    dropout."""
    num = ref_model.Numerics(low)
    out = {}
    P = ref_model.make_weights(ref_model.param_spec(cfg), weight_seed,
                               device, ref_model.stored_types(cfg))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        examples = pool.map(
            lambda i: ref_data.test_example(
                paths[split.entry_file[i]], split.gt_boxes[i],
                cfg["im_scale"]), entries)
        for i, (canvas, boxes) in zip(entries, examples):
            out[i] = image_outputs(P, canvas, boxes, cfg, num, device)
    return out


def eval_as_program(ref: dict, split) -> dict:
    """The reference's outputs as the program's of both regimes (predcls:
    the annotated labels, scores 1)."""
    out = {}
    for e, r in ref.items():
        out[("sgcls", e)] = r
        out[("predcls", e)] = dict(
            r, obj_preds=np.asarray(split.gt_classes[e]),
            obj_scores=np.ones(len(r["obj_scores"]), np.float32))
    return out


def eval_compare(prog: dict, ref: dict, split, cfg: dict) -> dict:
    """``check_eval.compare`` over both regimes, the object scores and
    labels in sgcls, where the model predicts them."""
    return check_eval.compare(prog, ref, split, REGIMES, scored=("sgcls",))


@contextlib.contextmanager
def half_pairs():
    """The eval step's candidates lose every other ordered pair slot
    (``train/step.py``'s ``all_pairs``): half of the pairs left out."""
    from sgg_torch.train import step
    orig = step.all_pairs

    def all_pairs(node_mask):
        pairs, mask = orig(node_mask)
        slot = torch.arange(mask.shape[1], device=mask.device)
        return pairs, mask & (slot % 2 == 0)

    step.all_pairs = all_pairs
    try:
        yield
    finally:
        step.all_pairs = orig


@contextlib.contextmanager
def dedup_map():
    """The unions' dedup gathers each ordered pair from its neighbour's
    row (``models/relhead.py``'s ``unordered_union_index``, its row map
    rolled by one slot)."""
    from sgg_torch.models import relhead
    orig = relhead.unordered_union_index

    def index(*args, **kw):
        uni, gidx, ok, n = orig(*args, **kw)
        return uni, torch.roll(gidx, 1, dims=1), ok, n

    relhead.unordered_union_index = index
    try:
        yield
    finally:
        relhead.unordered_union_index = orig


EVAL_FAULTS = {"fault_half_pairs": half_pairs, "fault_dedup_map": dedup_map}


# -- the work counts ---------------------------------------------------------

step_sizes = work.step_sizes
step_flops = work.step_flops


def eval_flops(split, cfg: dict) -> int:
    """Both regimes' valid work over ``split`` (``work.eval_flops``)."""
    return len(REGIMES) * sum(work.eval_flops(len(c), cfg)
                              for c in split.gt_classes)


def kernel_work(run, kernel: str):
    """Training: K1 one launch on the real boxes and one on the sampled
    edges' union boxes a forward, on the real map in the compute type
    and, with the GAN, on the fake map (float32) in the G phase and in the
    reconstruction; K1-bwd-fmap the same two launches on the fake map's
    gradient (GAN only); K2 once a step. Evaluation: K1 on each batch's
    real boxes and on its valid pairs' unordered unions, once a regime."""
    cfg = run.cfg
    S, C = cfg["im_scale"], cfg["fmap_channels"]
    elem = ELEM[cfg["compute_dtype"]]
    if run.ev is not None:
        if kernel != "k1":
            return None
        return [(work.roi_align_work(rois, len(counts), S, C, elem),
                 len(REGIMES))
                for counts in evaluation.batch_counts(run.split, cfg)
                for rois in (sum(counts),
                             sum(n * (n - 1) // 2 for n in counts))]
    B = cfg["batch_size"]
    if kernel == "k2":
        return [(work.vgg_conv1_work(B, S, elem), run.rec.trace_steps)]
    maps = {"k1": [elem] + ([4, 4] if cfg.get("gan") else []),
            "k1_bwd_fmap": [4] if cfg.get("gan") else []}[kernel]
    if not maps:
        return None
    return [(work.roi_align_work(rois, B, S, C, e), 1)
            for ns, ms in run.step_sizes(run.rec.trace_first_step,
                                         run.rec.trace_steps)
            for e in maps for rois in (sum(ns), sum(ms))]
