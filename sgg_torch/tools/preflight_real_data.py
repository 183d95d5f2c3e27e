"""Real-data preflight: one command that prints ``READY`` or the exact
blockers.

    python -m sgg_torch.tools.preflight_real_data -data DATA_DIR
        [-split stanford] [--dryrun-images 50] [--skip-dryrun]
        [--probe-egress [--download]] [-device cpu]

Counterpart of ``tools/preflight_real_data.py``: the same checks in the
same order, the same ``BLOCKER`` lines, INFO JSON line, verdict (``READY``
or ``BLOCKED (n)``) and exit codes (0, 1). Every check that crashes is
itself a blocker with the exception as its message, never a traceback.

1. the VG tree and its HDF5/JSON schema (files, dataset shapes,
   cross-references, vocabulary, the full-VG split sizes of
   ``sgg_torch/data/visual_genome.py`` ``EXPECTED``); reading the HDF5
   file needs ``h5py``: without it (the card's machine) the check is a
   blocker that names ``h5py``;
2. a decode sample of the first N images (PIL);
3. free disk and a sequential-read measurement -> the feature-cache
   decision (the cache's entry size as ``bench_cache_io`` counts it);
4. a dry run: the port's splits, ``BatchLoader``, one train step and one
   ``val_epoch`` batch of the full model on the card (``-device cpu``
   for the CPU);
5. the egress probe: resolve the dataset's public link through Yandex's
   REST API (``sgg_torch/data/download.py``), and with ``--download``
   fetch it. It contacts an outside host, so it runs only when asked
   (``--probe-egress``); otherwise INFO's ``egress`` reads ``not probed``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


class Report:
    """The run's blockers and INFO fields."""

    def __init__(self):
        self.blockers: List[str] = []
        self.info: Dict = {}

    def blocker(self, msg: str) -> None:
        self.blockers.append(msg)
        print(f"  BLOCKER: {msg}")


def ok(msg: str) -> None:
    print(f"  ok: {msg}")


# ---------------------------------------------------------------------------
# 1. tree + schema


def check_vg_tree(rep: Report, data_dir: str):
    print("[1/5] VG tree + schema")
    base = os.path.join(data_dir, "VG", "stanford_filtered")
    images = os.path.join(data_dir, "VG", "VG_100K")
    needed = [os.path.join(base, f) for f in
              ("VG-SGG.h5", "VG-SGG-dicts.json", "image_data.json")]
    missing = [p for p in needed if not os.path.isfile(p)]
    if not os.path.isdir(images):
        missing.append(images)
    if missing:
        rep.blocker(f"missing files/dirs: {missing} — run "
                    "sgg_torch.data.download.download_all_data or place "
                    "the extracted VG.tar under the data dir")
        return None
    import h5py
    info = rep.info
    with open(needed[1]) as f:
        dicts = json.load(f)
    n_cls = len(dicts["label_to_idx"]) + 1
    n_pred = len(dicts["predicate_to_idx"]) + 1
    info["vg_classes"] = n_cls
    info["vg_predicates"] = n_pred
    if (n_cls, n_pred) == (151, 51):
        ok("vocab 150 classes + 50 predicates (full VG)")
    else:
        ok(f"vocab {n_cls - 1} classes + {n_pred - 1} predicates "
           "(NON-standard — custom subset?)")
    with open(needed[2]) as f:
        image_data = json.load(f)
    with h5py.File(needed[0], "r") as h5:
        need_ds = ["split", "img_to_first_box", "img_to_last_box",
                   "img_to_first_rel", "img_to_last_rel", "labels",
                   "boxes_1024", "relationships", "predicates"]
        absent = [d for d in need_ds if d not in h5]
        if absent:
            rep.blocker(f"VG-SGG.h5 missing datasets: {absent}")
            return None
        n_img = h5["split"].shape[0]
        if n_img != len(image_data):
            rep.blocker(f"split length {n_img} != image_data.json entries "
                        f"{len(image_data)}")
        n_box = h5["labels"].shape[0]
        if h5["boxes_1024"].shape != (n_box, 4):
            rep.blocker(f"boxes_1024 shape {h5['boxes_1024'].shape} != "
                        f"({n_box}, 4)")
        if int(h5["labels"][:].max()) >= n_cls:
            rep.blocker("labels exceed the dicts vocab")
        n_rel = h5["relationships"].shape[0]
        if h5["predicates"].shape[0] != n_rel:
            rep.blocker("relationships/predicates length mismatch")
        split = h5["split"][:]
        info["images"] = int(n_img)
        info["boxes"] = int(n_box)
        info["rels"] = int(n_rel)
        info["train_images"] = int((split == 0).sum())
        info["test_images"] = int((split == 2).sum())
    from sgg_torch.data.visual_genome import EXPECTED
    full = len(image_data) == EXPECTED["filenames"]
    info["full_vg"] = bool(full)
    ok(f"{info['images']} images ({info['train_images']} train / "
       f"{info['test_images']} test), {info['boxes']} boxes, "
       f"{info['rels']} rels "
       + ("— matches full VG" if full else
          f"— NOT full VG ({EXPECTED['filenames']} expected); "
          "check_sizes will be relaxed"))
    return image_data


def check_images(rep: Report, data_dir: str, image_data, n: int = 50):
    print(f"[2/5] image decode sample (first {n})")
    if image_data is None:
        rep.blocker("skipped (tree check failed)")
        return
    from PIL import Image
    images = os.path.join(data_dir, "VG", "VG_100K")
    missing, bad, t0, nbytes = [], [], time.time(), 0
    for entry in image_data[:n]:
        p = os.path.join(images, os.path.basename(entry["url"]))
        if not os.path.isfile(p):
            missing.append(os.path.basename(p))
            continue
        try:
            with Image.open(p) as im:
                im.convert("RGB")
            nbytes += os.path.getsize(p)
        except Exception as e:  # any undecodable file is a finding
            bad.append((os.path.basename(p), repr(e)[:60]))
    dt = time.time() - t0
    if missing:
        rep.blocker(f"{len(missing)}/{n} images missing (first: "
                    f"{missing[:5]})")
    if bad:
        rep.blocker(f"{len(bad)} images fail to decode (first: {bad[:3]})")
    if not missing and not bad:
        rep.info["decode_mb_s"] = round(nbytes / 2**20 / max(dt, 1e-9), 1)
        ok(f"{n} images decode at {rep.info['decode_mb_s']} MB/s")


# ---------------------------------------------------------------------------
# 3. disk budget + cache decision

# the card's trunk rate the cache must beat to pay (the JAX tool's figure,
# kept as its decision threshold; bench_cache_io takes the measured rate)
TRUNK_IMG_S = 400


def check_disk(rep: Report, data_dir: str):
    print("[3/5] disk budget + feature-cache decision")
    info = rep.info
    usage = shutil.disk_usage(data_dir)
    free_gb = usage.free / 2**30
    info["disk_free_gb"] = round(free_gb, 1)
    # 592 px VGG16 map entry: 37 x 37 x 512 bf16 (data/feature_cache.py)
    entry = 37 * 37 * 512 * 2
    train = info.get("train_images", 57723)
    for orient in (1, 2):
        info[f"cache_gb_{orient}orient"] = round(
            train * entry * orient / 2**30, 1)
    ok(f"free {free_gb:.0f} GB; train-split trunk cache needs "
       f"{info['cache_gb_1orient']} GB (1 orientation, hflip pinned off) / "
       f"{info['cache_gb_2orient']} GB (2)")
    if free_gb < info["cache_gb_1orient"]:
        ok("NOT enough disk for any feature cache — run without "
           "-feature_cache (informational, not a blocker)")
        info["cache_decision"] = "no_disk"
        return
    probe = os.path.join(data_dir, ".preflight_io_probe")
    try:
        blk = os.urandom(1 << 20)
        with open(probe, "wb") as f:
            for _ in range(256):
                f.write(blk)
        os.sync()
        t0 = time.time()
        with open(probe, "rb") as f:
            while f.read(1 << 22):
                pass
        mb_s = 256 / max(time.time() - t0, 1e-9)
        info["disk_read_mb_s"] = round(mb_s, 0)
        cache_img_s = mb_s * 2**20 / entry
        info["cache_read_img_s_est"] = round(cache_img_s, 0)
        info["cache_decision"] = ("cache" if cache_img_s > TRUNK_IMG_S
                                  else "recompute")
        ok(f"disk reads {mb_s:.0f} MB/s -> est. {cache_img_s:.0f} cached "
           f"img/s vs ~{TRUNK_IMG_S} img/s trunk recompute -> "
           f"{info['cache_decision']} wins (warm-cache reads are faster; "
           f"run python -m sgg_torch.tools.bench_cache_io for the full "
           f"verdict)")
    finally:
        if os.path.exists(probe):
            os.remove(probe)


# ---------------------------------------------------------------------------
# 4. dry run


def build_model(config, train, device):
    """The dry run's model (``trainer.build_model``'s; tests narrow it)."""
    from sgg_torch.train.trainer import build_model as build
    return build(config, train, device=device)


def dryrun(rep: Report, data_dir: str, n_images: int, device: str):
    print("[4/5] dry-run: splits() -> BatchLoader -> 1 train + 1 eval step")
    try:
        import dataclasses as dc

        import torch

        from sgg_torch import constants
        from sgg_torch.config import Config
        from sgg_torch.data import visual_genome as vg
        from sgg_torch.data.pipeline import BatchLoader
        from sgg_torch.eval.driver import val_epoch
        from sgg_torch.train.state import Optimizer
        from sgg_torch.train.step import make_train_step

        info = rep.info
        check = info.get("full_vg", False)
        # full VG uses the reference's 5000-image val carve; a smaller tree
        # a proportional one, so that train never comes back empty
        n_val = 5000 if check else max(info.get("train_images", 8) // 8, 1)
        t0 = time.time()
        train = vg.load_split(data_dir, "train", check_sizes=check,
                              num_val_im=n_val)
        test = vg.load_split(data_dir, "test", check_sizes=check,
                             num_val_im=n_val)
        info["splits_s"] = round(time.time() - t0, 1)
        ok(f"splits parsed in {info['splits_s']}s "
           f"({len(train)} train / {len(test)} test)")

        def head(ds, n):
            return dc.replace(ds, filenames=ds.filenames[:n],
                              gt_boxes=ds.gt_boxes[:n],
                              gt_classes=ds.gt_classes[:n],
                              relationships=ds.relationships[:n])

        train = head(train, n_images)
        test = head(test, max(n_images // 5, 2))
        cfg = Config(batch_size=2, mode="sgcls", compute_dtype="float32",
                     data=data_dir, device=device)
        model = build_model(cfg, train, device)
        t0 = time.time()
        res = val_epoch(model, test, cfg, "test", eval_batch_size=2,
                        n_batches=1, verbose=False, device=device)
        ok(f"eval batch: R@100 {res.get('avg/test_R', float('nan')):.4f} "
           f"({time.time() - t0:.1f}s incl. first launches)")
        loader = BatchLoader(train, batch_size=2, max_nodes=cfg.max_nodes,
                             max_edges=cfg.max_edges, num_workers=1,
                             im_scale=constants.IM_SCALE)
        batch = next(iter(loader))
        step = make_train_step(model, cfg, Optimizer(cfg, model))
        gen = torch.Generator(device=device).manual_seed(1)
        t0 = time.time()
        loss = float(step(batch, gen)["total"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"train-step loss is {loss}")
        ok(f"train step: loss {loss:.3f} ({time.time() - t0:.1f}s)")
    except Exception as e:  # the dry run's failure is the finding
        rep.blocker(f"dry-run failed: {type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# 5. egress


def check_egress(rep: Report, data_dir: str, do_download: bool):
    print("[5/5] egress probe (Yandex REST link resolution)")
    import urllib.parse
    import urllib.request

    from sgg_torch.data import download as dl
    api = dl._API.format(urllib.parse.quote(dl.VG_LINK[0]))
    try:
        with urllib.request.urlopen(api, timeout=20) as resp:
            info = json.loads(resp.read())
        if "href" in info:
            rep.info["egress"] = "yes"
            ok("egress works — download_all_data(data_dir) would fetch "
               "the 60 GB archives here")
            if do_download:
                dl.download_all_data(data_dir, gqa=False)
        else:
            rep.info["egress"] = f"api_error: {info.get('error')}"
            ok(f"API reachable but refused: {info.get('error')} "
               "(try later or download manually)")
    except Exception as e:  # no route, DNS, TLS, HTTP: all read "no"
        rep.info["egress"] = f"no ({type(e).__name__})"
        ok(f"no egress ({type(e).__name__}: {str(e)[:80]}) — download the "
           "archives on a connected machine (see MIGRATION.md)")


def _guarded(rep: Report, fn, *args, what: str):
    """A check that crashes (an unreadable h5, a missing package, a
    permission error) is itself a blocker with the exception as the
    message — never a traceback."""
    try:
        return fn(rep, *args)
    except Exception as e:
        rep.blocker(f"{what} crashed: {type(e).__name__}: {str(e)[:120]}")
        return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-data", required=True)
    ap.add_argument("-split", default="stanford", choices=["stanford"])
    ap.add_argument("--dryrun-images", type=int, default=50)
    ap.add_argument("--skip-dryrun", action="store_true")
    ap.add_argument("--probe-egress", action="store_true",
                    help="contact the dataset host's API (an outside "
                         "host) to see whether a download would work")
    ap.add_argument("--download", action="store_true",
                    help="with --probe-egress: fetch VG.tar when egress "
                         "works")
    ap.add_argument("-device", "--device", default="cuda")
    args = ap.parse_args(argv)
    rep = Report()
    image_data = _guarded(rep, check_vg_tree, args.data, what="tree check")
    _guarded(rep, check_images, args.data, image_data, args.dryrun_images,
             what="image decode check")
    _guarded(rep, check_disk, args.data, what="disk check")
    if args.skip_dryrun:
        print("[4/5] dry-run skipped (--skip-dryrun)")
    elif image_data is not None:
        dryrun(rep, args.data, args.dryrun_images, args.device)
    else:
        print("[4/5] dry-run skipped (tree check failed)")
    if args.probe_egress:
        _guarded(rep, check_egress, args.data, args.download,
                 what="egress probe")
    else:
        print("[5/5] egress probe skipped (--probe-egress contacts the "
              "dataset host)")
        rep.info["egress"] = "not probed"

    print()
    print(json.dumps(rep.info))
    if rep.blockers:
        print(f"BLOCKED ({len(rep.blockers)}):")
        for b in rep.blockers:
            print(f"  - {b}")
        return 1
    print("READY")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
