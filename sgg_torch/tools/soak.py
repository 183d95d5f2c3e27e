"""Soak at the training shape: the whole ``Trainer.fit`` over a
VG-statistics synthetic set, several epochs, test evaluation, checkpoints
and the non-finite-loss guard, end to end.

    python -m sgg_torch.tools.soak [N_IMAGES=480] [EPOCHS=6] [CACHE_DIR]
        [--img 592] [-device cpu --tiny]

Counterpart of ``tools/soak_tpu.py``: predcls, dnorm, frequency bias,
batch 24, 40 nodes, 256 edges, bf16, lr 3e-3, 151 classes and 51
predicates on 592 px blank canvases; test on 48 images with the train
split's statistics. A third argument turns on the frozen-trunk feature
cache (``data/feature_cache.py``): epoch 0 pays one extraction pass, then
every epoch trains and evaluates from the cache. The cache is an HDF5
file: without ``h5py`` (the card's machine has none) the tool raises an
``ImportError`` naming it before any work on the card. Checkpoints go to
a temporary directory. The last line is one JSON object: the run's wall
seconds, train images/s including eval and checkpoints, the test
recalls, the kernels' launches and the device.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

from sgg_torch.config import Config
from sgg_torch.device import resolve_device
from sgg_torch.main import require
from sgg_torch.tools import _common
from sgg_torch.tools.e2e_throughput import synthetic_split
from sgg_torch.train.trainer import Trainer, build_model
from sgg_torch.utils.profiling import StageProfiler

BATCH = 24


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_images", nargs="?", type=int, default=480)
    ap.add_argument("epochs", nargs="?", type=int, default=6)
    ap.add_argument("cache_dir", nargs="?", default=None)
    ap.add_argument("--img", type=int, default=592)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--tiny", action="store_true",
                    help="narrow heads, for the CPU tests")
    ap.add_argument("-device", "--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cache_dir is not None:
        require("the feature cache", ["h5py"])
    dev = resolve_device(args.device)
    img, B = args.img, args.batch
    splits = {"train": synthetic_split(args.n_images, img, 0, "train"),
              "val_alls": synthetic_split(48, img, 1, "val"),
              "test_alls": synthetic_split(48, img, 0, "test"),
              "val_zs": synthetic_split(24, img, 3, "val"),
              "test_zs": synthetic_split(24, img, 4, "test")}
    prof = StageProfiler("soak", dev, batch=args.n_images)
    with tempfile.TemporaryDirectory(prefix="sgg_soak_") as save_dir, \
            _common.im_scale(img):
        config = Config(batch_size=B, max_nodes=40, max_edges=256,
                        mode="predcls", loss="dnorm", use_bias=True,
                        num_epochs=args.epochs, print_interval=5,
                        val_size=0, compute_dtype="bfloat16",
                        save_dir=save_dir, lr=3e-3,
                        feature_cache=args.cache_dir, device=args.device)
        def fit():
            model = build_model(config, splits["train"], device=dev,
                                widths=_common.widths(args))
            trainer = Trainer(config, splits, model=model, with_images=False)
            return trainer.fit(test_names=("test_alls",))

        results = prof.once("fit", fit)
    dt = prof.stages["fit"]["wall_ms"] / 1e3
    n_steps = (args.n_images // B) * args.epochs
    rate = B * n_steps / dt
    print(f"SOAK: {args.epochs} epochs x {args.n_images} images in "
          f"{dt:.0f} s ({rate:.1f} images/s incl eval+ckpt)", flush=True)
    recalls = {k: v for k, v in sorted(results.items())
               if "R@100" in k or k.startswith("avg/")}
    for k, v in recalls.items():
        print(f"  {k}: {v:.4f}", flush=True)
    return prof.line(sizes=vars(args), train_images_per_s=rate,
                     results=recalls)


if __name__ == "__main__":
    main()
