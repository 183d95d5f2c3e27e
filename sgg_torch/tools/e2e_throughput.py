"""End-to-end ``Trainer`` throughput, the input pipeline included.

    python -m sgg_torch.tools.e2e_throughput [--batch 24 --nodes 40
        --edges 256 --img 592] [--steps 6] [-device cpu --tiny]

Counterpart of ``tools/e2e_throughput.py``: unlike a step on a batch
already on the card, this drives the whole path (host canvases, uint8
packing, the prefetched copy to the card, the train step) through
``Trainer.train_epoch`` at sgcls/dnorm on ``--batch`` x ``--steps``
synthetic images (VG-Stanford's vocabulary, blank canvases). Epoch 0 is
the warm-up: the kernels' first launches (they load their libraries),
cuDNN's and cuBLAS's set-up; there is no compile cache to warm. Epoch 1's
train images/s, host included, is the result. The last line is one JSON
object: the epochs' wall ms, images/s, the kernels' launches in the run
(``utils/profiling.launch_counts``) and the device.
"""

from __future__ import annotations

from typing import Optional, Sequence

from sgg_torch.config import Config
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.device import resolve_device
from sgg_torch.tools import _common
from sgg_torch.train.trainer import Trainer, build_model
from sgg_torch.utils.profiling import StageProfiler


def synthetic_split(n: int, img: int, seed: int, mode: str) -> SGGDataset:
    """A file-less split of ``n`` synthetic images (VG-Stanford's
    vocabulary) in image pixels."""
    syn = SyntheticSGGDataset(num_images=n, num_classes=_common.NUM_CLASSES,
                              num_predicates=_common.NUM_PREDICATES,
                              max_objects=20, image_size=img, seed=seed)
    return SGGDataset(name="stanford", mode=mode, filenames=[],
                      images_dir="", gt_boxes=syn.gt_boxes,
                      gt_classes=syn.gt_classes,
                      relationships=syn.relationships,
                      ind_to_classes=syn.ind_to_classes,
                      ind_to_predicates=syn.ind_to_predicates,
                      box_coordinates="native")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = _common.parser(__doc__, 24, 40, 256, 592)
    ap.add_argument("--steps", type=int, default=6,
                    help="train steps an epoch")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B, n_img = args.batch, args.batch * args.steps
    ds = synthetic_split(n_img, args.img, 0, "train")
    config = Config(batch_size=B, max_nodes=args.nodes, max_edges=args.edges,
                    mode="sgcls", loss="dnorm", val_size=0, notest=True,
                    print_interval=100, num_epochs=1,
                    compute_dtype="bfloat16", device=args.device)
    prof = StageProfiler("e2e_throughput", dev, batch=n_img)
    with _common.im_scale(args.img):
        model = build_model(config, ds, device=dev,
                            widths=_common.widths(args))
        trainer = Trainer(config, {"train": ds}, model=model,
                          with_images=False)
        prof.once("epoch 0 (warm-up)", lambda: trainer.train_epoch(0))
        prof.once("epoch 1", lambda: trainer.train_epoch(1))
    wall = prof.stages["epoch 1"]["wall_ms"]
    rate = n_img / (wall / 1e3)
    print(f"epoch 1: {wall / 1e3:.2f} s for {args.steps} steps -> "
          f"{rate:.1f} train images/s end to end (host included)",
          flush=True)
    return prof.line(sizes=vars(args), train_images_per_s=rate,
                     steps=args.steps)


if __name__ == "__main__":
    main()
