"""What the profilers share: their size arguments, seeded models at full
or tiny width, and a synthetic batch on the device."""

from __future__ import annotations

import argparse
import contextlib

import torch

from sgg_torch import constants
from sgg_torch.data.synthetic import SyntheticSGGDataset

NUM_CLASSES, NUM_PREDICATES = 151, 51  # VG-Stanford's vocabulary
# relation-model widths: the VGG16 model's, and the CPU tests' (--tiny)
FULL = {"obj_dim": 4096, "hidden_dim": 512}
TINY = {"obj_dim": 32, "hidden_dim": 16}


def parser(doc: str, batch: int, nodes: int, edges: int, img: int,
           iters: int = 10) -> argparse.ArgumentParser:
    """The profilers' arguments; the defaults are the JAX tool's sizes."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--nodes", type=int, default=nodes)
    ap.add_argument("--edges", type=int, default=edges)
    ap.add_argument("--img", type=int, default=img,
                    help="canvas side in pixels (the map is img // 16)")
    ap.add_argument("--iters", type=int, default=iters,
                    help="timed calls a stage, after 2 warm-up calls")
    ap.add_argument("--tiny", action="store_true",
                    help="narrow heads (obj_dim 32, hidden 16), for the "
                         "CPU tests; the VGG16 trunk keeps its widths")
    ap.add_argument("-device", "--device", default="cuda")
    return ap


def widths(args) -> dict:
    return TINY if args.tiny else FULL


@contextlib.contextmanager
def im_scale(img: int):
    """``constants.IM_SCALE`` (the loaders' canvas, the GAN's map) set to
    ``img`` for the block."""
    old = constants.IM_SCALE
    constants.IM_SCALE = img
    try:
        yield
    finally:
        constants.IM_SCALE = old


def synthetic_batch(args, device, with_images: bool = True, seed: int = 0):
    """A padded batch of ``args.batch`` synthetic images (VG-Stanford's
    vocabulary, 2-20 objects an image) on ``device``."""
    ds = SyntheticSGGDataset(num_images=args.batch, num_classes=NUM_CLASSES,
                             num_predicates=NUM_PREDICATES, max_objects=20,
                             image_size=args.img, with_images=with_images,
                             seed=seed)
    return ds.batch(list(range(args.batch)), max_nodes=args.nodes,
                    max_edges=args.edges).to(device)


def generator(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
