"""Frozen-trunk feature cache: extract once, train the heads many times.

Counterpart of ``sgg_tpu/data/feature_cache.py``. In predcls/sgcls (and in
sgdet, where the trunk is the frozen detector's) the trunk is frozen, yet
each epoch would run it again on every image. This module stores the
trunk's output once per image, for both horizontal-flip orientations of a
training split (``trunk(flip(x)) != flip(trunk(x))`` for a conv net), and
the input pipeline then streams feature maps instead of images.

Storage, the JAX package's own layout (a file written by either package
reads in the other): one HDF5 file a split; ``fmaps`` (num_images,
n_orient, h, w, C) bfloat16 stored as its uint16 bits (h5py has no
bfloat16), ``orig_hw`` (num_images, 2) int32, ``done`` (num_images,)
uint8; attributes ``version``, ``im_scale``, ``stride``, ``n_orient`` and
``fingerprint``, a hash of the trunk's weights and BatchNorm statistics
that refuses a cache extracted with other weights. With bfloat16 compute
the cached step sees the trunk output bit for bit; with float32 compute
the cache rounds it to bfloat16.

``h5py`` is imported where a file is opened: the module imports on a
machine without it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from sgg_torch.constants import IM_SCALE

_VERSION = 1


def params_fingerprint(state: Mapping[str, torch.Tensor]) -> str:
    """A stable hash of a trunk's ``state_dict`` (weights and BatchNorm
    statistics, in name order, as float32 bytes): a cache extracted with
    other weights is refused, a stale cache being worse than none."""
    h = hashlib.sha1()
    for name in sorted(state):
        t = state[name]
        if not t.is_floating_point():
            continue  # num_batches_tracked shapes nothing
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.detach().to("cpu", torch.float32).contiguous()
                 .numpy().tobytes())
    return h.hexdigest()


def _to_bits(fmaps: torch.Tensor) -> np.ndarray:
    return (torch.as_tensor(fmaps).to("cpu", torch.bfloat16).contiguous()
            .view(torch.int16).numpy().view(np.uint16))


def _from_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


class FeatureCache:
    """HDF5-backed trunk feature cache of one split. Reads and writes hold
    one lock around the file (the loader's worker threads read at once)."""

    def __init__(self, path: str, mode: str = "r"):
        import h5py
        self.path = path
        self._f = h5py.File(path, mode)
        self._lock = threading.Lock()
        attrs = self._f.attrs
        if attrs.get("version") != _VERSION:
            version = attrs.get("version")
            self._f.close()
            raise ValueError(f"feature cache {path} has version {version}, "
                             f"not {_VERSION}: extract it again")
        self.im_scale = int(attrs["im_scale"])
        self.stride = int(attrs["stride"])
        self.n_orient = int(attrs["n_orient"])
        self.fingerprint = str(attrs.get("fingerprint", ""))

    @classmethod
    def create(cls, path: str, num_images: int, fmap_hw, channels: int, *,
               im_scale: int = IM_SCALE, stride: int = 16,
               n_orient: int = 2, fingerprint: str = "") -> "FeatureCache":
        import h5py
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        h, w = fmap_hw
        with h5py.File(path, "w") as f:
            f.attrs["version"] = _VERSION
            f.attrs["im_scale"] = im_scale
            f.attrs["stride"] = stride
            f.attrs["n_orient"] = n_orient
            f.attrs["fingerprint"] = fingerprint
            f.create_dataset("fmaps",
                             shape=(num_images, n_orient, h, w, channels),
                             dtype=np.uint16,
                             chunks=(1, 1, h, w, channels))
            f.create_dataset("orig_hw", shape=(num_images, 2),
                             dtype=np.int32)
            f.create_dataset("done", shape=(num_images,), dtype=np.uint8)
        return cls(path, "r+")

    @property
    def num_images(self) -> int:
        return self._f["fmaps"].shape[0]

    @property
    def fmap_hw(self):
        s = self._f["fmaps"].shape
        return (s[2], s[3])

    @property
    def channels(self) -> int:
        return self._f["fmaps"].shape[4]

    def complete(self) -> bool:
        with self._lock:
            return bool(np.all(self._f["done"][:] == 1))

    def write(self, idx: int, fmaps: torch.Tensor, orig_hw) -> None:
        """Store every orientation of one image: ``fmaps`` (n_orient, h, w,
        C) of any float type, rounded to bfloat16; ``orig_hw`` the image's
        (height, width) before the resize."""
        bits = _to_bits(fmaps)
        if bits.shape != self._f["fmaps"].shape[1:]:
            raise ValueError(f"fmaps {bits.shape} for a cache of "
                             f"{self._f['fmaps'].shape[1:]}")
        with self._lock:
            self._f["fmaps"][idx] = bits
            self._f["orig_hw"][idx] = np.asarray(orig_hw, np.int32)
            self._f["done"][idx] = 1

    def _check(self, idx: int) -> None:
        if not self._f["done"][idx]:
            raise KeyError(f"feature cache {self.path} has no entry for "
                           f"image {idx}")

    def read(self, idx: int, flip: bool = False) -> torch.Tensor:
        """(h, w, C) bfloat16 map of one image and orientation."""
        o = int(flip)
        if o >= self.n_orient:
            raise ValueError(f"cache {self.path} stores {self.n_orient} "
                             f"orientation(s): no flipped map")
        with self._lock:
            self._check(idx)
            bits = self._f["fmaps"][idx, o]
        return _from_bits(bits)

    def orig_hw(self, idx: int):
        with self._lock:
            self._check(idx)
            hw = self._f["orig_hw"][idx]
        return int(hw[0]), int(hw[1])

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


def extract_trunk_cache(path: str, dataset,
                        trunk_fn: Callable[[np.ndarray], torch.Tensor], *,
                        batch_size: int = 8, im_scale: int = IM_SCALE,
                        stride: int = 16, image_format: str = "uint8",
                        fingerprint: str = "", with_images: bool = True,
                        progress: bool = True,
                        n_orient: Optional[int] = None) -> FeatureCache:
    """Run the frozen trunk over every image of ``dataset`` (both flips for
    a training split unless ``n_orient`` is 1) and store its maps.

    ``trunk_fn`` takes a host batch of canvases (B, S, S, 3) in
    ``image_format`` (uint8 canvases are normalized by the trunk) and
    returns the (B, h, w, C) maps, on the card unless the caller runs it
    on the CPU. The canvases come from the loader's own source and
    preparation (``load_source_image``, ``prepare_example`` with the flip
    pinned), so ``image_format`` and ``with_images`` must be the training
    run's for the cache to equal the trunk's output on its batches.
    """
    from sgg_torch.data.pipeline import load_source_image, prepare_example

    n = len(dataset)
    if n_orient is None:
        n_orient = 2 if getattr(dataset, "is_train", False) else 1
    if n_orient not in (1, 2):
        raise ValueError(f"n_orient {n_orient}: 1 or 2")
    rng = np.random.RandomState(0)  # never drawn: the flip is pinned

    def canvases(idx: int):
        img = load_source_image(dataset, idx, image_format,
                                with_images=with_images)
        outs = [prepare_example(
            img, dataset.gt_boxes[idx], np.zeros((0, 3), np.int32),
            dataset.box_coordinates, False, rng, im_scale=im_scale,
            filter_duplicates=False, uint8=image_format == "uint8",
            force_flip=bool(flip))[0] for flip in range(n_orient)]
        return np.stack(outs), img.shape[:2]

    cache: Optional[FeatureCache] = None
    for start in range(0, n, batch_size):
        idxs = list(range(start, min(start + batch_size, n)))
        per_img = [canvases(i) for i in idxs]
        stack = np.concatenate([c for c, _ in per_img], axis=0)
        fmaps = trunk_fn(stack).cpu()
        if cache is None:
            h, w, c = fmaps.shape[1:]
            cache = FeatureCache.create(
                path, n, (h, w), c, im_scale=im_scale, stride=stride,
                n_orient=n_orient, fingerprint=fingerprint)
        for j, i in enumerate(idxs):
            cache.write(i, fmaps[j * n_orient:(j + 1) * n_orient],
                        per_img[j][1])
        if progress and (start // batch_size) % 50 == 0:
            print(f"[feature_cache] {min(start + batch_size, n)}/{n} "
                  f"images -> {path}", flush=True)
    if cache is None:
        raise ValueError("empty dataset")
    cache.flush()
    return cache


def split_cache_path(cache_dir: str, split_name: str) -> str:
    """The cache file of one split inside the configured directory."""
    return os.path.join(cache_dir, f"trunk_{split_name}.h5")


@torch.inference_mode()
def cached_batch(trunk: torch.nn.Module, batch):
    """The batch the cache-backed loader would deliver, minus the disk
    trip: ``trunk`` (a ``VGG16Trunk``) run on the batch's images, whose
    device and type it takes, carried as ``fmaps`` with no images."""
    fmaps = trunk(batch.images)
    return dataclasses.replace(batch, images=None, fmaps=fmaps)
