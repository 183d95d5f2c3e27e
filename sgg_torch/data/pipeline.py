"""Host input pipeline: decode → resize → normalize → pad → pack → prefetch.

Counterpart of ``sgg_tpu/data/pipeline.py`` (reference
``dataloaders/visual_genome.py:377-455,691-739``): per-image PIL decode,
SquarePad to IM_SCALE after a bilinear resize, box scaling/clipping/flip,
duplicate relation sampling, and fixed-shape padded batch packing. Two
canvas formats, as in the JAX package: ``float32`` (normalized on the
host, zero padding) and ``uint8`` (raw bytes padded with the ImageNet mean
rounded to uint8, normalized on the device by the trunk: a quarter of the
bytes to copy). With a frozen-trunk feature cache (``data/feature_cache.py``)
the batches carry the stored trunk maps instead of canvases. Batches are
assembled by worker threads and queued; ``device_prefetch`` keeps the next
batches' copies to the device in flight while a step runs.

On the uint8 route a uint8 image (a decoded file) goes through the native
one-pass prep, ``sgg_torch.native.prepare_image_u8`` (triangle resize,
flip and mean padding in C++, as the JAX package's
``sgg_tpu/native/image_prep.cpp``, with the same bytes); there is no PIL
fall-back. The float32 route, and a float image on the uint8 route (the
blank canvas of a file-less dataset), resize with PIL as the JAX package
does. PIL (and ``h5py``, for the cache) is imported where a file is
decoded or read. File-less datasets (``-split synthetic``) need neither:
their image is a blank canvas, whose resize is itself.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from sgg_torch import native
from sgg_torch.constants import BOX_SCALE, IM_SCALE
from sgg_torch.data.datasets import SGGDataset, filter_duplicate_rels
from sgg_torch.data.graph_batch import GraphBatch, pack_ragged
from sgg_torch.utils import counters

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def load_image(path: str) -> np.ndarray:
    """Decode an image file to float32 RGB in [0, 1]."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def load_image_u8(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGB."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def content_size(orig_h: int, orig_w: int, im_scale: int = IM_SCALE):
    """(content_h, content_w, scale) of the resized image inside the padded
    square canvas (visual_genome.py:377-455 resize semantics)."""
    s = im_scale / max(orig_h, orig_w)
    ch, cw = int(round(orig_h * s)), int(round(orig_w * s))
    return min(ch, im_scale), min(cw, im_scale), s


def prepare_boxes(boxes: np.ndarray, rels: np.ndarray, box_coordinates: str,
                  is_train: bool, rng: np.random.RandomState,
                  ch: int, cw: int, s: float, im_scale: int = IM_SCALE,
                  filter_duplicates: bool = True,
                  force_flip: Optional[bool] = None):
    """Box scale/clip/flip + duplicate-rel sampling (the non-image half of
    ``prepare_example``, shared with the feature-cache path). RNG call
    order matches the JAX package: flip draw first, then duplicate
    filtering. ``force_flip`` pins the flip; None draws it in training."""
    boxes = boxes.astype(np.float32).copy()
    if box_coordinates == "box_scale":
        boxes *= im_scale / BOX_SCALE
    else:
        boxes *= s
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)

    flipped = (is_train and rng.rand() > 0.5) if force_flip is None \
        else bool(force_flip)
    if flipped:
        x1 = cw - boxes[:, 2].copy()
        x2 = cw - boxes[:, 0].copy()
        boxes[:, 0], boxes[:, 2] = x1, x2

    if is_train and filter_duplicates and len(rels):
        rels = filter_duplicate_rels(rels, rng)
    return boxes, rels, flipped


def _resized(image: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """The (ch, cw, 3) float32 [0, 1] bilinear resize of an image through
    uint8, as the JAX package's PIL path (``Image.BILINEAR``, which
    antialiases when it shrinks). A blank image resizes to zeros without
    PIL."""
    if not image.any():
        return np.zeros((ch, cw, 3), np.float32)
    from PIL import Image
    u8 = image if image.dtype == np.uint8 else (image * 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(u8).resize((cw, ch), Image.BILINEAR),
                     np.float32)
    return img / 255.0


def prepare_example(image: np.ndarray, boxes: np.ndarray, rels: np.ndarray,
                    box_coordinates: str, is_train: bool,
                    rng: np.random.RandomState, im_scale: int = IM_SCALE,
                    filter_duplicates: bool = True, uint8: bool = False,
                    force_flip: Optional[bool] = None):
    """One example: resize+normalize+pad image, scale+clip+flip boxes.

    Returns (padded image (S, S, 3), boxes in padded-frame pixels, rels,
    (content_h, content_w)). The canvas is float32, normalized, padded
    with 0.0; with ``uint8=True`` it is raw uint8, padded with the ImageNet
    mean rounded to uint8, and normalized on the device
    (``sgg_tpu/data/pipeline.py:prepare_example``): a uint8 image takes
    the native one-pass prep, any other PIL's resize. ``force_flip`` pins
    the horizontal flip (the feature cache renders both orientations).
    """
    h, w = image.shape[:2]
    ch, cw, s = content_size(h, w, im_scale)
    boxes, rels, flipped = prepare_boxes(
        boxes, rels, box_coordinates, is_train, rng, ch, cw, s,
        im_scale=im_scale, filter_duplicates=filter_duplicates,
        force_flip=force_flip)
    mean_u8 = (IMAGENET_MEAN * 255).astype(np.uint8)
    if uint8 and image.dtype == np.uint8:
        canvas = native.prepare_image_u8(image, im_scale, ch, cw, flipped,
                                         mean_u8)
        return canvas, boxes, rels, (ch, cw)
    img = _resized(image, ch, cw)
    if flipped:
        img = img[:, ::-1]
    if uint8:
        canvas = np.empty((im_scale, im_scale, 3), np.uint8)
        canvas[:] = mean_u8
        canvas[:ch, :cw] = np.round(img * 255).astype(np.uint8)
    else:
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        canvas = np.zeros((im_scale, im_scale, 3), np.float32)
        canvas[:ch, :cw] = img
    return canvas, boxes, rels, (ch, cw)


def load_source_image(dataset, idx: int, image_format: str,
                      with_images: bool = True) -> np.ndarray:
    """The raw image of a dataset example: the decoded file when the
    dataset has filenames (and the run wants images), else a blank canvas
    spanning the boxes' extent (file-less datasets, ``with_images=False``).
    Shared by ``BatchLoader`` and the feature-cache extractor, so both see
    the same pixels."""
    if with_images and dataset.filenames:
        path = os.path.join(dataset.images_dir, dataset.filenames[idx])
        with counters.span("image.decode"):
            return (load_image_u8(path) if image_format == "uint8"
                    else load_image(path))
    ext = max(float(dataset.gt_boxes[idx].max()), 1.0)
    return np.zeros((int(ext), int(ext), 3), np.float32)


_COPY_STREAMS: dict = {}


def device_prefetch(iterator: Iterable[GraphBatch], device,
                    size: int = 2, epoch: Optional[int] = None
                    ) -> Iterator[GraphBatch]:
    """Overlap the copy to the device with compute: the next ``size``
    batches are moved with ``GraphBatch.to`` (pinned, ``non_blocking``)
    before the current one is yielded (``sgg_tpu/data/pipeline.py:
    device_prefetch``). On a CUDA device the copies are issued on a stream
    of their own, so they run while the current step's kernels do; the
    consumer's stream waits for a batch's copies only when it is yielded,
    and its tensors are marked as used there (``record_stream``) so their
    memory is not reused under a running step. One copy stream a device
    serves every call: the caching allocator keeps a stream's blocks for
    that stream, so a new stream each epoch would allocate anew. Order and
    content are the iterator's. An item is a ``GraphBatch`` or another
    dataclass with a ``to(device)``; its tensors, nested dataclasses'
    included, are marked as used. Taking each item from ``iterator`` and
    issuing its copies is a ``batch.copy`` span, whose batch is ``(epoch,
    the item's position)`` when ``epoch`` is given."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device not in _COPY_STREAMS:
        _COPY_STREAMS[device] = torch.cuda.Stream(device)
    stream = _COPY_STREAMS.get(device)
    buf: collections.deque = collections.deque()

    def release():
        batch, done = buf.popleft()
        if cuda:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in _tensors(batch):
                t.record_stream(consumer)
        return batch

    source = iter(iterator)
    for index in itertools.count():
        with counters.span("batch.copy", batch=None if epoch is None
                           else (epoch, index)) as copy:
            item = next(source, None)
            if item is None:
                copy.batch = None  # the end of the source: no batch
            elif cuda:
                with torch.cuda.stream(stream):
                    moved = item.to(device)
                    done = stream.record_event()
            else:
                moved, done = item.to(device), None
        if item is None:
            break
        buf.append((moved, done))
        if len(buf) > size:
            yield release()
    while buf:
        yield release()


def _tensors(item):
    """The tensors of a dataclass, nested dataclasses included."""
    for f in dataclasses.fields(item):
        v = getattr(item, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v)


def to_image_dtype(batch: GraphBatch, dtype: str) -> GraphBatch:
    """A host batch's images for the copy to the device: float canvases in
    bfloat16 when
    the model computes in it (half the bytes; the trunk casts to its
    compute type anyway), uint8 and float32 as they are
    (``sgg_tpu/data/pipeline.py:to_image_dtype``)."""
    if batch.images is None or dtype == "float32" or \
            batch.images.dtype == np.uint8:
        return batch
    images = torch.from_numpy(batch.images).to(torch.bfloat16)
    return dataclasses.replace(batch, images=images)


class BatchLoader:
    """Iterable over padded host GraphBatches with threaded assembly."""

    def __init__(self, dataset: SGGDataset, batch_size: int, max_nodes: int,
                 max_edges: int, shuffle: Optional[bool] = None,
                 drop_last: Optional[bool] = None, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0,
                 with_images: bool = True, im_scale: int = IM_SCALE,
                 image_format: str = "float32", feature_cache=None,
                 cache_orientations: Optional[int] = None,
                 shard: Optional[Tuple[int, int]] = None, buckets=None):
        """``image_format``: ``float32`` canvases normalized on the host,
        or ``uint8`` canvases normalized on the device (4x fewer bytes to
        copy).

        ``buckets``: ascending ``(max_nodes, max_edges)`` shape buckets
        (``sgg_tpu``'s). Each image goes to the smallest bucket whose node
        capacity holds it (the last one otherwise), in stream order, and
        a bucket yields a batch when it holds ``batch_size`` images (its
        remainders at the end unless ``drop_last``), padded to the
        bucket's shape: small graphs stop paying the global padding.
        None: one ``(max_nodes, max_edges)`` shape.

        ``feature_cache``: a complete ``FeatureCache`` (or its path) of
        this dataset at ``im_scale``; batches then carry its trunk maps as
        ``fmaps`` and no images. ``cache_orientations`` is the run's
        setting: 1 pins the flip off in training even when the file stores
        both orientations; None defers to the file.

        ``shard``: ``(rank, world)`` of a data-parallel run
        (``sgg_torch.parallel``): every rank computes the same shuffled
        order (same seed and epoch) and loads only its contiguous
        ``batch_size / world`` rows of each batch; the flips stay keyed on
        (seed, epoch, image index), so the ranks' rows together are the
        one-process batch. A tail batch that the ranks do not divide is
        padded by repeating its images (``sgg_tpu``'s rule). With
        ``buckets`` every rank computes the same bucket sequence from the
        same order and takes its rows of each bucket's batch."""
        if image_format not in ("float32", "uint8"):
            raise ValueError(f"image_format {image_format!r}: float32 or "
                             f"uint8")
        self.image_format = image_format
        self.ds = dataset
        self.batch_size = batch_size
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.buckets = sorted(buckets) if buckets else None
        # train loader shuffles and drops last (visual_genome.py:720-739)
        self.shuffle = dataset.is_train if shuffle is None else shuffle
        self.drop_last = dataset.is_train if drop_last is None else drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.with_images = with_images
        self.im_scale = im_scale
        self.feature_cache = None
        if feature_cache is not None:
            from sgg_torch.data.feature_cache import FeatureCache
            cache = (feature_cache if isinstance(feature_cache, FeatureCache)
                     else FeatureCache(feature_cache))
            if cache.num_images != len(dataset):
                raise ValueError(f"feature cache {cache.path} holds "
                                 f"{cache.num_images} images, the dataset "
                                 f"{len(dataset)}")
            if cache.im_scale != im_scale:
                raise ValueError(f"feature cache {cache.path} was extracted "
                                 f"at {cache.im_scale} px, not {im_scale}")
            if not cache.complete():
                raise ValueError(f"feature cache {cache.path} is "
                                 f"incomplete: extract it again")
            self.feature_cache = cache
        self.cache_orientations = cache_orientations
        if shard is not None:
            rank, world = shard
            if not 0 <= rank < world:
                raise ValueError(f"shard {shard}: rank outside the world")
            if batch_size % world:
                raise ValueError(f"batch_size {batch_size} is not divisible "
                                 f"by {world} ranks")
        self.shard = shard
        self._epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _make_example(self, idx: int, rng: np.random.RandomState):
        if self.feature_cache is not None:
            return self._make_example_cached(idx, rng)
        img = load_source_image(self.ds, idx, self.image_format,
                                with_images=self.with_images)
        # model frame -> original pixels (reference rel_model_base.py:237-240)
        scale_org = max(img.shape[:2]) / self.im_scale
        return prepare_example(
            img, self.ds.gt_boxes[idx], self.ds.relationships[idx],
            self.ds.box_coordinates, self.ds.is_train, rng,
            im_scale=self.im_scale,
            filter_duplicates=self.ds.filter_duplicates,
            uint8=self.image_format == "uint8") + (scale_org,)

    def _make_example_cached(self, idx: int, rng: np.random.RandomState):
        """The cached trunk map of the drawn orientation, with the boxes,
        relations and flip of ``_make_example``. With one orientation in
        use (the run's ``cache_orientations``, else the file's), training
        does not flip."""
        oh, ow = self.feature_cache.orig_hw(idx)
        ch, cw, s = content_size(oh, ow, self.im_scale)
        n_eff = min(self.feature_cache.n_orient,
                    self.cache_orientations or self.feature_cache.n_orient)
        force = False if (self.ds.is_train and n_eff == 1) else None
        boxes, rels, flipped = prepare_boxes(
            self.ds.gt_boxes[idx], self.ds.relationships[idx],
            self.ds.box_coordinates, self.ds.is_train, rng, ch, cw, s,
            im_scale=self.im_scale,
            filter_duplicates=self.ds.filter_duplicates, force_flip=force)
        fmap = self.feature_cache.read(idx, flipped)
        return fmap, boxes, rels, (ch, cw), max(oh, ow) / self.im_scale

    def _example_rng(self, epoch: int, idx: int) -> np.random.RandomState:
        """Per-example RNG keyed on (seed, epoch, image index)."""
        ss = np.random.SeedSequence([self.seed, epoch, idx])
        return np.random.RandomState(ss.generate_state(4))

    def _bucket_for(self, idx: int):
        n = len(self.ds.gt_classes[idx])
        for b in self.buckets:
            if n <= b[0]:
                return b
        return self.buckets[-1]

    def _bucketed_chunks(self, order):
        """``(bucket, indices)`` batches of ``batch_size`` images a bucket,
        in stream order; the remainders at the end unless ``drop_last``."""
        queues = {b: [] for b in self.buckets}
        for idx in order:
            b = self._bucket_for(idx)
            queues[b].append(idx)
            if len(queues[b]) == self.batch_size:
                yield b, np.asarray(queues[b])
                queues[b] = []
        if not self.drop_last:
            for b, q in queues.items():
                if q:
                    yield b, np.asarray(q)

    def _assemble(self, indices, epoch, shape=None,
                  index: Optional[int] = None) -> GraphBatch:
        """The padded batch of ``indices``, at ``shape`` (a bucket's
        ``(max_nodes, max_edges)``) or the loader's; a ``batch.assemble``
        span of batch ``(epoch, index)``, ``index`` its place in the
        epoch."""
        with counters.span("batch.assemble", batch=None if index is None
                           else (epoch, index)):
            max_nodes, max_edges = shape or (self.max_nodes,
                                             self.max_edges)
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                examples = list(pool.map(
                    lambda i: self._make_example(
                        i, self._example_rng(epoch, i)), indices))
            cached = self.feature_cache is not None
            batch = pack_ragged(
                [e[1] for e in examples],
                [self.ds.gt_classes[i] for i in indices],
                [e[2] for e in examples],
                max_nodes=max_nodes, max_edges=max_edges,
                images=None if cached else np.stack(
                    [e[0] for e in examples]),
                im_hw=np.asarray([e[3] for e in examples], np.float32),
                im_scale_org=np.asarray([e[4] for e in examples],
                                        np.float32))
            if cached:
                batch.fmaps = torch.stack([e[0] for e in examples])
            return batch

    def __iter__(self) -> Iterator[GraphBatch]:
        order = np.arange(len(self.ds))
        epoch = self._epoch
        rng = np.random.RandomState(self.seed + epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)
        n = len(self.ds)
        if self.buckets:
            chunks = list(self._bucketed_chunks(order))
        else:
            ends = range(self.batch_size, n + 1, self.batch_size) \
                if self.drop_last else range(self.batch_size,
                                             n + self.batch_size,
                                             self.batch_size)
            chunks = [(None, order[max(0, e - self.batch_size):min(e, n)])
                      for e in ends]
        if self.shard is not None:
            rank, world = self.shard
            chunks = [(b, np.resize(c, -(-len(c) // world) * world))
                      for b, c in chunks]
            chunks = [(b, c[rank * (len(c) // world):
                            (rank + 1) * (len(c) // world)])
                      for b, c in chunks]
        yield from background((self._assemble(chunk, epoch, bucket,
                                              index=k)
                               for k, (bucket, chunk) in enumerate(chunks)),
                              self.prefetch)


def background(iterable: Iterable, size: int = 2) -> Iterator:
    """The items of ``iterable``, in order, computed up to ``size`` ahead in
    a thread of its own (work that releases the interpreter lock, such as
    numpy copies and pinning, then overlaps the consumer's). A failure in
    the thread is raised in the consumer; closing the consumer stops the
    thread."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def producer():
        # a producer failure must surface in the consumer, not silently
        # end the epoch
        try:
            for item in iterable:
                if stop.is_set():
                    return
                q.put(item)
            q.put(done)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # unblock a producer waiting on a full queue, then reap it
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.1)
