"""Host input pipeline: canvas → normalize → pad → pack → prefetch.

Counterpart of ``sgg_tpu/data/pipeline.py`` (reference
``dataloaders/visual_genome.py:377-455,691-739``): SquarePad to IM_SCALE,
box scaling/clipping/flip, duplicate relation sampling, and fixed-shape
padded batch packing. Two canvas formats, as in the JAX package:
``float32`` (normalized on the host, zero padding) and ``uint8`` (raw
bytes padded with the ImageNet mean rounded to uint8, normalized on the
device by the trunk: a quarter of the bytes to copy). Batches are
assembled by worker threads and queued; ``device_prefetch`` keeps the next
batches' copies to the device in flight while a step runs.

The port's datasets so far are file-less (synthetic): their "image" is a
constant canvas, and a resize of a constant is that constant, so no image
library is needed. Decoding image files raises ``NotImplementedError``; it
comes with the dataset parsers (ROADMAP Queue A).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from sgg_torch.constants import BOX_SCALE, IM_SCALE
from sgg_torch.data.datasets import SGGDataset, filter_duplicate_rels
from sgg_torch.data.graph_batch import GraphBatch, pack_ragged

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_NO_DECODE = ("decoding image files is not ported yet (it comes with the "
              "dataset parsers); use a file-less dataset")


def content_size(orig_h: int, orig_w: int, im_scale: int = IM_SCALE):
    """(content_h, content_w, scale) of the resized image inside the padded
    square canvas (visual_genome.py:377-455 resize semantics)."""
    s = im_scale / max(orig_h, orig_w)
    ch, cw = int(round(orig_h * s)), int(round(orig_w * s))
    return min(ch, im_scale), min(cw, im_scale), s


def prepare_boxes(boxes: np.ndarray, rels: np.ndarray, box_coordinates: str,
                  is_train: bool, rng: np.random.RandomState,
                  ch: int, cw: int, s: float, im_scale: int = IM_SCALE,
                  filter_duplicates: bool = True):
    """Box scale/clip/flip + duplicate-rel sampling. RNG call order matches
    the JAX package: flip draw first, then duplicate filtering."""
    boxes = boxes.astype(np.float32).copy()
    if box_coordinates == "box_scale":
        boxes *= im_scale / BOX_SCALE
    else:
        boxes *= s
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)

    flipped = is_train and rng.rand() > 0.5
    if flipped:
        x1 = cw - boxes[:, 2].copy()
        x2 = cw - boxes[:, 0].copy()
        boxes[:, 0], boxes[:, 2] = x1, x2

    if is_train and filter_duplicates and len(rels):
        rels = filter_duplicate_rels(rels, rng)
    return boxes, rels, flipped


def _resized_constant(image: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """The (ch, cw, 3) float32 [0, 1] resize of a constant image, through
    the same uint8 round trip as the JAX package's PIL path."""
    c = image.reshape(-1)[0]
    if not np.all(image == c):
        raise NotImplementedError(_NO_DECODE)
    u8 = (np.uint8(c) if image.dtype == np.uint8
          else np.asarray(image.reshape(-1)[:1] * 255).astype(np.uint8)[0])
    return np.full((ch, cw, 3), u8, np.float32) / 255.0


def prepare_example(image: np.ndarray, boxes: np.ndarray, rels: np.ndarray,
                    box_coordinates: str, is_train: bool,
                    rng: np.random.RandomState, im_scale: int = IM_SCALE,
                    filter_duplicates: bool = True, uint8: bool = False):
    """One example: resize+normalize+pad image, scale+clip+flip boxes.

    Returns (padded image (S, S, 3), boxes in padded-frame pixels, rels,
    (content_h, content_w)). The canvas is float32, normalized, padded
    with 0.0; with ``uint8=True`` it is raw uint8, padded with the ImageNet
    mean rounded to uint8, and normalized on the device
    (``sgg_tpu/data/pipeline.py:prepare_example``). Only constant images
    are taken (see the module docstring).
    """
    h, w = image.shape[:2]
    ch, cw, s = content_size(h, w, im_scale)
    boxes, rels, flipped = prepare_boxes(
        boxes, rels, box_coordinates, is_train, rng, ch, cw, s,
        im_scale=im_scale, filter_duplicates=filter_duplicates)
    img = _resized_constant(image, ch, cw)  # a flip leaves it unchanged
    if uint8:
        canvas = np.empty((im_scale, im_scale, 3), np.uint8)
        canvas[:] = (IMAGENET_MEAN * 255).astype(np.uint8)
        canvas[:ch, :cw] = np.round(img * 255).astype(np.uint8)
    else:
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        canvas = np.zeros((im_scale, im_scale, 3), np.float32)
        canvas[:ch, :cw] = img
    return canvas, boxes, rels, (ch, cw)


_COPY_STREAMS: dict = {}


def device_prefetch(iterator: Iterable[GraphBatch], device,
                    size: int = 2) -> Iterator[GraphBatch]:
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
    content are the iterator's."""
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
            for f in dataclasses.fields(batch):
                t = getattr(batch, f.name)
                if isinstance(t, torch.Tensor):
                    t.record_stream(consumer)
        return batch

    for item in iterator:
        if cuda:
            with torch.cuda.stream(stream):
                moved = item.to(device)
                done = stream.record_event()
        else:
            moved, done = item.to(device), None
        buf.append((moved, done))
        if len(buf) > size:
            yield release()
    while buf:
        yield release()


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
                 image_format: str = "float32"):
        """``image_format``: ``float32`` canvases normalized on the host,
        or ``uint8`` canvases normalized on the device (4x fewer bytes to
        copy)."""
        if image_format not in ("float32", "uint8"):
            raise ValueError(f"image_format {image_format!r}: float32 or "
                             f"uint8")
        self.image_format = image_format
        self.ds = dataset
        self.batch_size = batch_size
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        # train loader shuffles and drops last (visual_genome.py:720-739)
        self.shuffle = dataset.is_train if shuffle is None else shuffle
        self.drop_last = dataset.is_train if drop_last is None else drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.with_images = with_images
        self.im_scale = im_scale
        self._epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _make_example(self, idx: int, rng: np.random.RandomState):
        if self.with_images and self.ds.filenames:
            raise NotImplementedError(_NO_DECODE)
        # file-less operation: a blank canvas with the boxes' extent
        ext = max(float(self.ds.gt_boxes[idx].max()), 1.0)
        img = np.zeros((int(ext), int(ext), 3), np.float32)
        scale_org = max(img.shape[:2]) / self.im_scale
        return prepare_example(
            img, self.ds.gt_boxes[idx], self.ds.relationships[idx],
            self.ds.box_coordinates, self.ds.is_train, rng,
            im_scale=self.im_scale,
            filter_duplicates=self.ds.filter_duplicates,
            uint8=self.image_format == "uint8") + (scale_org,)

    def _example_rng(self, epoch: int, idx: int) -> np.random.RandomState:
        """Per-example RNG keyed on (seed, epoch, image index)."""
        ss = np.random.SeedSequence([self.seed, epoch, idx])
        return np.random.RandomState(ss.generate_state(4))

    def _assemble(self, indices, epoch) -> GraphBatch:
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            examples = list(pool.map(
                lambda i: self._make_example(i, self._example_rng(epoch, i)),
                indices))
        return pack_ragged(
            [e[1] for e in examples],
            [self.ds.gt_classes[i] for i in indices],
            [e[2] for e in examples],
            max_nodes=self.max_nodes, max_edges=self.max_edges,
            images=np.stack([e[0] for e in examples]),
            im_hw=np.asarray([e[3] for e in examples], np.float32),
            im_scale_org=np.asarray([e[4] for e in examples], np.float32))

    def __iter__(self) -> Iterator[GraphBatch]:
        order = np.arange(len(self.ds))
        epoch = self._epoch
        rng = np.random.RandomState(self.seed + epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)
        n = len(self.ds)
        ends = range(self.batch_size, n + 1, self.batch_size) \
            if self.drop_last else range(self.batch_size,
                                         n + self.batch_size,
                                         self.batch_size)
        chunks = [order[max(0, e - self.batch_size):min(e, n)] for e in ends]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # a producer failure must surface in the consumer, not silently
            # end the epoch
            try:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    q.put(self._assemble(chunk, epoch))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
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
