"""Image transforms (host side, numpy/PIL).

The port's copy of ``sgg_tpu/data/transforms.py``, a rebuild of ``dataloaders/image_transforms.py`` and the
paired-target transforms of ``detector/transforms.py``: SquarePad with
ImageNet-mean fill, random crop with box adjustment, color augmentations
(brightness/contrast/hue/saturation), and RandomOrder composition. The live
training path uses SquarePad+resize+flip (wired in
``sgg_torch.data.pipeline.prepare_example``); the rest are available for
augmentation experiments exactly as in the reference (where they are
likewise defined but unused, image_transforms.py:16-132).
"""

from __future__ import annotations

import random
from typing import Callable, Sequence, Tuple

import numpy as np

IMAGENET_MEAN_255 = (int(0.485 * 256), int(0.456 * 256), int(0.406 * 256))


def square_pad(image: "np.ndarray") -> np.ndarray:
    """Pad an HxWx3 float [0,1] image to a square with the ImageNet mean
    (reference SquarePad, image_transforms.py:8-13)."""
    h, w = image.shape[:2]
    s = max(h, w)
    out = np.empty((s, s, 3), image.dtype)
    out[:] = np.asarray(IMAGENET_MEAN_255, image.dtype) / 255.0
    out[:h, :w] = image
    return out


def random_crop(image: np.ndarray, boxes: np.ndarray, round_boxes: bool = True,
                max_crop_fraction: float = 0.1,
                rng: random.Random = random):
    """Random crop that keeps all boxes inside (reference ``random_crop``,
    image_transforms.py:16-68): crop at most ``max_crop_fraction`` per side,
    bounded by the extremal box coordinates."""
    h, w = image.shape[:2]
    max_crop_w = int(w * max_crop_fraction)
    max_crop_h = int(h * max_crop_fraction)
    boxes = boxes.astype(np.float32).copy()
    x1_min = int(min(boxes[:, 0].min(), max_crop_w)) if len(boxes) else \
        max_crop_w
    y1_min = int(min(boxes[:, 1].min(), max_crop_h)) if len(boxes) else \
        max_crop_h
    x2_max = int(max(boxes[:, 2].max(), w - max_crop_w)) if len(boxes) \
        else w - max_crop_w
    y2_max = int(max(boxes[:, 3].max(), h - max_crop_h)) if len(boxes) \
        else h - max_crop_h
    x1 = rng.randint(0, max(x1_min, 0)) if x1_min > 0 else 0
    y1 = rng.randint(0, max(y1_min, 0)) if y1_min > 0 else 0
    x2 = rng.randint(min(x2_max, w - 1), w - 1) if x2_max < w - 1 else w - 1
    y2 = rng.randint(min(y2_max, h - 1), h - 1) if y2_max < h - 1 else h - 1
    cropped = image[y1:y2 + 1, x1:x2 + 1]
    boxes[:, 0::2] -= x1
    boxes[:, 1::2] -= y1
    if round_boxes:
        boxes = np.round(boxes)
    return cropped, boxes


def adjust_brightness(image: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(image * factor, 0, 1)


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    gray = image.mean()
    return np.clip(gray + factor * (image - gray), 0, 1)


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    gray = image.mean(axis=-1, keepdims=True)
    return np.clip(gray + factor * (image - gray), 0, 1)


def adjust_hue(image: np.ndarray, delta: float) -> np.ndarray:
    """Hue rotation via HSV round trip (delta in [-0.5, 0.5])."""
    import colorsys
    from PIL import Image
    img = Image.fromarray((image * 255).astype(np.uint8), "RGB")
    hsv = np.asarray(img.convert("HSV"), np.float32)
    hsv[..., 0] = (hsv[..., 0] + delta * 255.0) % 255.0
    out = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return np.asarray(out, np.float32) / 255.0


class RandomOrder:
    """Apply a list of transforms in random order
    (reference image_transforms.py:102-132)."""

    def __init__(self, transforms: Sequence[Callable], rng=None):
        self.transforms = list(transforms)
        self.rng = rng or random

    def __call__(self, image: np.ndarray) -> np.ndarray:
        order = list(range(len(self.transforms)))
        self.rng.shuffle(order)
        for i in order:
            image = self.transforms[i](image)
        return image


def color_jitter(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1,
                 rng=None) -> RandomOrder:
    """Torchvision-style ColorJitter composition."""
    r = rng or random
    return RandomOrder([
        lambda im: adjust_brightness(im, 1 + r.uniform(-brightness,
                                                       brightness)),
        lambda im: adjust_contrast(im, 1 + r.uniform(-contrast, contrast)),
        lambda im: adjust_saturation(im, 1 + r.uniform(-saturation,
                                                       saturation)),
        lambda im: adjust_hue(im, r.uniform(-hue, hue)),
    ], rng=r)


def hflip_with_boxes(image: np.ndarray,
                     boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Paired horizontal flip (reference detector/transforms.py:26-40)."""
    w = image.shape[1]
    out = image[:, ::-1].copy()
    boxes = boxes.copy()
    x1 = w - boxes[:, 2].copy()
    x2 = w - boxes[:, 0].copy()
    boxes[:, 0], boxes[:, 2] = x1, x2
    return out, boxes
