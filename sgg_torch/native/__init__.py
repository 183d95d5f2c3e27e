"""The port's native (C++) host library, built with ``g++`` and bound with
``ctypes``.

Counterpart of ``sgg_tpu/native/`` with its own copies of the three
sources (``image_prep.cpp``, ``collate.cpp``, ``rects.cpp``):

* ``prepare_image_u8``: a PIL-style triangle resize, flip and mean padding
  of a uint8 image into a uint8 canvas in one pass. The uint8 route of
  ``data/pipeline.py::prepare_example`` takes it for every uint8 image.
* ``pack_graph_batch``: packs a batch's ragged graphs into padded
  buffers; ``data/graph_batch.py::pack_ragged`` calls it for every batch.
* ``draw_union_rects_native``: the oracle for the card's rasterizer
  (``ops/rects.py``); no training or eval path calls it.

Each has a plain numpy version (``*_plain``) that the tests and
``chip_smoke.py`` hold the C++ against: the packer's and the rasterizer's
give the same values; the image prep's is within 1 per byte, since ``g++``
contracts the C++'s float multiply-adds into FMAs.

Nothing is built at import. The first call compiles the sources with the
JAX package's flags (``CXX_FLAGS``: the same compiler and flags give the
same floating-point arithmetic, so the canvases equal the JAX package's
byte for byte) into ``sgg_torch/build/``, listed in ``.gitignore``, under a
name hashed from the sources, the compiler, the flags and the host CPU
(``-march=native`` code runs only where it was built). A lock file
(``fcntl.flock``) serializes builds across processes, such as test
workers or ``torchrun`` ranks on one checkout, and the library is written
under a temporary name and renamed into place.

There is no fall-back: where the JAX package records a failed build and
its callers take PIL or numpy, a failed build here raises
``NativeBuildError`` with the compiler's command and output, and a
library that does not load raises ``OSError``.

A ``Library`` counts the calls into it by function name (``calls``;
``reset_counts`` zeroes them): ``chip_smoke.py`` reads the package
library's (``load()``) to show that a run's images and batches went
through it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "build"
SOURCES = ("rects.cpp", "collate.cpp", "image_prep.cpp")
CXX = "g++"
# the JAX package's Makefile: CXXFLAGS, then LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
BUILD_TIMEOUT_S = 300

_load_lock = threading.Lock()
_library: Optional["Library"] = None


class NativeBuildError(RuntimeError):
    """The compiler could not be run or failed; the message holds its
    command and output."""


def host_cpu() -> str:
    """The host CPU's model name with its vendor, family and model numbers
    (``/proc/cpuinfo``; a virtualized host may report the name as
    "unknown"), else the platform's processor string."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    if "model name" not in info:
        return platform.processor() or platform.machine()
    return (f"{info['model name']} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')})")


def library_path(build_dir: Path = None) -> Path:
    """The library's file: named after a hash of the sources, the
    compiler, its flags and the host CPU."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS, host_cpu())).encode())
    name = f"libsggnative-{h.hexdigest()[:12]}.so"
    return Path(build_dir or BUILD_DIR) / name


def build(build_dir: Path = None) -> Path:
    """Compile the library unless it exists; returns its path. Raises
    ``NativeBuildError`` with the command and the compiler's output."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # built by another process meanwhile
                return lib
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [CXX, *CXX_FLAGS, "-o", str(tmp),
                   *(str(SRC_DIR / s) for s in SOURCES)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=BUILD_TIMEOUT_S)
                code, log = proc.returncode, proc.stdout + proc.stderr
            except (OSError, subprocess.TimeoutExpired) as e:
                code, log = None, f"{type(e).__name__}: {e}"
            if code != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(
                    f"building {lib.name} failed (exit {code}): "
                    f"{' '.join(cmd)}\n{log}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


_F32, _I32, _I64, _U8 = (ctypes.POINTER(ctypes.c_float),
                         ctypes.POINTER(ctypes.c_int32),
                         ctypes.POINTER(ctypes.c_int64),
                         ctypes.POINTER(ctypes.c_uint8))
_i64 = ctypes.c_int64


class Library:
    """The three C functions of a built library, their calls counted in
    ``calls``. ``ctypes.CDLL`` releases the interpreter lock during each
    call, so loader threads prepare images in parallel."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        lib.draw_union_rects.restype = None
        lib.draw_union_rects.argtypes = [_F32, _i64, _i64, _F32]
        lib.prepare_image_u8.restype = None
        lib.prepare_image_u8.argtypes = [_U8, _i64, _i64, _U8, _i64, _i64,
                                         _i64, _i64, _U8]
        lib.pack_graph_batch.restype = ctypes.c_int64
        lib.pack_graph_batch.argtypes = [_F32, _I32, _I64, _I32, _I64, _i64,
                                         _i64, _i64, _F32, _I32, _U8, _I32,
                                         _U8]
        self.path = Path(path)
        self.lib = lib
        self.calls: Counter = Counter()
        self._calls_lock = threading.Lock()

    def _count(self, name: str) -> None:
        with self._calls_lock:  # loader threads call at once
            self.calls[name] += 1

    def reset_counts(self) -> None:
        with self._calls_lock:
            self.calls.clear()

    def prepare_image_u8(self, img, canvas_size, ch, cw, flip, fill):
        img, fill = _prep_args(img, canvas_size, ch, cw, fill)
        canvas = np.empty((canvas_size, canvas_size, 3), np.uint8)
        self.lib.prepare_image_u8(
            _ptr(img, ctypes.c_uint8), img.shape[0], img.shape[1],
            _ptr(canvas, ctypes.c_uint8), canvas_size, ch, cw,
            1 if flip else 0, _ptr(fill, ctypes.c_uint8))
        self._count("prepare_image_u8")
        return canvas

    def pack_graph_batch(self, boxes, classes, node_offsets, rels,
                         rel_offsets, n_max, e_max):
        args = _pack_args(boxes, classes, node_offsets, rels, rel_offsets)
        boxes, classes, node_offsets, rels, rel_offsets = args
        B = len(node_offsets) - 1
        out = _pack_outputs(B, n_max, e_max, np.empty)
        dropped = self.lib.pack_graph_batch(
            _ptr(boxes, ctypes.c_float), _ptr(classes, ctypes.c_int32),
            _ptr(node_offsets, ctypes.c_int64), _ptr(rels, ctypes.c_int32),
            _ptr(rel_offsets, ctypes.c_int64), B, n_max, e_max,
            _ptr(out[0], ctypes.c_float), _ptr(out[1], ctypes.c_int32),
            _ptr(out[2], ctypes.c_uint8), _ptr(out[3], ctypes.c_int32),
            _ptr(out[4], ctypes.c_uint8))
        self._count("pack_graph_batch")
        return (*out, int(dropped))

    def draw_union_rects(self, pair_boxes, pooling_size):
        pair_boxes = np.ascontiguousarray(pair_boxes, np.float32)
        if pair_boxes.ndim != 2 or pair_boxes.shape[1] != 8:
            raise ValueError(f"want (N, 8) box pairs, got "
                             f"{pair_boxes.shape}")
        n, P = pair_boxes.shape[0], pooling_size
        out = np.empty((n, 2, P, P), np.float32)
        self.lib.draw_union_rects(_ptr(pair_boxes, ctypes.c_float), n, P,
                                  _ptr(out, ctypes.c_float))
        self._count("draw_union_rects")
        return out


def load() -> Library:
    """The package's library, built at first use and loaded once a
    process."""
    global _library
    with _load_lock:
        if _library is None:
            _library = Library(build())
        return _library


# ---------------------------------------------------------------------------
# image prep


def _prep_args(img, canvas_size, ch, cw, fill):
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an (h, w, 3) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    if not (0 <= ch <= canvas_size and 0 <= cw <= canvas_size):
        raise ValueError(f"content {ch}x{cw} outside a {canvas_size} px "
                         f"canvas")
    fill = np.ascontiguousarray(fill, np.uint8).reshape(3)
    return img, fill


def prepare_image_u8(img: np.ndarray, canvas_size: int, ch: int, cw: int,
                     flip: bool, fill) -> np.ndarray:
    """PIL-style triangle (antialiased bilinear) resize of an (h, w, 3)
    uint8 image to (ch, cw), mirrored when ``flip``, written into the
    top-left of an (S, S, 3) uint8 canvas padded with ``fill``
    (``image_prep.cpp``)."""
    return load().prepare_image_u8(img, canvas_size, ch, cw, flip, fill)


def _triangle_coeffs(n_in: int, n_out: int):
    """(taps, n_out) input indices and float32 weights of
    ``image_prep.cpp::triangle_coeffs``: weights in double, cast to
    float32 and divided by the float32 total; taps past a window weigh 0
    (at a clamped index)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    center = (np.arange(n_out) + 0.5) * scale
    lo = np.maximum(np.floor(center - support), 0).astype(np.int64)
    hi = np.minimum(np.ceil(center + support), n_in).astype(np.int64)
    taps = int((hi - lo).max())
    idx = lo + np.arange(taps)[:, None]
    inside = idx < hi
    t = 1.0 - np.abs((idx + 0.5 - center) / support)
    w = np.where(inside & (t > 0.0), t, 0.0)
    total = np.zeros(n_out)
    for k in range(taps):  # the C++'s order
        total += w[k]
    w32 = w.astype(np.float32)
    w32 = np.where(total > 0.0, w32 / total.astype(np.float32), w32)
    return np.minimum(idx, n_in - 1), w32


def prepare_image_u8_plain(img: np.ndarray, canvas_size: int, ch: int,
                           cw: int, flip: bool, fill) -> np.ndarray:
    """numpy version of ``prepare_image_u8``: the C++'s weights, its
    float32 sums in its order (the horizontal pass, then the vertical
    one) and its rounding, ``floor(v + 0.5)`` clamped to [0, 255] (not
    ``np.round``, which rounds half to even). Within 1 per byte of the
    C++, whose multiply-adds the compiler fuses."""
    img, fill = _prep_args(img, canvas_size, ch, cw, fill)
    canvas = np.empty((canvas_size, canvas_size, 3), np.uint8)
    canvas[:] = fill
    if ch == 0 or cw == 0:
        return canvas
    xi, xw = _triangle_coeffs(img.shape[1], cw)
    yi, yw = _triangle_coeffs(img.shape[0], ch)
    src = img.astype(np.float32)
    tmp = np.zeros((img.shape[0], cw, 3), np.float32)
    for k in range(len(xi)):
        tmp += xw[k][None, :, None] * src[:, xi[k]]
    acc = np.zeros((ch, cw, 3), np.float32)
    for k in range(len(yi)):
        acc += yw[k][:, None, None] * tmp[yi[k]]
    out = np.clip(acc + np.float32(0.5), 0, 255).astype(np.uint8)
    canvas[:ch, :cw] = out[:, ::-1] if flip else out
    return canvas


# ---------------------------------------------------------------------------
# graph packing


def _pack_args(boxes, classes, node_offsets, rels, rel_offsets):
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    classes = np.ascontiguousarray(classes, np.int32).reshape(-1)
    node_offsets = np.ascontiguousarray(node_offsets, np.int64)
    rels = np.ascontiguousarray(rels, np.int32).reshape(-1, 3)
    rel_offsets = np.ascontiguousarray(rel_offsets, np.int64)
    # the C++ reads where the offsets point: hold them to the arrays
    if (len(node_offsets) < 1 or len(rel_offsets) != len(node_offsets)
            or node_offsets[0] != 0 or rel_offsets[0] != 0
            or (np.diff(node_offsets) < 0).any()
            or (np.diff(rel_offsets) < 0).any()
            or node_offsets[-1] > min(len(boxes), len(classes))
            or rel_offsets[-1] > len(rels)):
        raise ValueError(f"offsets {node_offsets.tolist()} / "
                         f"{rel_offsets.tolist()} do not index "
                         f"{len(boxes)} nodes and {len(rels)} relations")
    return boxes, classes, node_offsets, rels, rel_offsets


def _pack_outputs(B, n_max, e_max, make):
    return (make((B, n_max, 4), np.float32), make((B, n_max), np.int32),
            make((B, n_max), np.uint8), make((B, e_max, 3), np.int32),
            make((B, e_max), np.uint8))


def pack_graph_batch(
    boxes: np.ndarray, classes: np.ndarray, node_offsets: np.ndarray,
    rels: np.ndarray, rel_offsets: np.ndarray, n_max: int, e_max: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Pack ragged per-image graphs (concatenated, with ``B + 1`` prefix
    offsets) into padded buffers (``collate.cpp``): nodes past ``n_max``
    are cut; a relation that points at a cut or negative node, or that
    finds its image's ``e_max`` slots full, is dropped.

    Returns (boxes (B,N,4) f32, classes (B,N) i32, node_mask (B,N) u8,
    rels (B,E,3) i32, rel_mask (B,E) u8, dropped_rel_count)."""
    return load().pack_graph_batch(boxes, classes, node_offsets, rels,
                                   rel_offsets, n_max, e_max)


def pack_graph_batch_plain(boxes, classes, node_offsets, rels, rel_offsets,
                           n_max: int, e_max: int):
    """numpy version of ``pack_graph_batch``: the same buffers and the
    same dropped count."""
    boxes, classes, node_offsets, rels, rel_offsets = _pack_args(
        boxes, classes, node_offsets, rels, rel_offsets)
    B = len(node_offsets) - 1
    out_boxes, out_classes, out_node_mask, out_rels, out_rel_mask = \
        _pack_outputs(B, n_max, e_max, np.zeros)
    dropped = 0
    for b in range(B):
        ns, ne = node_offsets[b], node_offsets[b + 1]
        n = min(ne - ns, n_max)
        out_boxes[b, :n] = boxes[ns:ns + n]
        out_classes[b, :n] = classes[ns:ns + n]
        out_node_mask[b, :n] = 1
        w = 0
        for r in range(rel_offsets[b], rel_offsets[b + 1]):
            s, o, p = rels[r]
            if s >= n or o >= n or s < 0 or o < 0 or w >= e_max:
                dropped += 1
                continue
            out_rels[b, w] = (s, o, p)
            out_rel_mask[b, w] = 1
            w += 1
    return (out_boxes, out_classes, out_node_mask, out_rels, out_rel_mask,
            dropped)


# ---------------------------------------------------------------------------
# the rasterizer's oracle


def draw_union_rects_native(pair_boxes: np.ndarray,
                            pooling_size: int) -> np.ndarray:
    """(N, 8) float32 subject+object boxes -> (N, 2, P, P) float32
    coverage (``rects.cpp``), the oracle for ``ops/rects.py``."""
    return load().draw_union_rects(pair_boxes, pooling_size)


def draw_union_rects_plain(pair_boxes: np.ndarray,
                           pooling_size: int) -> np.ndarray:
    """numpy version of ``draw_union_rects_native``
    (``sgg_tpu/native/__init__.py``'s); a degenerate union divides by 1
    instead of 0."""
    pair_boxes = np.ascontiguousarray(pair_boxes, np.float32)
    n, P = pair_boxes.shape[0], pooling_size
    b = pair_boxes.reshape(n, 2, 4)
    x1u = b[..., 0].min(1, keepdims=True)
    y1u = b[..., 1].min(1, keepdims=True)
    x2u = b[..., 2].max(1, keepdims=True)
    y2u = b[..., 3].max(1, keepdims=True)
    w = np.where(x2u - x1u > 0, x2u - x1u, 1.0)
    h = np.where(y2u - y1u > 0, y2u - y1u, 1.0)
    x1 = (b[..., 0] - x1u) * P / w
    y1 = (b[..., 1] - y1u) * P / h
    x2 = (b[..., 2] - x1u) * P / w
    y2 = (b[..., 3] - y1u) * P / h
    j = np.arange(P, dtype=np.float32)[:, None]
    k = np.arange(P, dtype=np.float32)[None, :]
    yc = (np.clip(j + 1 - y1[..., None, None], 0, 1)
          * np.clip(y2[..., None, None] - j, 0, 1))
    xc = (np.clip(k + 1 - x1[..., None, None], 0, 1)
          * np.clip(x2[..., None, None] - k, 0, 1))
    return (yc * xc).astype(np.float32)
