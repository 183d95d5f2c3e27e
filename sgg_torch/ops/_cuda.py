"""Build and bind the port's hand-written CUDA kernels (``sgg_torch/csrc``).

Each kernel source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Nothing is
built when a module is imported: the first launch builds, and
``build_all`` builds several sources in parallel (one ``nvcc`` each). A
library is named after the hash of its source and flags, so an edited
source is rebuilt. The build directory ``sgg_torch/build/`` is listed in
``.gitignore``.

Each C entry point takes device pointers, sizes and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch(es); ``CudaKernel.launch``
raises if that is not 0 and otherwise counts the launch, in all and by
route (the element type or design the wrapper launched it for). Several
entry points may share one source (K1's two backward kernels): they share
its library, built once. A library may also export C functions that launch
nothing (K1-bwd-fmap's workspace layout); ``CudaKernel.helper`` binds them,
uncounted.

Forward and backward kernels meet in ``torch.autograd.Function``s
(``ops/roi_align.py``, ``ops/vgg_stem.py``). An input that no backward
kernel serves (the images of the VGG stem) is refused while grad mode is
on and it requires a gradient (``refuse_grad``), instead of returning an
output that silently drops it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# one build at a time per process: entry points of one source share its
# library file
_BUILD_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


class CudaKernel:
    """One ``csrc/<source>`` library and its C entry point ``symbol``.

    ``launches`` counts successful launches, ``routes`` the same launches
    by route; callers may reset both (``reset_counts``).
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.routes: Counter = Counter()
        self.build_log = ""
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def library(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}-{digest[:12]}.so"

    def _start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start ``nvcc`` unless the library exists; returns (process,
        temporary output), renamed into place by ``_finish_build``."""
        lib = self.library
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def _finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, self.library)

    def resource_lines(self) -> List[str]:
        """What ``ptxas -v`` said in the last build: per kernel its mangled
        name, then its spills and its registers and shared memory. Empty
        if the library was already built."""
        out = []
        for line in self.build_log.splitlines():
            if "Compiling entry function" in line and "'" in line:
                out.append(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                out.append(line.strip())
        return out

    def _load(self):
        with self._lock:
            if self._fn is None:
                with _BUILD_LOCK:
                    self._finish_build(self._start_build())
                lib = ctypes.CDLL(str(self.library))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.sgg_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._error_string = err
                self._lib = lib
                self._fn = fn
        return self._fn

    def helper(self, symbol: str, argtypes: Sequence,
               restype=ctypes.c_int):
        """Another C function of this kernel's library, one that launches
        nothing (a size or layout query); calls to it are not counted."""
        self._load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn

    def reset_counts(self) -> None:
        self.launches = 0
        self.routes.clear()

    def launch(self, *args, route: str) -> None:
        """Call the entry point; raise on a launch error, else count it
        under ``route``."""
        code = self._load()(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {code} ({msg})")
        self.launches += 1
        self.routes[route] += 1


def refuse_grad(name: str, *tensors, backward: str) -> None:
    """Raise if grad mode is on and one of ``tensors`` requires a gradient
    that no CUDA kernel computes (``backward`` says why)."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: no CUDA kernel computes this input's gradient "
            f"({backward}); it requires one. Run it under torch.no_grad() "
            f"or detach the input.")


def build_all(kernels: List[CudaKernel]) -> None:
    """Build every kernel's library, all ``nvcc`` processes at once (one
    per source)."""
    started, seen = [], set()
    with _BUILD_LOCK:
        try:
            for k in kernels:
                if k.library in seen:
                    continue
                seen.add(k.library)
                started.append((k, None))
                started[-1] = (k, k._start_build())
            for k, build in started:
                k._finish_build(build)
        finally:
            for k, build in started:
                if build is not None and build[0].poll() is None:
                    build[0].kill()
                    build[0].wait()
