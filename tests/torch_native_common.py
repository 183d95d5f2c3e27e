"""The JAX package's native library as the port's tests compare with it.

``sgg_tpu.native`` builds its library with ``make`` at first use and, if
that fails (as it can when several test workers build it at once), keeps
the failure for the process and returns ``None``. Then
``jax_library`` compiles the same sources, ``sgg_tpu/native/*.cpp``, with
its Makefile's flags into a directory of the test's, and binds them with
the port's ``Library``: the JAX package's code, without its fall-back.
Nothing under ``sgg_tpu/`` is written."""

import pathlib
import subprocess
from types import SimpleNamespace

import sgg_tpu.native as jnative
from sgg_torch import native

JAX_NATIVE = pathlib.Path(jnative.__file__).resolve().parent


def makefile_flags():
    """CXXFLAGS then LDFLAGS of ``sgg_tpu/native/Makefile``."""
    flags = {}
    for line in (JAX_NATIVE / "Makefile").read_text().splitlines():
        for var in ("CXXFLAGS", "LDFLAGS"):
            if line.startswith(f"{var} ?="):
                flags[var] = line.split("?=", 1)[1].split()
    return (*flags["CXXFLAGS"], *flags["LDFLAGS"])


def jax_library(tmp_dir) -> native.Library:
    """The JAX sources compiled with its Makefile's flags."""
    out = pathlib.Path(tmp_dir) / "libsggnative_jax.so"
    srcs = [str(JAX_NATIVE / s) for s in native.SOURCES]
    subprocess.run(["g++", *makefile_flags(), "-o", str(out), *srcs],
                   check=True, capture_output=True, timeout=300)
    return native.Library(out)


def jax_native(tmp_dir):
    """``prepare_image_u8``, ``pack_graph_batch`` and
    ``draw_union_rects_native`` of the JAX package: its own when its
    library loads, else ``jax_library``'s."""
    if jnative.have_native():
        return SimpleNamespace(
            prepare_image_u8=jnative.prepare_image_u8,
            pack_graph_batch=jnative.pack_graph_batch,
            draw_union_rects_native=jnative.draw_union_rects_native)
    lib = jax_library(tmp_dir)
    return SimpleNamespace(prepare_image_u8=lib.prepare_image_u8,
                           pack_graph_batch=lib.pack_graph_batch,
                           draw_union_rects_native=lib.draw_union_rects)
