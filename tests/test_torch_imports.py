"""The port stands alone: no module of ``sgg_torch`` (its tools and
examples included) and no line of ``chip_smoke.py`` or ``bench_kernels.py``
imports JAX, flax, optax or ``sgg_tpu``; importing the package
builds nothing; importing its entry points, data modules, import tool,
feature bank and analysis modules loads none of ``h5py``, PIL,
``transformers`` and ``wandb``; importing the drawing helpers and the
downloader loads none of cv2, networkx and matplotlib."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|sgg_tpu)\b")


def _port_files():
    return sorted((ROOT / "sgg_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_kernels.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_sgg_tpu_import(path):
    bad = [f"{path.name}:{i}: {line.strip()}"
           for i, line in enumerate(path.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)
           or re.search(r"import_module\(\s*['\"](jax|flax|optax|sgg_tpu)",
                        line)]
    assert not bad, bad


def test_package_imports_without_jax():
    code = ("import sys, importlib, pkgutil\n"
            "before = set(sys.modules)\n"
            "import sgg_torch\n"
            "for m in pkgutil.walk_packages(sgg_torch.__path__, 'sgg_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in set(sys.modules) - before\n"
            "       if m.split('.')[0] in ('jax', 'flax', 'sgg_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("module", [
    "sgg_torch.main", "sgg_torch.data.visual_genome",
    "sgg_torch.data.vtranse", "sgg_torch.data.gqa",
    "sgg_torch.data.fixtures", "sgg_torch.data.feature_cache",
    "sgg_torch.data.pipeline", "sgg_torch.import_reference_ckpt",
    "sgg_torch.extract_features", "sgg_torch.augment.feature_bank",
    "sgg_torch.augment.bert", "sgg_torch.augment.gan_eval",
    "sgg_torch.utils.logging", "sgg_torch.train.trainer"])
def test_no_h5py_or_pil_at_import(module):
    """The card's machine has neither ``h5py`` nor ``transformers`` (nor,
    in general, ``wandb``): importing the port's modules loads none of
    them, nor PIL (they are imported where a file is read or decoded, a
    model is loaded or a run is logged)."""
    code = (f"import sys\n"
            f"before = set(sys.modules)\n"
            f"import {module}\n"
            f"bad = [m for m in set(sys.modules) - before\n"
            f"       if m.split('.')[0] in ('h5py', 'PIL', 'transformers',\n"
            f"                              'wandb')]\n"
            f"assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("module", ["sgg_torch.utils.visualize",
                                    "sgg_torch.data.download"])
def test_drawing_and_download_load_lazily(module):
    """The drawing helpers import cv2, networkx and matplotlib, and the
    downloader opens a connection, only when called."""
    code = (f"import sys\n"
            f"before = set(sys.modules)\n"
            f"import {module}\n"
            f"bad = [m for m in set(sys.modules) - before\n"
            f"       if m.split('.')[0] in ('cv2', 'networkx',\n"
            f"                              'matplotlib')]\n"
            f"assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("package", ["sgg_torch.tools", "sgg_torch.examples"])
def test_tools_and_examples_import_lightly(package):
    """Every tool and example module imports without JAX, flax, optax or
    ``sgg_tpu`` and without the packages that only some of them need when
    they run (h5py, PIL, transformers, wandb, cv2, networkx,
    matplotlib): the card's machine lacks several of them."""
    code = (f"import sys, importlib, pkgutil\n"
            f"before = set(sys.modules)\n"
            f"import {package} as p\n"
            f"names = [m.name for m in pkgutil.iter_modules(p.__path__,\n"
            f"         '{package}.')]\n"
            f"assert len(names) >= 4, names\n"
            f"for n in names:\n"
            f"    importlib.import_module(n)\n"
            f"bad = [m for m in set(sys.modules) - before\n"
            f"       if m.split('.')[0] in ('jax', 'flax', 'optax',\n"
            f"       'sgg_tpu', 'h5py', 'PIL', 'transformers', 'wandb',\n"
            f"       'cv2', 'networkx', 'matplotlib')]\n"
            f"assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("source", ["image_prep.cpp", "collate.cpp",
                                    "rects.cpp"])
def test_native_library_builds_from_its_own_sources(source, monkeypatch,
                                                    tmp_path):
    """``sgg_torch.native`` compiles its own copy of each C++ source: the
    compiler's command names the file under ``sgg_torch/native/`` and no
    path under ``sgg_tpu/``."""
    from sgg_torch import native
    assert (ROOT / "sgg_torch" / "native" / source).is_file()
    commands = []

    def run(cmd, **kw):
        commands.append(cmd)
        raise OSError("not run")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", run)
    with pytest.raises(native.NativeBuildError):
        native.build()
    cmd, = commands
    assert str(ROOT / "sgg_torch" / "native" / source) in cmd
    assert not [a for a in cmd if "sgg_tpu" in a], cmd
