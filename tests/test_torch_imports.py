"""The port stands alone: no module of ``sgg_torch`` and no line of
``chip_smoke.py`` or ``bench_kernels.py`` imports JAX, flax or ``sgg_tpu``; importing the package
builds nothing."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|sgg_tpu)\b")


def _port_files():
    return sorted((ROOT / "sgg_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_kernels.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_sgg_tpu_import(path):
    bad = [f"{path.name}:{i}: {line.strip()}"
           for i, line in enumerate(path.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)
           or re.search(r"import_module\(\s*['\"](jax|flax|sgg_tpu)", line)]
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
