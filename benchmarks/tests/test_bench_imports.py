"""The reference imports nothing of the program or of JAX, and the
harness nothing of JAX; the run's guard compares top-level names whole."""

import ast
import sys
from pathlib import Path

import pytest

from benchmarks import device

HERE = Path(__file__).resolve().parents[1]
PROGRAM = "sgg_torch"
JAX = ("jax", "jaxlib", "flax", "optax", "sgg_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_program_nor_jax(path):
    found = set(_imports(path))
    assert not found & set(JAX + (PROGRAM,)), found


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_harness_imports_no_jax(path):
    assert not set(_imports(path)) & set(JAX)


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sgg_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "sgg_torch_x", sys)
    assert "sgg_tpu_like" not in device.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sgg_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "optax", sys)
    assert {"sgg_tpu.ops", "optax"} <= set(device.forbidden_modules())
