"""A configuration of another model family is new files and entries only:
in a copy of ``BENCHMARK.json`` and ``benchmarks/``, a family that only
this test adds (the IMP family's functions under a new name), a
configuration naming it (predcls at the rehearsal's size), its limits, a
traffic mix and a cell run correct through ``run.execute`` and
``run.result`` on the CPU, and no file of the copy that was there before
changes but ``BENCHMARK.json``, which only gains entries. A configuration
that names no family, or one that does not exist, is refused with the
list of those that do."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmarks import families, spec
from benchmarks.tests.conftest import REHEARSAL_LIMIT

CELL = "tiny_predcls_train"
CONFIG = "tiny_imp_predcls"
TRAFFIC = "tiny_jpeg_b2"
FAMILY = "imp_renamed"
SEED = 2 ** 31 + 4222

FAMILY_SOURCE = '''"""The IMP family under another name."""
from benchmarks import families
from benchmarks.families import imp

globals().update({n: getattr(imp, n) for n in families.INTERFACE})
'''

RUN = '''
import json, sys, torch
import benchmarks
from benchmarks import run, spec
cell = spec.load_cell(sys.argv[1])
out = run.execute(cell, int(sys.argv[2]), 1.0, False, torch.device("cpu"),
                  workers=2)
line = run.result(cell, out, False, "cpu",
                  {"bf16": 989e12, "f32": 67e12, "hbm_bytes_per_s": 3.35e12})
print(json.dumps({"line": line, "harness": benchmarks.__file__,
                  "family": cell.family.__file__}))
'''


def hashes(root):
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def write_json(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_cell(root):
    """The new family, configuration, traffic, limits and entries."""
    b = os.path.join(root, "benchmarks")
    with open(os.path.join(b, "families", f"{FAMILY}.py"), "w") as f:
        f.write(FAMILY_SOURCE)
    with open(os.path.join(b, "configs", "vgg16_imp_sgcls.json")) as f:
        cfg = json.load(f)
    cfg.update(family=FAMILY, mode="predcls", im_scale=64, obj_dim=64,
               hidden_dim=32, batch_size=2, num_workers=1, print_interval=3,
               max_nodes=8, max_edges=32)
    write_json(os.path.join(b, "configs", f"{CONFIG}.json"), cfg)
    with open(os.path.join(b, "workloads", "vg_jpeg_b24.json")) as f:
        mix = json.load(f)
    mix.update(pool_files=6, long_side=[48, 160], block=24,
               images_per_s_cap=4,
               objects=dict(min=2, max=6, mean=4, dispersion=2),
               relations=dict(mean=3, dispersion=2), epoch_margin_s=10,
               warmup_steps=1, trace_steps=2)
    write_json(os.path.join(b, "workloads", f"{TRAFFIC}.json"), mix)
    write_json(os.path.join(b, "limits", f"{CONFIG}.json"),
               {k: {"limit": REHEARSAL_LIMIT}
                for k in ("loss_gap", "grad_gap", "update_gap")})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": CONFIG, "source": "https://github.com/bknyaz/sgg",
        "file": f"benchmarks/configs/{CONFIG}.json", "reduced": [],
        "why": "IMP predcls through a family of its own"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
        "why": "predcls training at the rehearsal's size"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    write_json(path, bench)


def test_a_family_config_and_cell_are_new_files_only(tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(spec.HERE, os.path.join(root, "benchmarks"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(spec.BENCHMARK, root)
    before = hashes(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench_before = json.load(f)
    add_cell(root)
    env = dict(os.environ, PYTHONPATH=str(spec.REPO), JAX_PLATFORMS="cpu")
    env.pop("SGG_IM_SCALE", None)
    done = subprocess.run([sys.executable, "-c", RUN, CELL, str(SEED)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    line = got["line"]
    assert got["harness"].startswith(root)
    assert got["family"] == os.path.join(root, "benchmarks", "families",
                                         f"{FAMILY}.py")
    assert line["correct"], (line, done.stderr[-4000:])
    assert line["attempted"] > 0
    assert set(line["check"]) == {"loss_gap", "grad_gap", "update_gap"}
    after = hashes(root)
    changed = [p for p in before if after.get(p) != before[p]]
    assert changed == ["BENCHMARK.json"]
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["name"] != CELL]
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].remove(CELL)
    assert bench == bench_before


@pytest.mark.parametrize("cfg", [{}, {"family": "no_such_family"},
                                 {"family": "../families/imp"},
                                 {"family": "__init__"}, {"family": None}],
                         ids=["missing", "unknown", "path", "package",
                              "null"])
def test_a_config_must_name_a_family_that_exists(cfg):
    with pytest.raises(ValueError, match=r"families: \[.*'imp'.*\]"):
        families.of(cfg)


@pytest.mark.parametrize("name", ["gan_train_jpeg", "sgcls_train_jpeg"])
def test_a_cell_loads_its_family(name):
    from benchmarks.families import imp
    assert "imp" in families.names()
    assert spec.load_cell(name).family is imp
