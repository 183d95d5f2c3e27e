"""The port's data tools against the JAX package's, on the CPU.

``make_fixture_dataset`` writes byte-equal trees; ``preflight_real_data``
gives the JAX tool's verdict, BLOCKER messages (the download hint names
its own package), exit code and INFO (apart from the disk and time
measurements) on a fixture tree, an empty directory and a truncated
``VG-SGG.h5``, each with ``--skip-dryrun`` (as ``tests/test_preflight.py``
holds the JAX tool), and its own dry run passes on a tiny fixture;
``bench_cache_io``'s JSON keys and break-even rule equal the JAX tool's;
``ab_cache_orientations``' arguments and summary equal the JAX tool's
given canned CLI results. Both tools run in process; neither may reach
the network (``urllib.request.urlopen`` raises here, so both preflights
record the egress probe as failed), nor drop the page cache.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys
import urllib.error
import urllib.request

import pytest

from sgg_torch import constants
from sgg_torch.data import fixtures
from sgg_torch.tools import (ab_cache_orientations, bench_cache_io,
                             make_fixture_dataset, preflight_real_data)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# INFO fields that measure this disk and this run's time
MEASURED = {"disk_free_gb", "disk_read_mb_s", "cache_read_img_s_est",
            "cache_decision", "decode_mb_s", "splits_s"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread: the suite runs several files at once, each
    on a worker, and full thread pools would oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name):
    """A fresh copy of ``tools/<name>.py`` (module-level state included)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise urllib.error.URLError("no network in the tests")
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


def run_jax_main(mod, argv, monkeypatch):
    """The JAX tool's ``main`` on ``argv``: (exit code, stdout)."""
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            mod.main()
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


def run_port_main(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


# ---------------------------------------------------------------- fixtures

def test_fixture_trees_are_byte_equal(tmp_path, monkeypatch):
    port, jax = tmp_path / "port", tmp_path / "jax"
    make_fixture_dataset.main([str(port), "all", "0.05"])
    run_jax_main(jax_tool("make_fixture_dataset"), [str(jax), "all",
                                                    "0.05"], monkeypatch)
    files = sorted(p.relative_to(port) for p in port.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(jax) for p in jax.rglob("*")
                           if p.is_file())
    assert len(files) > 20
    for rel in files:
        assert (port / rel).read_bytes() == (jax / rel).read_bytes(), rel


# ---------------------------------------------------------------- preflight

@pytest.fixture(scope="module")
def vg_tree(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("preflight_data"))
    fixtures.write_vg_fixture(d, n_train=10, n_test=4)
    return d


def parse_preflight(out):
    info = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])
    blockers = [ln.strip()[len("BLOCKER: "):] for ln in out.splitlines()
                if ln.strip().startswith("BLOCKER: ")]
    verdict = out.rstrip().splitlines()
    verdict = "READY" if verdict[-1] == "READY" else next(
        ln for ln in verdict if ln.startswith("BLOCKED ("))
    blockers = [b.replace("sgg_tpu.data.download", "<pkg>.data.download")
                .replace("sgg_torch.data.download", "<pkg>.data.download")
                for b in blockers]
    return info, blockers, verdict


def both_preflights(data_dir, monkeypatch):
    args = ["-data", data_dir, "--skip-dryrun"]
    j_code, j_out = run_jax_main(jax_tool("preflight_real_data"), args,
                                 monkeypatch)
    t_code, t_out = run_port_main(preflight_real_data.main,
                                  args + ["--probe-egress", "-device",
                                          "cpu"])
    return (j_code, parse_preflight(j_out)), (t_code,
                                              parse_preflight(t_out))


def assert_same(jax, port):
    (j_code, (j_info, j_block, j_verdict)) = jax
    (t_code, (t_info, t_block, t_verdict)) = port
    assert t_code == j_code
    assert t_verdict == j_verdict
    assert t_block == j_block
    assert set(t_info) == set(j_info)
    assert {k: v for k, v in t_info.items() if k not in MEASURED} == \
        {k: v for k, v in j_info.items() if k not in MEASURED}


def test_preflight_ready_on_fixture(vg_tree, monkeypatch, no_network):
    jax, port = both_preflights(vg_tree, monkeypatch)
    assert_same(jax, port)
    code, (info, blockers, verdict) = port
    assert code == 0 and verdict == "READY" and not blockers
    assert info["train_images"] == 10 and info["test_images"] == 4
    assert info["egress"] == "no (URLError)"


def test_preflight_blocked_on_empty_dir(tmp_path, monkeypatch, no_network):
    jax, port = both_preflights(str(tmp_path), monkeypatch)
    assert_same(jax, port)
    code, (_, blockers, verdict) = port
    assert code == 1 and verdict == "BLOCKED (2):"
    assert blockers[0].startswith("missing files/dirs")


def test_preflight_blocked_on_truncated_h5(vg_tree, tmp_path, monkeypatch,
                                           no_network):
    d = str(tmp_path / "corrupt")
    shutil.copytree(vg_tree, d)
    with open(os.path.join(d, "VG", "stanford_filtered", "VG-SGG.h5"),
              "r+b") as f:
        f.truncate(100)
    jax, port = both_preflights(d, monkeypatch)
    assert_same(jax, port)
    code, (_, blockers, _) = port
    assert code == 1 and blockers[0].startswith("tree check crashed")


def test_preflight_without_h5py_names_it(vg_tree, monkeypatch):
    """The card's machine has no ``h5py``: the tree check is a BLOCKER
    naming it, never a traceback; the egress probe is not run unless
    asked."""
    import builtins
    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name.split(".")[0] == "h5py":
            raise ModuleNotFoundError("No module named 'h5py'", name="h5py")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    code, out = run_port_main(preflight_real_data.main,
                              ["-data", vg_tree, "-device", "cpu"])
    info, blockers, verdict = parse_preflight(out)
    assert code == 1 and verdict.startswith("BLOCKED")
    assert "h5py" in blockers[0] and "Traceback" not in out
    assert info["egress"] == "not probed"


def test_preflight_dry_run(tmp_path, monkeypatch):
    """The port's dry run (splits, BatchLoader, a ``val_epoch`` batch and a
    train step) on a tiny fixture, narrow heads on 64 px canvases."""
    from sgg_torch.train import trainer
    d = str(tmp_path / "data")
    fixtures.write_vg_fixture(d, n_train=10, n_test=4)
    monkeypatch.setattr(constants, "IM_SCALE", 64)

    def tiny(config, train, device):
        return trainer.build_model(config, train, device=device,
                                   widths={"obj_dim": 32, "hidden_dim": 16})

    monkeypatch.setattr(preflight_real_data, "build_model", tiny)
    code, out = run_port_main(preflight_real_data.main,
                              ["-data", d, "--dryrun-images", "4",
                               "-device", "cpu"])
    assert code == 0, out
    assert "train step: loss" in out and "eval batch: R@100" in out
    assert out.rstrip().endswith("READY")


# ---------------------------------------------------------------- cache io

def jax_verdict(res, trunk_img_s):
    """``tools/bench_cache_io.py``'s break-even lines."""
    read_rate = res.get("read_cold_img_s", res["read_warm_img_s"])
    return {"trunk_img_s": trunk_img_s,
            "cache_speedup_vs_recompute": read_rate / trunk_img_s,
            "verdict": ("cache wins" if read_rate > trunk_img_s
                        else "recompute wins on this disk")}


def test_bench_cache_io(tmp_path, monkeypatch):
    args = ["--entries", "24", "--reads", "24", "--total", "200",
            "--shape", "4", "4", "8", "--trunk-img-s", "400"]
    jax = jax_tool("bench_cache_io")
    monkeypatch.setattr(jax, "drop_page_cache", lambda: False)
    monkeypatch.setattr(bench_cache_io, "drop_page_cache", lambda: False)
    _, out = run_jax_main(jax, args + ["--path", str(tmp_path / "j.h5")],
                          monkeypatch)
    j = json.loads(out.strip().splitlines()[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = bench_cache_io.main(args + ["--path", str(tmp_path / "t.h5")])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == t
    assert set(t) == set(j)
    assert {k: t[k] for k in jax_verdict(t, 400.0)} == jax_verdict(t, 400.0)
    assert bench_cache_io.verdict(j, 400.0) == {
        k: j[k] for k in ("trunk_img_s", "cache_speedup_vs_recompute",
                          "verdict")}
    same = ("entry_mb", "entries_written", "full_vg_gb",
            "cold_cache_dropped", "trunk_img_s")
    assert {k: t[k] for k in same} == {k: j[k] for k in same}
    assert not os.path.exists(tmp_path / "t.h5")


# ---------------------------------------------------------------- A/B

def canned(argv):
    """The CLI run replaced: a test_results.json by arm and seed."""
    run = argv[argv.index("-save_dir") + 1]
    seed = int(argv[argv.index("-seed") + 1])
    off = "-cache_orientations" in argv
    os.makedirs(run, exist_ok=True)
    res = {k: 0.1 * (i + 1) + 0.01 * seed - 0.02 * off
           for i, k in enumerate(ab_cache_orientations.KEYS)}
    with open(os.path.join(run, "test_results.json"), "w") as f:
        json.dump(res, f)


def test_ab_cache_orientations(tmp_path, monkeypatch):
    monkeypatch.delenv("SGG_IM_SCALE", raising=False)
    calls = {"jax": [], "port": []}
    jax = jax_tool("ab_cache_orientations")
    monkeypatch.setattr(jax, "_run", lambda args, env: (
        calls["jax"].append(args), canned(args)))
    monkeypatch.setattr(ab_cache_orientations, "_run", lambda args, env: (
        calls["port"].append(args), canned(args)))
    outs = {}
    for name, d in (("jax", tmp_path / "j"), ("port", tmp_path / "t")):
        os.makedirs(d / "data" / "VG")  # no fixture needed: runs are canned
    run_jax_main(jax, [str(tmp_path / "j"), "3", "2", "cpu"], monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        ab_cache_orientations.main([str(tmp_path / "t"), "3", "2", "cpu"])
    for name, d in (("jax", "j"), ("port", "t")):
        with open(tmp_path / d / "ab_cache_orientations.json") as f:
            outs[name] = f.read().replace(str(tmp_path / d), "<out>")
    assert outs["port"] == outs["jax"]
    assert len(calls["port"]) == len(calls["jax"]) == 4
    for j, t in zip(calls["jax"], calls["port"]):
        j = [a.replace(str(tmp_path / "j"), "<out>") for a in j]
        t = [a.replace(str(tmp_path / "t"), "<out>") for a in t]
        assert j[0] == "main.py" and t[:2] == ["-m", "sgg_torch.main"]
        assert t[2:] == j[1:]
