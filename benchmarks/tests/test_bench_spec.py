"""``BENCHMARK.json`` keeps to the benchmark's contract, and every
configuration, cell, traffic mix, limit and metric is found by its name."""

import json

import pytest

from benchmarks import spec

BENCH = spec.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(isinstance(w, str) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert (spec.REPO / p).is_dir() and not p.endswith("_torch")


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            yield kind, entry


@pytest.mark.parametrize("kind,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x.get("name"))
def test_names_and_units(kind, entry):
    assert spec.NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert spec.UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert spec.NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert spec.NAME.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_names_are_unique():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer
    from benchmarks import check
    assert check.judged(c.limits)
    for k in check.judged(c.limits):
        assert c.limits[k]["limit"] > 0
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_every_config_is_used_and_its_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        with open(spec.REPO / c["file"]) as f:
            json.load(f)


def test_per_layer_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
