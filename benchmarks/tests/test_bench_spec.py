"""``BENCHMARK.json`` keeps to the benchmark's contract, and every
configuration, cell, traffic mix, limit and metric is found by its name."""

import json

import pytest

from benchmarks import spec
from benchmarks.tests.conftest import benchmark, load_cell

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
    """A per-layer metric's cells (those it lists; without a list, those
    that report the end-to-end metric it moves) report that metric."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        reporting = e2e[m["moves"]].get("workloads", cells)
        for cell in m.get("workloads", reporting):
            assert cell in cells
            assert cell in reporting
            assert m in spec.load_cell(cell).per_layer


HELD = benchmark()


def _eval_run():
    """A hand-made run of the eval cell, traced, with something for every
    reader to read: kernels of K1 and K2 in the trace, a window, spans'
    windows left at zero (a run that did not train)."""
    import types

    from benchmarks.evaluation import EvalRecord
    from benchmarks.traffic import Split
    from benchmarks.window import Record
    cell = load_cell("sgcls_eval_jpeg")
    ev = EvalRecord(images=32, batches=2, t_start=1.0, t_end=3.0,
                    evaluator=[(0, 10 ** 6, "evaluator")], slots=100,
                    valid=10)
    split = Split(files=[], sizes=[], entry_file=None, gt_boxes=[],
                  gt_classes=[[1, 2, 3]] * 32, relationships=[])
    trace = types.SimpleNamespace(
        kernels=[("roi_align_kernel", 0, 10 ** 6),
                 ("vgg_conv1_bf16_kernel", 0, 10 ** 6)],
        busy_s=1.0, window_s=2.0)
    return types.SimpleNamespace(
        cell=cell, cfg=cell.config, split=split, cfg_seed=1, rec=Record(),
        trace=trace, peaks={"bf16": 989e12, "f32": 67e12,
                            "hbm_bytes_per_s": 3.35e12},
        setup_s=40.0, window_busy_s=1.0, ev=ev)


def test_the_eval_cell_reports_its_own_metrics():
    cell = load_cell("sgcls_eval_jpeg")
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"eval_device_ms_per_image", "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert layer == {"images_per_s.eval", "evaluator_ms.eval",
                     "device_idle_pct.eval", "pair_fill_pct.eval",
                     "mfu.eval", "k1_roofline.eval"}
    for name in ("gan_train_jpeg", "sgcls_train_jpeg"):
        train = load_cell(name)
        assert "eval_device_ms_per_image" not in {
            m["name"] for m in train.end_to_end}
        assert not {m["name"] for m in train.per_layer} & layer


@pytest.mark.parametrize("metric", [m["name"] for m in HELD["per_layer"]
                                    + HELD["end_to_end"]])
def test_no_train_reader_reports_on_an_eval_run(metric):
    run = _eval_run()
    got = spec.reader(metric)(run)
    if metric in {m["name"] for m in run.cell.per_layer +
                  run.cell.end_to_end}:
        assert got is not None and got > 0
    else:
        assert got is None


def test_an_eval_reader_reports_nothing_on_a_train_run():
    import types
    from benchmarks.window import Record
    run = types.SimpleNamespace(rec=Record(window_steps=3, trace_steps=2),
                                trace=None, ev=None, window_busy_s=1.0,
                                cfg={"batch_size": 24})
    for m in HELD["per_layer"] + HELD["end_to_end"]:
        if "sgcls_eval_jpeg" in m.get("workloads", ()):
            assert spec.reader(m["name"])(run) is None, m["name"]


def test_the_held_out_cell_keeps_to_the_contract():
    """The held-out cell and its metrics, merged in, pass the checks that
    BENCHMARK.json's entries pass, so that a later change can move them
    there as they stand."""
    bench = HELD
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for kind in ("workloads", "end_to_end", "per_layer"):
        for entry in bench[kind]:
            test_names_and_units(kind, entry)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cell = load_cell("sgcls_eval_jpeg")
    from benchmarks import check
    assert check.judged(cell.limits) == ["rel_score_gap", "obj_score_gap"]
