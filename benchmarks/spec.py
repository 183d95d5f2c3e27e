"""What ``BENCHMARK.json`` says about a cell, and the files it names.

The harness is driven by data: a cell names its configuration and its
traffic mix, and a metric names its reader. They are found by name:

- ``configs[*].file``: the configuration as it is run (JSON), which names
  its model family: ``benchmarks/families/<family>.py`` builds the
  program, runs the plain reference and counts the work
  (``benchmarks/families``);
- ``benchmarks/workloads/<traffic>.json``: the traffic mix's parameters;
- ``benchmarks/limits/<config>.json``: the limits of the comparison that
  decides ``correct``, with the readings they were set from, for the
  cells that train; ``<config>.<drive>.json`` for those whose traffic
  mix names another ``drive`` (``evaluate``: ``evaluation.py``);
- ``benchmarks/metrics/<metric>.py``: a reader, ``read(run) -> float or
  None``, for every metric, end to end or per layer.

A later cell, configuration or metric is a set of new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

from benchmarks import families

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK = REPO / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    family: object      # the configuration's module of benchmarks/families
    traffic_name: str
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it; of those that list no cells, an end-to-end metric
    always, a per-layer one where the cell reports the end-to-end metric
    that it ``moves``."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    if kind == "end_to_end":
        return [m for m in bench[kind] if listed(m)]
    ends = {m["name"] for m in metrics_of(bench, cell, "end_to_end")}
    return [m for m in bench[kind] if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in ends)]


def drive(traffic: dict) -> str:
    """What a cell's traffic drives: ``train`` (``Trainer.train_epoch``,
    the default) or ``evaluate`` (``Trainer.evaluate``)."""
    return traffic.get("drive", "train")


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = bench or load_benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(REPO / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "workloads" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    kind = drive(traffic)
    stem = w["config"] if kind == "train" else f"{w['config']}.{kind}"
    with open(HERE / "limits" / f"{stem}.json") as f:
        limits = json.load(f)
    return Cell(name=name, config_name=w["config"], config=config,
                family=families.of(config), traffic_name=w["traffic"], traffic=traffic, limits=limits,
                chips=w["chips"],
                end_to_end=metrics_of(bench, name, "end_to_end"),
                per_layer=metrics_of(bench, name, "per_layer"))


def reader(metric: str):
    """The ``read`` function of ``benchmarks/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of the metrics whose readers found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
