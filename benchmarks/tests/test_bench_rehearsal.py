"""A tiny rehearsal of each cell on the CPU through the harness's own code
(traffic, the program's ``Trainer.train_epoch`` under the step wrapper or
its ``Trainer.evaluate`` under the eval probes, the window, the trace,
the reference, the comparison), and the same run with its timed path
broken underneath, which must read not correct. In training:

- a step that returns its state unchanged (the optimizers apply nothing);
- half of the batch left out, the means taken over the rest (the loader's
  batches lose the second half of their nodes and relations).

In evaluation (the IMP family's ``EVAL_FAULTS``): half of the candidate
pairs left out; the unions' dedup gathering each pair from its
neighbour's row.

The CPU stands in for the card here only: ``run.main`` refuses to measure
without one (``test_bench_nocard.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.tests.conftest import tiny_cell

CELLS = ("sgcls_train_jpeg", "gan_train_jpeg")
EVAL_CELL = "sgcls_eval_jpeg"
PEAKS = {"bf16": 989e12, "f32": 67e12, "hbm_bytes_per_s": 3.35e12}
SEED = 2 ** 31 + 12345


def rehearse(monkeypatch, name, trace=False, seconds=1.0):
    from benchmarks import program, run
    from sgg_torch import constants
    cell = tiny_cell(name)
    program.set_canvas(cell.config)
    # the program reads its canvas once, at import: the cells' differ
    monkeypatch.setattr(constants, "IM_SCALE", cell.config["im_scale"])
    out = run.execute(cell, SEED, seconds, trace, torch.device("cpu"),
                      workers=2)
    return cell, out, run.result(cell, out, trace, "cpu", PEAKS)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(monkeypatch, name, trace):
    # a traced window long enough that the loader assembles in it
    cell, out, line = rehearse(monkeypatch, name, trace, 4.0 if trace else 1.0)
    assert line["correct"], out["numbers"]
    assert line["attempted"] == out["rec"].window_steps > 0
    assert list(line)[-1] == "check"
    assert not out["left"]
    wanted = cell.per_layer if trace else cell.end_to_end
    got = set(line["metrics"])
    assert got <= {m["name"] for m in wanted}
    if trace:
        assert {"images_per_s.train", "assemble_ms.train", "mfu.train",
                "step_ms_p90.train"} <= got
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "breakdown" in line
        assert out["window_busy_s"] is None
    else:
        # the window ran under the profiler; on the CPU it holds no device
        # activity, so the card's time per image has nothing to read
        assert out["window_busy_s"] == 0.0
        assert got == {"setup_s"}


def test_device_time_per_image_reads_the_window():
    from benchmarks import spec
    from benchmarks.window import Record
    rec = Record(window_steps=10)
    run = type("Run", (), {"rec": rec, "cfg": {"batch_size": 24},
                           "window_busy_s": 2.4})()
    assert spec.reader("train_device_ms_per_image")(run) == \
        pytest.approx(10.0)
    run.window_busy_s = None
    assert spec.reader("train_device_ms_per_image")(run) is None


def unchanged_state(monkeypatch):
    from sgg_torch.train import state
    for cls in (state.Optimizer, state.Adam):
        orig = cls.apply_gradients

        def apply(self, _orig=orig):
            saved = [p.detach().clone() for p in self.params]
            norm = _orig(self)
            with torch.no_grad():
                for p, s in zip(self.params, saved):
                    p.copy_(s)
            return norm

        monkeypatch.setattr(cls, "apply_gradients", apply)


def half_batch(monkeypatch):
    from sgg_torch.data.pipeline import BatchLoader
    orig = BatchLoader._assemble

    def assemble(self, *a, **kw):
        b = orig(self, *a, **kw)
        h = b.node_mask.shape[0] // 2
        nm, rm = np.array(b.node_mask), np.array(b.rel_mask)
        nm[h:], rm[h:] = False, False
        return dataclasses.replace(b, node_mask=nm, rel_mask=rm)

    monkeypatch.setattr(BatchLoader, "_assemble", assemble)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch],
                         ids=["unchanged_state", "half_batch"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    _, out, line = rehearse(monkeypatch, name)
    assert not line["correct"], out["numbers"]


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_eval_run_is_correct(monkeypatch, trace):
    from benchmarks import evaluation
    cell, out, line = rehearse(monkeypatch, EVAL_CELL, trace)
    assert line["correct"], out["numbers"]
    ev, split = out["ev"], out["split"]
    assert line["attempted"] == ev.images == len(split) == 2 * 16
    assert list(line)[-1] == "check"
    assert set(line["check"]) == {"rel_score_gap", "obj_score_gap"}
    assert "obj_label_disagree" in out["numbers"]
    assert not out["left"]
    # both regimes kept their first batch; every batch ran the rung the
    # ladder rule gives it
    assert set(ev.outputs) == {("predcls", 0), ("sgcls", 0)}
    rungs = evaluation.rungs(split, cell.config)
    assert ev.slots == 2 * 16 * sum(rungs)
    assert ev.valid == 2 * sum(len(c) * (len(c) - 1)
                               for c in split.gt_classes)
    assert sum(ev.rungs.values()) == 2 * len(rungs)
    got = set(line["metrics"])
    if trace:
        assert got == {"images_per_s.eval", "evaluator_ms.eval",
                       "pair_fill_pct.eval", "mfu.eval"}
        assert line["metrics"]["pair_fill_pct.eval"]["value"] == \
            pytest.approx(100.0 * ev.valid / ev.slots)
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "breakdown" in line
    else:
        assert got == {"setup_s"}
    assert out["window_busy_s"] == 0.0


@pytest.mark.parametrize("fault", ["fault_half_pairs", "fault_dedup_map"])
def test_a_broken_eval_path_is_not_correct(monkeypatch, fault):
    from benchmarks.families import imp
    with imp.EVAL_FAULTS[fault]():
        _, out, line = rehearse(monkeypatch, EVAL_CELL)
    assert not line["correct"], out["numbers"]
