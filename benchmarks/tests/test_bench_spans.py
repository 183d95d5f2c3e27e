"""The readers of the program's spans (``benchmarks/spans.py`` and the
nine metrics on it) on a hand-made run: hand-made spans in place of the
program's recorder, hand-made kernel intervals in place of the trace;
each reader's arithmetic, and None where it has nothing to read (no
recorder, as at a commit before it; no span of its kind; a ring that
starts after the window). Then a traced rehearsal on the CPU, whose line
carries all nine."""

import time
import types

import pytest

from benchmarks import spans, spec
from benchmarks.window import Record

MS = 10 ** 6
T0 = 10_000 * MS  # the untraced window: 10 s to 11 s
T1 = 11_000 * MS
TR = (20_000 * MS, 20_100 * MS)  # the traced steps: 100 ms
MAIN = 1
SPAN_METRICS = ("batch_wait_ms.train", "batch_queue_ms.train",
                "assemble_ms.train", "decode_ms.train", "gan_inputs_ms.train",
                "step_issue_ms.train", "step_offcpu_pct.train")
IDLE_METRICS = ("idle_wait_pct.train", "idle_issue_pct.train")


def S(name, start_ms, end_ms, batch=None, thread=MAIN, cpu_ms=None,
      parent=None):
    return types.SimpleNamespace(
        name=name, parent=parent, thread=thread, batch=batch,
        start_ns=int(start_ms * MS), end_ns=int(end_ms * MS),
        cpu_ns=None if cpu_ms is None else int(cpu_ms * MS))


class Recorder:
    def __init__(self, items, earliest=None):
        self.items = items
        self.first = earliest if earliest is not None else min(
            (s.start_ns for s in items), default=None)

    def spans(self):
        return list(self.items)

    def earliest_ns(self):
        return self.first


def _run(kernels=()):
    trace = types.SimpleNamespace(kernels=[("k", int(s * MS), int(e * MS))
                                           for s, e in kernels])
    return types.SimpleNamespace(rec=Record(trace_t=TR), trace=trace,
                                 cfg={"batch_size": 2})


@pytest.fixture
def use(monkeypatch):
    """Read ``items`` (and the ring's start) in place of the program's."""
    monkeypatch.setattr(spans.threading, "main_thread",
                        lambda: types.SimpleNamespace(ident=MAIN))
    monkeypatch.setattr(spans, "measured_window", lambda run: (T0, T1))

    def put(items, earliest=None):
        rec = Recorder(items, earliest)
        monkeypatch.setattr(spans, "recorder", lambda: rec)
    return put


def read(name, run=None):
    return spec.reader(name)(run or _run())


# the untraced window's spans, in ms; batch k's stages, the loader's
# thread 2, the GAN's 3
WINDOW = [
    S("batch.assemble", 9_000, 9_100, (0, 0), thread=2),  # before: out
    S("batch.assemble", 10_000, 10_200, (0, 1), thread=2),
    S("batch.assemble", 10_300, 10_600, (0, 2), thread=2),
    S("image.decode", 10_010, 10_030, thread=4),
    S("image.decode", 10_020, 10_060, thread=5),
    S("batch.gan_inputs", 10_200, 10_250, (0, 1), thread=3),
    S("batch.gan_inputs", 10_600, 10_640, (0, 2), thread=3),
    # batch 1 waits 150 ms in the queue; batch 2's copy began 40 ms early
    S("batch.wait", 10_390, 10_420, (0, 1)),
    S("batch.copy", 10_400, 10_410, (0, 1), parent="batch.wait"),
    S("step", 10_420, 10_820, (0, 1), cpu_ms=100),
    S("batch.wait", 10_590, 10_650, (0, 2)),
    S("batch.copy", 10_600, 10_645, (0, 2), parent="batch.wait"),
    S("step", 10_650, 10_950, (0, 2), cpu_ms=200),
    S("step", 10_950, 11_300, (0, 3), cpu_ms=1),  # starts in, ends after
    S("step", 11_300, 11_400, (0, 4), cpu_ms=1),  # after: out
    S("batch.wait", 10_500, 10_600, (0, 9), thread=7),  # not the main's
]


def test_span_readers(use):
    use(WINDOW)
    assert read("batch_wait_ms.train") == pytest.approx((30 + 60) / 2)
    assert read("assemble_ms.train") == pytest.approx((200 + 300) / 2)
    assert read("decode_ms.train") == pytest.approx((20 + 40) / 2)
    assert read("gan_inputs_ms.train") == pytest.approx((50 + 40) / 2)
    assert read("step_issue_ms.train") == pytest.approx(
        (400 + 300 + 350) / 3)
    assert read("step_offcpu_pct.train") == pytest.approx(
        100 * (1 - 301 / 1050))
    # the last host stage: the GAN's where there is one
    assert read("batch_queue_ms.train") == pytest.approx((150 + 0) / 2)


def test_batch_queue_without_a_gan_reads_the_assembly(use):
    use([s for s in WINDOW if s.name != "batch.gan_inputs"])
    assert read("batch_queue_ms.train") == pytest.approx((200 + 0) / 2)
    assert read("gan_inputs_ms.train") is None


def test_idle_readers(use):
    # traced steps 20,000-20,100 ms: kernels at 0-10, 30-50, 45-60, 90-120
    # (ms past the start); waits 5-30 and 95-99; the step 30-95
    k = [(20_000, 20_010), (20_030, 20_050), (20_045, 20_060),
         (20_090, 20_120)]
    use([S("batch.wait", 20_005, 20_030), S("batch.wait", 20_095, 20_099),
         S("step", 20_030, 20_095), S("batch.wait", 19_990, 20_003),
         S("step", 20_040, 20_080, thread=7)])
    run = _run(k)
    # idle: 10-30, 60-90; inside a wait: 10-30 (20 ms); in the step 60-90
    assert read("idle_wait_pct.train", run) == pytest.approx(20.0)
    assert read("idle_issue_pct.train", run) == pytest.approx(30.0)
    run.trace.kernels = []
    assert read("idle_issue_pct.train", run) == pytest.approx(65.0)
    run.trace = None
    assert read("idle_issue_pct.train", run) is None


@pytest.mark.parametrize("name", SPAN_METRICS + IDLE_METRICS)
def test_nothing_to_read_is_none(use, monkeypatch, name):
    run = _run([(20_000, 20_010)])
    use([])
    assert read(name, run) is None
    use([S("other", 10_000, 10_001), S("other", 20_000, 20_001)])
    assert read(name, run) is None
    # the ring starts after the window's start: it dropped part of it
    use(WINDOW + [S("batch.wait", 20_005, 20_030),
                  S("step", 20_030, 20_095)], earliest=T0 + 1)
    if name in SPAN_METRICS:
        assert read(name, run) is None
    use(WINDOW + [S("batch.wait", 20_005, 20_030),
                  S("step", 20_030, 20_095)], earliest=TR[0] + 1)
    assert read(name, run) is None
    # a program without the recorder (a commit before it)
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert read(name, run) is None


def test_a_program_without_spans_has_no_recorder(monkeypatch):
    from sgg_torch.utils import counters
    assert spans.recorder() is counters
    monkeypatch.delattr(counters, "spans")
    assert spans.recorder() is None


def test_the_measured_window_is_on_time_ns():
    p = time.perf_counter()
    now = time.time_ns()
    run = types.SimpleNamespace(rec=Record(t_start=p - 2.0, t_end=p))
    t0, t1 = spans.measured_window(run)
    assert abs(t1 - now) < 50 * MS
    assert t1 - t0 == pytest.approx(2e9, abs=1e3)


def test_a_traced_rehearsal_reports_all_nine(monkeypatch):
    """The GAN cell on the CPU through the harness, traced: the program's
    spans reach every new reader (the CPU's operators stand in for the
    device's kernels here)."""
    from benchmarks.tests.test_bench_rehearsal import rehearse
    _, out, line = rehearse(monkeypatch, "gan_train_jpeg", True, 4.0)
    assert line["correct"], out["numbers"]
    got = line["metrics"]
    assert set(SPAN_METRICS + IDLE_METRICS) <= set(got)
    assert got["step_issue_ms.train"]["value"] > 0
    assert 0 <= got["step_offcpu_pct.train"]["value"] <= 100
