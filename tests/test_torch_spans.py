"""The program's spans (``sgg_torch/utils/counters.py``): the recorder
itself (nesting and parents by thread, the thread's batch, the ring's
bound and ``earliest_ns``, the switch, ``reset``, the clock, CPU time),
``profiling.annotate`` as a span, the input pipeline's spans, and a
one-epoch ``Trainer`` run from JPEG files, SGCls and GAN, whose batches
carry one ``(epoch, index)`` through every stage and thread, each child
within its parent, and whose interval line reads the spans.

The file imports no JAX. Its card test (``-m cuda``) holds the ``step``
span against the CUDA runtime calls of torch.profiler's trace, the clock
they share; on the card::

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_spans.py -m cuda
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

import sgg_torch.constants
from sgg_torch.config import Config
from sgg_torch.data.datasets import SGGDataset
from sgg_torch.data.pipeline import BatchLoader, device_prefetch
from sgg_torch.data.synthetic import SyntheticSGGDataset
from sgg_torch.models.gan import GANModel, init_gan_weights
from sgg_torch.models.relhead import RelModelIMP, init_weights
from sgg_torch.train.trainer import Trainer
from sgg_torch.utils import counters, profiling

C, R = 9, 6
EPOCH = 3  # an epoch no other test's loader runs: its spans are this one's


@pytest.fixture(autouse=True)
def fresh_ring():
    counters.reset()
    yield
    counters.enabled = True
    counters.set_batch(None)


@pytest.fixture
def one_thread():
    """PyTorch on one CPU thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mine(name=None):
    me = threading.get_ident()
    return [s for s in counters.spans()
            if s.thread == me and (name is None or s.name == name)]


# ---------------------------------------------------------------------------
# the recorder

def test_nested_spans_name_their_parent_and_carry_the_threads_batch():
    counters.set_batch((1, 4))
    with counters.span("outer", batch=(0, 2)):
        with counters.span("inner"):
            pass
    with counters.span("after"):
        pass
    counters.set_batch(None)
    with counters.span("loose"):
        pass
    inner, outer, after, loose = _mine()
    assert (inner.name, inner.parent, inner.batch) == ("inner", "outer",
                                                       (1, 4))
    assert (outer.parent, outer.batch) == (None, (0, 2))
    assert after.parent is None and after.batch == (1, 4)
    assert loose.batch is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_other_threads_keep_their_own_parents_and_batch():
    """A span opened on another thread while this one has a span open has
    no parent and no batch of this thread's: each thread has its own."""
    seen = {}

    def work():
        with counters.span("worker"):
            with counters.span("worker.child"):
                pass
        seen["ident"] = threading.get_ident()

    counters.set_batch((0, 0))
    with counters.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: s for s in counters.spans()}
    assert by["worker"].parent is None and by["worker"].batch is None
    assert by["worker.child"].parent == "worker"
    assert by["worker"].thread == by["worker.child"].thread == seen["ident"]
    assert by["main"].thread == threading.get_ident() != seen["ident"]
    assert by["main"].batch == (0, 0)


def test_the_ring_keeps_the_last_spans_and_earliest_ns(monkeypatch):
    monkeypatch.setattr(counters, "_ring", collections.deque(maxlen=3))
    assert counters.earliest_ns() is None
    for i in range(5):
        with counters.span(f"s{i}"):
            pass
    kept = counters.spans()
    assert [s.name for s in kept] == ["s2", "s3", "s4"]
    assert counters.earliest_ns() == kept[0].start_ns
    assert counters.RING == 65536


def test_a_disabled_recorder_records_nothing():
    counters.enabled = False
    with counters.span("off", cpu=True):
        pass
    assert counters.spans() == []
    counters.enabled = True
    with counters.span("on"):
        pass
    assert [s.name for s in counters.spans()] == ["on"]


def test_reset_empties_the_ring_and_the_counts():
    counters.bump("x", 2)
    with counters.span("a"):
        pass
    counters.reset()
    assert counters.spans() == [] and counters.snapshot() == {}
    assert counters.earliest_ns() is None


def test_the_clock_is_time_ns_and_spans_select_by_interval():
    t0 = time.time_ns()
    with counters.span("first"):
        time.sleep(0.002)
    mid = time.time_ns()
    with counters.span("second"):
        pass
    t1 = time.time_ns()
    first, second = counters.spans()
    assert t0 <= first.start_ns < first.end_ns <= mid <= second.start_ns
    assert second.end_ns <= t1
    assert first.ns >= 2_000_000
    assert [s.name for s in counters.spans(mid)] == ["second"]
    assert [s.name for s in counters.spans(None, mid)] == ["first"]
    assert counters.spans(t0, t1) == [first, second]


def test_cpu_time_on_request():
    with counters.span("busy", cpu=True):
        sum(i * i for i in range(200_000))
    with counters.span("asleep", cpu=True):
        time.sleep(0.05)
    with counters.span("plain"):
        pass
    busy, asleep, plain = counters.spans()
    assert 0 < busy.cpu_ns <= busy.ns * 1.05
    assert asleep.cpu_ns < asleep.ns / 5  # off the CPU while asleep
    assert plain.cpu_ns is None


def test_a_span_records_through_an_exception_and_may_drop_its_batch():
    with pytest.raises(KeyError):
        with counters.span("fails", batch=(0, 1)):
            raise KeyError("x")
    with counters.span("ends", batch=(0, 2)) as sp:
        sp.batch = None
    with counters.span("next"):
        pass
    fails, ends, nxt = counters.spans()
    assert fails.batch == (0, 1) and ends.batch is None
    assert nxt.parent is None  # the failed span was closed


def test_annotate_is_a_span():
    assert not torch.autograd._profiler_enabled()
    with profiling.annotate("region"):
        torch.ones(4).sum()
    (sp,) = counters.spans()
    assert sp.name == "region" and sp.ns > 0


# ---------------------------------------------------------------------------
# the input pipeline

def _jpeg_split(tmp_path, n, size):
    """A train split of ``n`` JPEG files of ``size`` px, the synthetic
    dataset's graphs on them."""
    from PIL import Image
    synth = SyntheticSGGDataset(num_images=n, num_classes=C,
                                num_predicates=R, max_objects=5,
                                image_size=size, seed=3)
    rng = np.random.RandomState(0)
    names = []
    for i in range(n):
        names.append(f"{i}.jpg")
        Image.fromarray(rng.randint(0, 256, (size, size, 3), np.uint8)).save(
            tmp_path / names[-1])
    return SGGDataset(name="stanford", mode="train", filenames=names,
                      images_dir=str(tmp_path), gt_boxes=synth.gt_boxes,
                      gt_classes=synth.gt_classes,
                      relationships=synth.relationships,
                      ind_to_classes=synth.ind_to_classes,
                      ind_to_predicates=synth.ind_to_predicates,
                      box_coordinates="native")


def test_the_loader_spans_assembly_and_decode(tmp_path):
    ds = _jpeg_split(tmp_path, 6, 48)
    loader = BatchLoader(ds, batch_size=2, max_nodes=6, max_edges=8,
                         num_workers=2, im_scale=64)
    loader._epoch = EPOCH
    assert len(list(loader)) == 3
    assemble = [s for s in counters.spans() if s.name == "batch.assemble"]
    decode = [s for s in counters.spans() if s.name == "image.decode"]
    assert sorted(s.batch for s in assemble) == [(EPOCH, i)
                                                 for i in range(3)]
    assert len(decode) == 6
    # decoded in the assembly's worker threads, inside its interval
    for d in decode:
        assert d.parent is None
        assert any(a.start_ns <= d.start_ns <= d.end_ns <= a.end_ns
                   for a in assemble)


def test_device_prefetch_spans_each_copy_with_its_position():
    items = [torch.full((2,), float(i)) for i in range(4)]

    class Item:
        def __init__(self, t):
            self.t = t

        def to(self, device):
            return Item(self.t.to(device))

    got = list(device_prefetch((Item(t) for t in items), "cpu", size=2,
                               epoch=7))
    assert [float(g.t[0]) for g in got] == [0.0, 1.0, 2.0, 3.0]
    copies = _mine("batch.copy")
    assert [s.batch for s in copies] == [(7, i) for i in range(4)] + [None]
    list(device_prefetch(iter(items[:1]), "cpu"))  # no epoch: no batch
    assert [s.batch for s in _mine("batch.copy")[5:]] == [None, None]


# ---------------------------------------------------------------------------
# one epoch of the trainer

IMG = 128  # an 8 x 8 map, the GAN's least


def _epoch(tmp_path, monkeypatch, gan):
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", IMG)
    ds = _jpeg_split(tmp_path, 6, 96)
    cfg = Config(device="cpu", mode="sgcls", loss="dnorm", batch_size=2,
                 max_nodes=6, max_edges=8, compute_dtype="float32",
                 num_workers=2, print_interval=1, gan=gan, largeD=gan,
                 perturb="graphn" if gan else None, L=0.5)
    model = init_weights(RelModelIMP(num_classes=C, num_predicates=R,
                                     hidden_dim=16, obj_dim=32), 0)
    g = (init_gan_weights(GANModel(C, R, embed_dim=16, hidden_dim=8,
                                   fmap_sz=IMG // 16, n_layers_G=2,
                                   largeD=True), 1) if gan else None)
    logged = []
    t = Trainer(cfg, {"train": ds}, model=model, gan=g,
                log_fn=lambda d, **kw: logged.append(d))
    t0 = time.time_ns()
    t.train_epoch(EPOCH)
    return counters.spans(t0), logged


def _links(spans, names, n):
    """Each batch of the epoch has one span of each of ``names``, the same
    ``(epoch, index)`` on whatever thread it ran; a child lies within its
    parent (the span of that name on its thread that covers it)."""
    want = [(EPOCH, i) for i in range(n)]
    for name in names:
        got = sorted(s.batch for s in spans
                     if s.name == name and s.batch is not None)
        assert got == want, name
    for s in spans:
        if s.parent is not None:
            assert any(p.name == s.parent and p.thread == s.thread
                       and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
                       for p in spans), s


@pytest.mark.usefixtures("one_thread")
def test_an_sgcls_epoch_links_its_batches(tmp_path, monkeypatch, capsys):
    spans, logged = _epoch(tmp_path, monkeypatch, gan=False)
    _links(spans, ("batch.assemble", "batch.copy", "batch.wait", "step"), 3)
    main = threading.get_ident()
    by = collections.defaultdict(set)
    for s in spans:
        by[s.name].add(s.thread)
    assert by["batch.wait"] == by["step"] == by["batch.copy"] == {main}
    assert main not in by["batch.assemble"]
    assert {s.parent for s in spans if s.name == "batch.copy"} == {
        "batch.wait"}
    assert all(s.cpu_ns is not None for s in spans if s.name == "step")
    assert not any(s.name.startswith("step.") for s in spans)
    out = capsys.readouterr().out
    assert out.count("s/batch") == 3 and " wait=" in out and " issue=" in out
    assert {"time/wait_ms", "time/issue_ms"} <= set(logged[0])
    assert logged[0]["time/issue_ms"] > 0


@pytest.mark.usefixtures("one_thread")
def test_a_gan_epoch_links_its_batches(tmp_path, monkeypatch, capsys):
    spans, logged = _epoch(tmp_path, monkeypatch, gan=True)
    _links(spans, ("batch.assemble", "batch.gan_inputs", "batch.copy",
                   "batch.wait", "step", "step.F", "step.G", "step.D"), 3)
    threads = {name: {s.thread for s in spans if s.name == name}
               for name in ("batch.assemble", "batch.gan_inputs", "step")}
    assert len(set.union(*threads.values())) == 3  # loader, GAN, main
    for s in spans:
        if s.name in ("step.F", "step.G", "step.D"):
            assert s.parent == "step"
    for i in range(3):
        ends = {s.name: s.end_ns for s in spans if s.batch == (EPOCH, i)}
        # each stage finished this batch before the next took it
        assert ends["batch.assemble"] <= ends["batch.gan_inputs"] \
            <= ends["batch.copy"] <= ends["step"]
    out = capsys.readouterr().out
    assert " F=" in out and " G=" in out and " D=" in out
    assert {"time/wait_ms", "time/issue_ms", "time/F_ms", "time/G_ms",
            "time/D_ms"} <= set(logged[0])
    phases = sum(logged[0][f"time/{p}_ms"] for p in "FGD")
    assert 0 < phases <= logged[0]["time/issue_ms"]


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.cuda
def test_step_span_encloses_its_cuda_runtime_calls(monkeypatch):
    """Two train steps on the card under torch.profiler's CUDA activity,
    apart by a pause: each ``step`` span holds the CUDA runtime calls
    (``cudaLaunchKernel`` and the others) that the profiler records
    between them, on the same clock; the pause holds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.profiler import ProfilerActivity, profile

    from sgg_torch.data.synthetic import synthetic_splits
    from sgg_torch.train.state import Optimizer
    from sgg_torch.train.step import make_train_step
    monkeypatch.setattr(sgg_torch.constants, "IM_SCALE", 64)
    ds = synthetic_splits(num_train=4, num_eval=2, num_classes=C,
                          num_predicates=R, max_objects=5,
                          image_size=64)["train"]
    batch = next(iter(BatchLoader(ds, batch_size=2, max_nodes=6,
                                  max_edges=8, num_workers=1, im_scale=64)))
    cfg = Config(device="cuda", batch_size=2, max_nodes=6, max_edges=8,
                 compute_dtype="float32")
    model = init_weights(RelModelIMP(num_classes=C, num_predicates=R,
                                     hidden_dim=16, obj_dim=32), 0).cuda()
    step = make_train_step(model, cfg, Optimizer(cfg, model))
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(batch, gen)  # builds the kernels
    torch.cuda.synchronize()
    counters.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch, gen)
        time.sleep(0.05)
        step(batch, gen)
        torch.cuda.synchronize()
    steps = [s for s in counters.spans() if s.name == "step"]
    assert len(steps) == 2
    calls = [(e.start_ns(), e.end_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() != torch.autograd.DeviceType.CUDA
             and e.name() == "cudaLaunchKernel"]
    inside = [[c for c in calls if s.start_ns <= c[0] and c[1] <= s.end_ns]
              for s in steps]
    assert all(len(x) > 10 for x in inside), [len(x) for x in inside]
    gap = [c for c in calls if steps[0].end_ns < c[0] < steps[1].start_ns]
    assert gap == []
