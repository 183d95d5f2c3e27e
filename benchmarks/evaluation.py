"""The measured window of a cell that evaluates (its traffic's ``drive`` is
``evaluate``): ``Trainer.evaluate`` over a test split, driven from the
benchmark's side.

The split is a fixed set of ``batches`` batches of the configuration's
``eval_batch_size`` (``traffic.annotations`` with ``group``: every seed
runs the same sizes in each batch, so the same rungs), drawn with the
traffic's laws, with no flips. Set-up builds the trainer with it and a
``train`` split of the same laws, whose triplet frequencies the
per-triplet recall reads. Before the window the trainer evaluates a
warm-up split: the set's first batch of each rung that the ladder rule
(``work.rung``) gives, so that each regime launches every shape of the
window first. The window is one call of ``Trainer.evaluate`` over the
set: both regimes, with the loader, the copies, the forward and the
evaluators, the device synchronised at both ends, under
``torch.profiler``'s CUDA activity (``trace.py``).

Probes, installed for the run and removed after it: the configuration's
family wraps the program's eval step and its copy to the host
(``eval_probe``: the IMP family wraps ``val_epoch``'s ``make_eval_step``
and ``_to_numpy``), which times each step's issue, keeps the host
outputs of the first ``check_batches`` batches of each regime for the
comparison that decides ``correct`` (``check_eval.py``), and counts the
pair slots run and the valid pairs among them; the evaluators'
``add_image`` and ``results`` are timed on the host's clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

from benchmarks import program, traffic, work


@dataclasses.dataclass
class EvalRecord:
    """What a run keeps of the window."""

    images: int = 0             # the set's images, each counted once
    batches: int = 0            # a regime's batches
    t_start: float = 0.0        # perf_counter
    t_end: float = 0.0
    trace_t: tuple = (0, 0)     # time_ns
    profile: object = None
    steps: List[tuple] = dataclasses.field(default_factory=list)
    evaluator: List[tuple] = dataclasses.field(default_factory=list)
    rungs: Dict[str, int] = dataclasses.field(default_factory=dict)
    slots: int = 0              # pair slots the window's batches ran
    valid: int = 0              # valid pairs among them
    outputs: Dict[tuple, dict] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def evaluator_s(self) -> float:
        return sum(e - s for s, e, _ in self.evaluator) / 1e9


class Probe:
    """The wrappers of the module's text; ``window`` is set while the
    window runs, and only then are steps, outputs and times kept.
    ``count`` and ``at`` are the family's wrappers' own: the steps of each
    regime, and the regime and batch of the step in flight."""

    def __init__(self, rec: EvalRecord, check_batches: int, family):
        self.rec, self.check, self.family = rec, check_batches, family
        self.window = False
        self.count: Dict[str, int] = {}
        self.at = None
        self.depth = 0

    def begin(self, window: bool) -> None:
        self.window, self.count = window, {}

    def install(self):
        """Wrap the program's functions; returns the undo."""
        from sgg_torch.eval import sgg_eval
        evaluators = [(cls, attr, getattr(cls, attr))
                      for cls in (sgg_eval.SGGEvaluator,
                                  sgg_eval.MeanRecallEvaluator)
                      for attr in ("add_image", "results")]
        saved = self.family.eval_probe(self) + evaluators
        rec = self.rec

        def timed(fn):
            # the mean-recall evaluator calls an SGGEvaluator a predicate:
            # only the outermost call is timed
            def call(*a, **kw):
                self.depth += 1
                t0 = time.time_ns()
                try:
                    return fn(*a, **kw)
                finally:
                    self.depth -= 1
                    if self.window and self.depth == 0:
                        rec.evaluator.append((t0, time.time_ns(),
                                              "evaluator"))
            return call

        for owner, attr, fn in evaluators:
            setattr(owner, attr, timed(fn))

        def undo():
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)

        return undo


def num_batches(mix: dict, seconds: float) -> int:
    """A regime's batches: the traffic's ``batches`` at ``batches_at_s``
    seconds, in proportion to ``seconds``, at least ``check_batches``."""
    return max(mix["check_batches"],
               int(round(mix["batches"] * seconds / mix["batches_at_s"])))


def splits(mix: dict, seed: int, sizes, cfg: dict, seconds: float):
    """(the set, the training split) of a run."""
    B = cfg["eval_batch_size"]
    test = traffic.annotations(mix, seed, sizes, num_batches(mix, seconds) * B,
                               cfg["num_classes"], cfg["num_predicates"],
                               group=B)
    train = traffic.annotations(mix, seed, sizes, mix["train_entries"],
                                cfg["num_classes"], cfg["num_predicates"],
                                stream=5)
    return test, train


def batch_counts(split, cfg: dict) -> List[List[int]]:
    """The object counts of each test batch of ``split``, in order."""
    B = cfg["eval_batch_size"]
    n = [len(c) for c in split.gt_classes]
    return [n[i:i + B] for i in range(0, len(n), B)]


def rungs(split, cfg: dict) -> List[int]:
    """The pair slots an image of each batch runs, by the ladder rule."""
    counts = batch_counts(split, cfg)
    steps = work.ladder(cfg, work.eval_nodes(sum(counts, []), cfg))
    return [work.rung(c, steps) for c in counts]


def warm_entries(split, cfg: dict) -> List[int]:
    """The entries of the set's first batch of each rung it uses."""
    B = cfg["eval_batch_size"]
    seen, out = set(), []
    for k, r in enumerate(rungs(split, cfg)):
        if r not in seen:
            seen.add(r)
            out += range(k * B, (k + 1) * B)
    return out


def build(cell, dev, weight_seed: int, cfg_seed: int, test, train,
          image_dir: str, names, log=None):
    """The trainer with the set under the traffic's split name, and the
    warm-up split."""
    cfg, mix = cell.config, cell.traffic
    ds = program.dataset(test, image_dir, names, cfg, mode="test")
    warm = program.dataset(test, image_dir, names, cfg, mode="test",
                           entries=warm_entries(test, cfg))
    built = program.build(cfg, dev, weight_seed, train, image_dir, names,
                          cfg_seed, log=log, tests={mix["split"]: ds})
    return built, ds, warm


def run_window(trainer, name: str, test_ds, warm_ds, probe: Probe, clock,
               profile=None, on_open=None) -> EvalRecord:
    """The warm-up evaluation, then the window (see the module's text);
    ``profile`` starts a profiler, which the window stops."""
    rec = probe.rec
    trainer.splits[name] = warm_ds
    probe.begin(window=False)
    trainer.evaluate([name], verbose=False)
    trainer.splits[name] = test_ds
    clock.sync()
    prof = profile() if profile is not None else None
    probe.begin(window=True)
    if on_open is not None:
        on_open()
    rec.t_start = time.perf_counter()
    t0 = time.time_ns()
    trainer.evaluate([name], verbose=False)
    clock.sync()
    rec.t_end = time.perf_counter()
    rec.trace_t = (t0, time.time_ns())
    probe.begin(window=False)
    if prof is not None:
        prof.stop()
        rec.profile = prof
    return rec
