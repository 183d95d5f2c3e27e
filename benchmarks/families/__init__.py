"""Model families: what the harness knows of one kind of model, one module
each, chosen by the configuration's ``"family"``.

``benchmarks/families/<family>.py`` is found by that name, as a metric's
reader is (``spec.reader``); the rest of the harness calls it and names no
model. A configuration without ``family``, or one that names no module
here, is refused with the list of the families there are. A new model is
a new family file (or an existing one named again), its reference, a
configuration, its limits and traffic, and readers: new files only.

A family provides:

- ``CONFIG_KEYS``: the configuration's keys that are fields of the
  program's ``Config`` (``program.program_config``).
- ``build(cfg, device, weight_seed, split, image_dir, names, cfg_seed,
  log=None, tests=None) -> program.Built``: the program's ``Trainer`` over
  ``split`` (and the splits of ``tests``, by name, for
  ``Trainer.evaluate``) with every module it needs, a detector too where
  the family has one, holding the benchmark's weights drawn on ``device``
  from ``weight_seed``.
- ``reference_steps(cfg, split, paths, cfg_seed, weight_seed, device, low,
  n_steps, workers=8, batch_hook=None) -> dict``: the plain reference's
  first ``n_steps`` training steps from the same weights and files, in the
  precision ``low`` (``"bf16"``, or the configuration's
  ``precision.control``), as ``check.compare`` takes them: ``losses`` (a
  dict of loss terms a step), ``first`` (each leaf's first gradient as its
  optimizer got it), ``change`` (each leaf's change over the steps),
  ``init`` (the starting weights), and ``decay`` (each leaf's L2 term in
  its optimizer's state, which ``check.program_first`` takes off the
  program's). ``batch_hook`` edits each numpy batch first.
- ``TRAIN_FAULTS``: ``{kind: batch_hook}``, faults planted in the
  reference's batches for ``calibrate.py``.
- ``eval_regimes(cfg)``: the regimes that ``Trainer.evaluate`` runs.
- ``eval_probe(probe) -> [(owner, attribute, original), ...]``: wraps the
  program's functions through which an eval step and its outputs pass, so
  that ``probe`` (``evaluation.Probe``) times each step while
  ``probe.window`` is set and keeps the host outputs of the first
  ``probe.check`` batches of each regime in ``probe.rec.outputs``; returns
  what to put back.
- ``eval_program(kept, split, cfg)``: ``{(regime, entry): outputs}`` from
  those kept outputs.
- ``eval_reference(cfg, split, paths, weight_seed, device, low, entries,
  workers=8) -> {entry: outputs}``: the plain reference's eval forward of
  each entry (``check_eval.reference_outputs`` calls it with TF32 off and
  no gradients).
- ``eval_as_program(ref, split)``: those outputs as the program's of each
  regime (the control; the recalls printed beside the numbers).
- ``eval_compare(prog, ref, split, cfg)``: every number that the eval
  limits may name, each as (value, where it was worst).
- ``EVAL_FAULTS``: ``{kind: context manager}``, faults planted in the
  program's eval path for ``calibrate.py``.
- ``step_sizes(split, cfg, seed, k)``, ``step_flops(split, cfg, seed, k)``
  and ``eval_flops(split, cfg)``: the work of training step ``k`` (what
  the roofline readers' launches are made of; its operations) and of an
  evaluation of ``split`` in every regime, which ``run.Run``,
  ``mfu.train`` and ``mfu.eval`` read (``work.py``).
- ``kernel_work(run, kernel)`` for ``"k1"``, ``"k1_bwd_fmap"`` and
  ``"k2"``: ``[((flops, bytes), launches), ...]``, the work of each of the
  kernel's distinct launches in the traced steps (with ``run.ev``: the
  traced eval window) and how many times it ran, or ``None`` where the
  family does not run the kernel there. The roofline readers add it up.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
INTERFACE = ("CONFIG_KEYS", "build", "reference_steps", "TRAIN_FAULTS",
             "eval_regimes", "eval_probe", "eval_program", "eval_reference",
             "eval_as_program", "eval_compare", "EVAL_FAULTS", "step_sizes",
             "step_flops", "eval_flops", "kernel_work")


def names():
    """The families there are: the modules of this directory."""
    return sorted(p.stem for p in HERE.glob("*.py")
                  if MODULE.match(p.stem) and p.stem != "__init__")


def load(name: str):
    """The module of the family ``name``, which provides ``INTERFACE``."""
    if name not in names():
        raise ValueError(f"no family {name!r} in benchmarks/families "
                         f"(families: {names()})")
    mod = importlib.import_module(f"{__name__}.{name}")
    missing = [n for n in INTERFACE if not hasattr(mod, n)]
    if missing:
        raise ValueError(f"family {name!r} lacks {missing}")
    return mod


def of(cfg: dict):
    """The family that the configuration ``cfg`` names."""
    if "family" not in cfg:
        raise ValueError(f"the configuration names no family (families: "
                         f"{names()})")
    return load(cfg["family"])
