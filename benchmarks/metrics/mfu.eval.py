"""The operations of the set's valid work in every regime, as the
configuration's family counts them (``eval_flops``; the IMP family:
benchmarks/work.py ``eval_flops``, the trunk over the canvas, the real
boxes, each unordered pair's union once and each ordered pair's edge
path, the same whatever rung runs it, in both regimes), over the
window's seconds, as a share of the card's dense bf16 peak
(benchmarks/peaks.py)."""


def read(run):
    ev = run.ev
    if ev is None or ev.window_s <= 0:
        return None
    flops = run.cell.family.eval_flops(run.split, run.cfg)
    return 100.0 * flops / ev.window_s / run.peaks["bf16"]
