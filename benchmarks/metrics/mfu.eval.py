"""The operations of the set's valid work (benchmarks/work.py
``eval_flops``: the trunk over the canvas, the real boxes, each unordered
pair's union once and each ordered pair's edge path; the same whatever
rung runs it) in both regimes, over the window's seconds, as a share of
the card's dense bf16 peak (benchmarks/peaks.py)."""

from benchmarks import work


def read(run):
    ev = run.ev
    if ev is None or ev.window_s <= 0:
        return None
    flops = 2 * sum(work.eval_flops(len(c), run.cfg)
                    for c in run.split.gt_classes)
    return 100.0 * flops / ev.window_s / run.peaks["bf16"]
