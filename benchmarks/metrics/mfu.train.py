"""The model's operations in the window's steps, as the configuration's
family counts them (``step_flops``; the IMP family: benchmarks/work.py,
real boxes and sampled edges, the trunk over the canvas, forward and the
backward the training needs) over the window's seconds, as a share of
the card's dense bf16 peak (benchmarks/peaks.py), the card's power limit
recorded beside it."""


def read(run):
    rec = run.rec
    if rec.window_steps == 0:
        return None
    return 100.0 * run.window_flops() / rec.window_s / run.peaks["bf16"]
