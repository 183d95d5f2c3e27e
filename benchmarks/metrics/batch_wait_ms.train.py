"""The mean time the trainer's thread spends in its ``batch.wait`` span
(``Trainer.train_epoch``, around ``next()`` on its batches), over the
spans that start in the untraced window: blocked on the next batch, plus
the issue of a later batch's copies to the device (``batch.copy``, inside
it)."""

from benchmarks import spans


def read(run):
    return spans.mean_ms(spans.starting_in(
        "batch.wait", *spans.measured_window(run), main=True))
