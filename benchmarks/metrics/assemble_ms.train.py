"""The mean ``batch.assemble`` span (``BatchLoader._assemble``: decode,
native uint8 prep and packing on the loader's threads) over the batches
whose assembly starts in the untraced window."""

from benchmarks import spans


def read(run):
    return spans.mean_ms(spans.starting_in(
        "batch.assemble", *spans.measured_window(run)))
