"""The mean ``image.decode`` span (``load_source_image``'s JPEG decode, in
the loader's worker threads), per image, over the decodes that start in
the untraced window."""

from benchmarks import spans


def read(run):
    return spans.mean_ms(spans.starting_in(
        "image.decode", *spans.measured_window(run)))
