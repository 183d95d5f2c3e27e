"""The mean ``step`` span (the train or GAN step, top to return, on the
trainer's thread): the host's issue of one step, over the steps that
start in the untraced window. The step waits for nothing on the device;
where this exceeds the step's kernel time the host sets the pace."""

from benchmarks import spans


def read(run):
    return spans.mean_ms(spans.starting_in(
        "step", *spans.measured_window(run), main=True))
