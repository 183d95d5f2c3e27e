"""The mean ``batch.gan_inputs`` span per batch (the GAN thread's GraphN
perturbation of the host batch and its pinning,
``Trainer._gan_host_inputs`` and ``GANBatch.pinned``), over the spans
that start in the untraced window."""

from benchmarks import spans


def read(run):
    return spans.mean_ms(spans.starting_in(
        "batch.gan_inputs", *spans.measured_window(run)))
