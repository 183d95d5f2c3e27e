"""Seconds from the start of the harness's import to the first measured
step: traffic generation, the weights, the trainer, the kernels' builds
where the checkout has none, the check and warm-up steps."""


def read(run):
    return run.setup_s
