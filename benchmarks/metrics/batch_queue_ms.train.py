"""How long a finished batch waits in the queues before the trainer's
thread takes it: over the batches whose ``batch.copy`` span starts in the
untraced window, the mean of that start minus the end of the batch's last
host stage (``batch.gan_inputs`` with a GAN, else ``batch.assemble``),
the two matched by the batch's ``(epoch, index)``; a copy that began
before its batch was ready counts 0. About 0: the loader sets the pace;
large: the step does."""

from benchmarks import spans


def read(run):
    copies = spans.starting_in("batch.copy", *spans.measured_window(run),
                               main=True)
    if copies is None:
        return None
    ready = {}
    for s in spans.recorder().spans():
        if s.name in ("batch.assemble", "batch.gan_inputs") and \
                s.batch is not None:
            ready[s.batch] = max(ready.get(s.batch, 0), s.end_ns)
    waits = [max(0, c.start_ns - ready[c.batch]) for c in copies
             if c.batch in ready]
    if not waits:
        return None
    return sum(waits) / len(waits) / 1e6
