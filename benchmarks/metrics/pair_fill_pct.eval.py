"""Valid pairs over the pair slots the window's forwards ran, both
regimes: of each batch that ``val_epoch`` kept, its outputs' pair mask
(``evaluation.Probe``), whose width is the rung the ladder chose. What
the ladder wastes on padded slots; the ladder rule's count from the
split is printed beside it."""


def read(run):
    ev = run.ev
    if ev is None or not ev.slots:
        return None
    return 100.0 * ev.valid / ev.slots
