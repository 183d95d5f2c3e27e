"""The mean host time of one batch's assembly (``BatchLoader._assemble``:
decode, native uint8 prep and packing on the loader's threads), on the
host's clock, over the batches whose assembly starts in the window. The
name is the program's: a program that renames it leaves this empty."""


def read(run):
    ms = run.rec.assemble_ms
    if not ms:
        return None
    return sum(ms) / len(ms)
