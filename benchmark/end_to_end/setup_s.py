"""Seconds from the process's start to the window: imports, the card,
weights and inputs made from the seed, the program's objects, the
warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
