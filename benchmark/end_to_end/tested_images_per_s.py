"""Images whose per-image metrics and uncertainty maps reached host memory,
over the window's seconds."""
from benchmark import readers


def read(run):
    return readers.rate(run)
