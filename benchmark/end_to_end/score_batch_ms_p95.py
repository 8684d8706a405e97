"""95th percentile (nearest rank) over every batch of the window, each
timed from the host copy of its inputs to its scores on the host, in
milliseconds."""
from benchmark import readers


def read(run):
    return readers.p95_ms(run)
