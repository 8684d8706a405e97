"""The host's kernel launches in the profiled window per volume scored."""
from benchmark import readers


def read(run):
    return readers.launches_per_unit(run)
