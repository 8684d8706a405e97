"""Share of the profiled window in which no kernel, copy or set ran on the
device, in percent."""
from benchmark import readers


def read(run):
    return readers.idle_percent(run)
