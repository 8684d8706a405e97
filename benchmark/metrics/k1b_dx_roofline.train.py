"""Least time of the step's 17 input-gradient convs, counted from the
shapes, over the device time of K1b's dx kernels, in percent."""
from benchmark import readers
from benchmark.trace import is_dx


def read(run):
    return readers.roofline_percent(run, "dx_least_s_per_step", is_dx)
