"""Model operations of the measured window, counted from the shapes, over
the window's seconds times the chip's peak in the configuration's
precision, in percent."""
from benchmark import readers


def read(run):
    return readers.mfu_percent(run)
