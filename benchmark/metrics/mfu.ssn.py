"""Model operations of the measured window (the trunk and both heads of
the SSN member, counted from the convs' shapes) over the window's seconds
times the chip's TF32 peak, in percent."""
from benchmark import readers


def read(run):
    return readers.mfu_percent(run)
