"""Least time of the forward's 18 fused 3x3x3 convs, counted from the
batch's shapes, over the device time of K1's forward kernels, in
percent."""
from benchmark import readers


def read(run):
    return readers.roofline_percent(run, "k1_least_s_per_step",
                                    readers.k1_forward)
