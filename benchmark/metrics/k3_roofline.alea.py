"""Least time of K3 per scored batch (its operations on the CUDA cores'
float32 peak, counted from the shapes: ``benchmark/counts.py``) over the
device time of K3's kernels in the traced window, in percent."""
from benchmark import counts, readers


def read(run):
    return readers.roofline_percent(run, "k3_least_s_per_step",
                                    counts.is_k3)
