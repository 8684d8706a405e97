"""Share of the SSN's samples in the 2D tester (the program's
``ssn_samples`` counter, n_pred x B a member and batch) that the fused
sampling kernels drew (its ``ssn_fused_samples``). None where the program
counted no fused sample: a program without those kernels."""
from benchmark import spans


def read(run):
    return spans.ratio("test2d.batch", "ssn_fused_samples",
                       "ssn_samples") or None
