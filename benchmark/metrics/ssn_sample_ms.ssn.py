"""Device ms of the SSN's sampling (spans ``test2d.ssn_sample``: the
degenerate check, the draws, the low-rank product and the softmax) per
tested batch (span ``test2d.batch``)."""
from benchmark import spans


def read(run):
    return spans.per_root("test2d.batch", "test2d.ssn_sample")
