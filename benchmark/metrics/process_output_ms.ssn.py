"""Device ms of the per-image loop (span ``test2d.process_output``: mean
softmax, Dice, GED over the samples, the SSN's uncertainty maps, the label
and colour maps, the copies to the host) per tested batch (span
``test2d.batch``)."""
from benchmark import spans


def read(run):
    return spans.per_root("test2d.batch", "test2d.process_output")
