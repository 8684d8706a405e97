"""Device ms of the scorer's ensemble forward (span ``score.forward``,
from the end of the work queued before it to the end of its own) per
scored batch (span ``score``)."""
from benchmark import spans


def read(run):
    return spans.per_root("score", "score.forward")
