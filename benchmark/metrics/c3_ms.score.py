"""Device ms of the scorer's C3 (span ``score.c3``: argmax, Dice and the
three aggregations) per scored batch (span ``score``)."""
from benchmark import spans


def read(run):
    return spans.per_root("score", "score.c3")
