"""Device ms of every member's forward (spans ``test2d.forward``) per
tested batch (span ``test2d.batch``)."""
from benchmark import spans


def read(run):
    return spans.per_root("test2d.batch", "test2d.forward")
