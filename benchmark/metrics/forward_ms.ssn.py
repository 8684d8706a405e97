"""Device ms of the SSN member's trunk and heads (spans ``test2d.forward``:
the image to its low-rank normal) per tested batch (span
``test2d.batch``)."""
from benchmark import spans


def read(run):
    return spans.per_root("test2d.batch", "test2d.forward")
