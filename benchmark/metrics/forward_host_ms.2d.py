"""Host ms of every member's forward (spans ``test2d.forward``) per tested
batch (span ``test2d.batch``): how long the host takes to queue them."""
from benchmark import spans


def read(run):
    return spans.per_root("test2d.batch", "test2d.forward", "host_ms")
