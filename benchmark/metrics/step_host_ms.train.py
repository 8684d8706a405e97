"""Host ms of a training step (span ``train_step``) per step: how long the
host takes to queue one."""
from benchmark import spans


def read(run):
    return spans.per_root("train_step", "train_step", "host_ms")
