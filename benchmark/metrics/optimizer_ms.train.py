"""Device ms of the training step's optimizer (span
``train_step.optimizer``: zero-filled unused leaves, clipping, Adam) per
step (span ``train_step``)."""
from benchmark import spans


def read(run):
    return spans.per_root("train_step", "train_step.optimizer")
