"""Device ms of the training step's forward and loss (span
``train_step.forward``) per step (span ``train_step``)."""
from benchmark import spans


def read(run):
    return spans.per_root("train_step", "train_step.forward")
