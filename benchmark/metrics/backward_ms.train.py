"""Device ms of the training step's backward (span ``train_step.backward``:
K1b's dx, cuDNN's dW) per step (span ``train_step``)."""
from benchmark import spans


def read(run):
    return spans.per_root("train_step", "train_step.backward")
