"""Share of the tester's softmax passes (the program's ``forwards``
counter) that replayed a captured CUDA graph (its ``graphed_forwards``)."""
from benchmark import spans


def read(run):
    return spans.ratio("test2d.batch", "graphed_forwards", "forwards")
