"""Blocking device-to-host reads (the program's ``readbacks`` counter) per
tested image (its ``images`` counter)."""
from benchmark import spans


def read(run):
    return spans.ratio("test2d.batch", "readbacks", "images")
