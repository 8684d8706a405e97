"""Volumes trained over the window's seconds; each step ends on the host
with its loss."""
from benchmark import readers


def read(run):
    return readers.rate(run)
