"""Volumes whose 10 scores reached the host, over the window's seconds."""
from benchmark import readers


def read(run):
    return readers.rate(run)
