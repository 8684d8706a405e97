"""The plain reference the benchmark holds the program's outputs against.

Plain PyTorch only: nothing here imports the program (``values_tpu_torch``)
or the JAX package. Each side is handed the same inputs and weights by
the benchmark; what the program derives from them, the reference works
out again, in float32 (statistics in float64) under :func:`exact`.
"""
import contextlib

import torch


@contextlib.contextmanager
def exact():
    """Convolutions and matrix products in plain float32: TF32 off, and
    cuDNN off, so that a convolution is an im2col product rather than an
    algorithm cuDNN picks by shape (a Winograd or FFT one rounds
    differently from batch to batch)."""
    flags = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.enabled = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
