"""values_tpu_torch: the PyTorch/CUDA port of values_tpu for NVIDIA Hopper.

The JAX package ``values_tpu`` is the reference; this package mirrors its
module names and public call contracts, imports ``torch`` and never
``jax``. Every TPU kernel on a ported path is a hand-written Hopper
kernel (``ops/kernels``) with a plain PyTorch version beside it that runs
on CPU tensors. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
from .core.device import resolve_device

__all__ = ["resolve_device"]
