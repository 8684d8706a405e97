"""Deterministic seeding.

Counterpart of ``values_tpu/core/seed.py:18-26`` (reference:
uncertainty_modeling/main.py:21-30): :func:`set_seed` seeds python,
numpy and torch; where the JAX package hands out a root ``jax.random``
key, the port hands out a seeded ``torch.Generator``.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def make_generator(seed: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with ``seed``."""
    return torch.Generator().manual_seed(int(seed))
