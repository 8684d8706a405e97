"""Deterministic seeding.

Counterpart of ``values_tpu/core/seed.py:18-26`` (reference:
uncertainty_modeling/main.py:21-30): :func:`set_seed` seeds python,
numpy and torch; where the JAX package hands out a root ``jax.random``
key, the port hands out a seeded ``torch.Generator``, and where it folds
an index into a key (``jax.random.fold_in``), :func:`fold_seed` folds it
into a seed.
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


def fold_seed(seed: int, index: int) -> int:
    """A seed for stream ``index`` of ``seed``, the port's
    ``jax.random.fold_in``: 63 bits of numpy's SeedSequence of the pair,
    the same on every machine and run."""
    words = np.random.SeedSequence([int(seed) & (2 ** 63 - 1),
                                    int(index)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2 ** 63 - 1)


def draw_seed(generator: torch.Generator) -> int:
    """A 62-bit seed drawn from ``generator`` (on its device)."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))


def fold_generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``fold_seed(seed, index)``."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, index))
