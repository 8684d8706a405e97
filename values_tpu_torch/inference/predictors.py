"""C1 prediction models: the S forward passes of a chunk of windows as one
(S, B, *spatial, C) softmax stack.

The port's counterpart of ``values_tpu/inference/predictors.py`` (:39-308;
reference: test_3D.py:399-483) for the ``default`` and ``aleatoric``
modes. A predictor is ``predict(weights, x, generator)`` -> (softmax
stack, sigma stack or None), ``weights`` the grouped tree of the M
members (:func:`~values_tpu_torch.models.ensemble_unet3d.cast_weights`
layout):

- ``default``: each member's softmax, member-major (test_3D.py:424, :470);
- ``aleatoric``: one (mu, s) head per member, then ``n_aleatoric_samples``
  softmaxes of ``mu + exp(s/2) eps`` each (test_3D.py:458-469), the
  normals drawn from the explicit ``torch.Generator``.

Both run the M members as M channel groups of one fused forward
(:func:`~values_tpu_torch.models.ensemble_unet3d.
make_grouped_ensemble_predictor`, ``..._aleatoric_predictor``; K1 on the
card), M = 1 included: where the JAX package picks between a vmapped flax
apply and its grouped Pallas forward, the port has the one lowering. The
``tta`` and ``ssn`` modes and stochastic passes (``n_pred > 1``) are
ROADMAP.md Queue 1's "The MC-dropout, TTA and SSN scorers" and raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Callable

from ..models.ensemble_unet3d import (make_grouped_aleatoric_predictor,
                                      make_grouped_ensemble_predictor)

# the ROADMAP.md item that ports the other C1 modes
SCORERS = "The MC-dropout, TTA and SSN scorers"


def not_ported(what: str, item: str = SCORERS) -> NotImplementedError:
    """The refusal of a C1 mode or option that ROADMAP.md's Queue 1
    ``item`` ports."""
    return NotImplementedError(
        f"{what} is not ported to values_tpu_torch yet (ROADMAP.md, Queue 1: "
        f"{item!r})")


def total_passes(mode: str, n_models: int, n_pred: int,
                 n_aleatoric_samples: int) -> int:
    """The stochastic-pass count S of a C1 mode."""
    if mode in ("tta", "ssn"):
        raise not_ported(f"the {mode!r} prediction mode")
    if mode not in ("default", "aleatoric"):
        raise ValueError(f"Unknown C1 prediction mode: {mode}")
    if n_pred > 1:
        raise not_ported("stochastic passes (n_pred > 1)")
    return n_models * (n_aleatoric_samples if mode == "aleatoric" else 1)


def make_predictor(mode: str, n_models: int, n_pred: int = 1,
                   n_aleatoric_samples: int = 10) -> Callable:
    """The predictor of a C1 mode (``:284-308``)."""
    total_passes(mode, n_models, n_pred, n_aleatoric_samples)
    if mode == "aleatoric":
        return make_grouped_aleatoric_predictor(n_models,
                                                n_aleatoric_samples)
    return make_grouped_ensemble_predictor(n_models)
