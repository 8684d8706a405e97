"""C1 prediction models: the S forward passes of a chunk of windows as one
(S, B, *spatial, C) softmax stack.

The port's counterpart of ``values_tpu/inference/predictors.py`` (:39-308;
reference: test_3D.py:361-483). A predictor is ``predict(weights, x,
generator)`` -> (softmax stack, sigma stack or None), ``weights`` the
grouped tree of the M members
(:func:`~values_tpu_torch.models.ensemble_unet3d.cast_weights` layout),
the random draws taken from the explicit ``torch.Generator``. Samples are
member-major in every mode:

- ``default``: each member's softmax (test_3D.py:424, :470); with
  ``n_pred`` > 1, ``n_pred`` passes per member, dropout live in each when
  the model has it (the reference never switches to eval mode);
- ``tta``: per member the 16 clean/noisy x flip variants, un-flipped
  (test_3D.py:427-456), dropout live per variant when the model has it;
- ``aleatoric``: one (mu, s) head per member, then
  ``n_aleatoric_samples`` softmaxes of ``mu + exp(s/2) eps`` each
  (test_3D.py:458-469);
- ``ssn``: ``n_pred`` samples of each member's low-rank normal over its
  logits (test_3D.py:361-396).

Every mode runs the M members as M channel groups (K1 at G = M on the
card), M = 1 included: where the JAX package picks between a vmapped flax
apply and its grouped forwards, the port has the one lowering. MC dropout
runs its ``n_pred`` passes one after another at G = M; the JAX engine's
other lowering, one member tiled to G = n_pred (``engine.py:176-191``),
is not ported.
"""
from __future__ import annotations

from typing import Callable

from ..models.ensemble_unet3d import (make_grouped_aleatoric_predictor,
                                      make_grouped_dropout_predictor,
                                      make_grouped_ensemble_predictor,
                                      make_grouped_ssn_predictor,
                                      make_grouped_tta_predictor)

MODES = ("default", "tta", "aleatoric", "ssn")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The refusal of a C1 mode or option that ROADMAP.md's Queue 1
    ``item`` ports."""
    return NotImplementedError(
        f"{what} is not ported to values_tpu_torch yet (ROADMAP.md, Queue 1: "
        f"{item!r})")


def total_passes(mode: str, n_models: int, n_pred: int,
                 n_aleatoric_samples: int) -> int:
    """The stochastic-pass count S of a C1 mode (``:168-178``, with the
    engine's count for several SSN members)."""
    if mode not in MODES:
        raise ValueError(f"Unknown C1 prediction mode: {mode}")
    if mode == "tta":
        return n_models * 16
    if mode == "aleatoric":
        return n_models * n_aleatoric_samples
    return n_models * n_pred


def make_predictor(mode: str, n_models: int, n_pred: int = 1,
                   n_aleatoric_samples: int = 10, do_dropout: bool = False,
                   num_classes: int = 2, rank: int = 10,
                   epsilon: float = 1e-5) -> Callable:
    """The predictor of a C1 mode (``:284-308``). ``do_dropout``: the
    model has dropout; ``num_classes``, ``rank`` and ``epsilon`` are the
    SSN's."""
    total_passes(mode, n_models, n_pred, n_aleatoric_samples)
    if mode == "tta":
        return make_grouped_tta_predictor(n_models, do_dropout)
    if mode == "aleatoric":
        return make_grouped_aleatoric_predictor(n_models,
                                                n_aleatoric_samples)
    if mode == "ssn":
        return make_grouped_ssn_predictor(n_models, num_classes, n_pred,
                                          rank, epsilon)
    if do_dropout or n_pred > 1:
        return make_grouped_dropout_predictor(n_models, n_pred, do_dropout)
    return make_grouped_ensemble_predictor(n_models)
