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

:func:`make_pass_range_predictor` computes a range of the global pass
axis, each pass's draws from a generator keyed by its global index, for
the mesh's ``sample`` axis (``values_tpu_torch/parallel/mesh.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..core.seed import draw_seed, fold_generator
from ..models.ensemble_unet3d import (draw_dropout_masks, dropout_site_shapes,
                                      grouped_aleatoric_heads,
                                      grouped_forward_train,
                                      grouped_ssn_distributions,
                                      make_grouped_aleatoric_predictor,
                                      make_grouped_dropout_predictor,
                                      make_grouped_ensemble_predictor,
                                      make_grouped_ssn_predictor,
                                      make_grouped_tta_predictor,
                                      member_slice, stack_dtype, tta_inputs)
from ..ops.uncertainty import aleatoric_softmax_samples

MODES = ("default", "tta", "aleatoric", "ssn")


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


def _per_member(mode: str, n_pred: int, n_aleatoric_samples: int) -> int:
    return {"tta": 16, "aleatoric": n_aleatoric_samples}.get(mode, n_pred)


def _member_runs(start: int, n_local: int, per: int) -> Dict[int, List[int]]:
    """The passes [start, start + n_local) of a member-major axis of
    ``per`` passes a member, by their index j within the member: {j:
    [members, ascending and contiguous]}."""
    runs: Dict[int, List[int]] = {}
    for p in range(start, start + n_local):
        runs.setdefault(p % per, []).append(p // per)
    return runs


def make_pass_range_predictor(mode: str, n_models: int, n_pred: int = 1,
                              n_aleatoric_samples: int = 10,
                              do_dropout: bool = False, num_classes: int = 2,
                              rank: int = 10, epsilon: float = 1e-5
                              ) -> Callable:
    """``predict(weights, x, generator, start, n_local)`` -> (stack
    (n_local, B, D, H, W, C), sigma stack or None): passes [start, start +
    n_local) of the global pass axis, member-major as
    :func:`make_predictor` orders it (``values_tpu/inference/predictors.py
    :181-289``). Every draw of pass p comes from a generator seeded with
    ``fold_seed(base, p)``, ``base`` one draw from ``generator`` (taken
    only where the mode draws per pass), so the passes are the same
    whatever range computes them: a mesh's sample axis may split the axis
    anywhere. TTA's noise is one draw a call from ``generator`` before
    ``base``, the same for every range.

    A range may cut a member's passes (TTA's 16, say, over 4 ranks): the
    passes that share their index within the member run as one forward of
    those members' slice of the grouped weights (:func:`member_slice`),
    a smaller group, never member by member. The forwards are
    :func:`make_predictor`'s grouped ones on that slice; only the draws
    are this function's own. They cannot be :func:`make_predictor`'s:
    that one draws a whole stack from one generator in the JAX package's
    key order (which the single-device parity tests replay), so a pass's
    draw depends on every pass before it. For the stochastic modes a
    sample-sharded engine therefore draws other samples of the same
    distribution than the engine without a mesh."""
    per = _per_member(mode, n_pred, n_aleatoric_samples)
    total = total_passes(mode, n_models, n_pred, n_aleatoric_samples)
    draws = mode in ("aleatoric", "ssn") or do_dropout

    def forward(weights, x, ms: List[int], base: Optional[int],
                passes: List[int]) -> torch.Tensor:
        """softmax (g, B, ..., C) of members ``ms`` (one forward at G =
        len(ms)), dropout live with each pass's masks when ``base``."""
        part = member_slice(weights, ms[0], ms[-1] + 1, n_models)
        if base is None:
            return make_grouped_ensemble_predictor(len(ms))(part, x)[0]
        one = member_slice(weights, ms[0], ms[0] + 1, n_models)
        shapes = dropout_site_shapes(one, tuple(x.shape))
        per_pass = [draw_dropout_masks(
            shapes, fold_generator(base, p, x.device), x.device)
            for p in passes]
        masks = [torch.cat(site, dim=-1) for site in zip(*per_pass)]
        with torch.inference_mode():
            logits = grouped_forward_train(part, x, len(ms),
                                           keep_masks=masks)
        probs = torch.softmax(logits.to(stack_dtype(x.dtype)), dim=-1)
        return probs.movedim(-2, 0)

    def predict(weights, x, generator=None, start: int = 0,
                n_local: Optional[int] = None):
        n_local = total - start if n_local is None else n_local
        if start < 0 or n_local < 1 or start + n_local > total:
            raise ValueError(f"passes [{start}, {start + n_local}) are not "
                             f"a range of the {total} passes")
        variants = list(tta_inputs(x, generator)) if mode == "tta" else None
        base = draw_seed(generator) if draws else None
        out: List[Optional[torch.Tensor]] = [None] * n_local
        sig: List[Optional[torch.Tensor]] = [None] * n_local
        lo = start // per
        ms = list(range(lo, (start + n_local - 1) // per + 1))
        if mode == "default" and base is None:
            # deterministic passes: one forward of the range's members
            probs = forward(weights, x, ms, None, [])
            for p in range(start, start + n_local):
                out[p - start] = probs[p // per - lo]
        elif mode in ("default", "tta"):
            for j, run in _member_runs(start, n_local, per).items():
                xv, axes = variants[j] if variants else (x, ())
                passes = [m * per + j for m in run]
                probs = forward(weights, xv, run, base, passes)
                if axes:
                    probs = torch.flip(probs, tuple(a + 1 for a in axes))
                for k, p in enumerate(passes):
                    out[p - start] = probs[k]
        else:
            part = member_slice(weights, ms[0], ms[-1] + 1, n_models)
            if mode == "aleatoric":
                mu, s = grouped_aleatoric_heads(part, x, len(ms))
            else:
                dists = grouped_ssn_distributions(part, x, len(ms),
                                                  num_classes, rank, epsilon)
            b, spatial = x.shape[0], tuple(x.shape[1:4])
            for p in range(start, start + n_local):
                k, gen = p // per - lo, fold_generator(base, p, x.device)
                if mode == "aleatoric":
                    eps = torch.randn(mu.shape[1:], generator=gen,
                                      dtype=mu.dtype, device=mu.device)
                    probs, sigma = aleatoric_softmax_samples(
                        mu[k:k + 1], s[k:k + 1], eps[None, None])
                    out[p - start], sig[p - start] = probs[0], sigma[0]
                else:
                    logits = dists[k].rsample(gen, 1).reshape(
                        (b, num_classes) + spatial).movedim(1, -1)
                    out[p - start] = torch.softmax(logits, dim=-1)
        stack = torch.stack(out)
        return stack, (torch.stack(sig) if mode == "aleatoric" else None)

    return predict
