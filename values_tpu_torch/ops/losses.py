"""Training losses: soft Dice, cross entropy and the reference's combined
objectives.

The port's copy of ``values_tpu/ops/losses.py:27-153`` (reference:
uncertainty_modeling/loss_modules.py:7-94, lightning_experiment.py:175-266):

- :func:`soft_dice_loss`: one-hot targets, per-(batch, class)
  ``-(2 intersect + smooth) / (sum + smooth)``, smooth 1e-5 in both
  nominator and denominator by default;
- :func:`cross_entropy`: ``F.cross_entropy`` semantics on (B, C, ...)
  logits with an optional ``ignore_index`` (mean over kept voxels; of
  the global batch inside a data-parallel step);
- :func:`dice_ce_loss`: SoftDice(softmax) + CE, or plain CE with
  ``ignore_index`` when it is not 0;
- :func:`aleatoric_sampling_loss`: the logit-sampling objective. Its
  normals come from an explicit ``torch.Generator`` or are passed in as
  ``eps``, so a test can feed it the JAX draw (the two libraries' random
  streams differ).

All are differentiable torch functions of channel-first tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import current_shard, global_sum
from .metrics import nll_loss, select_class


def one_hot_channels(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, ...) integer labels -> (B, C, ...) float32 one-hot."""
    return F.one_hot(labels.long(), num_classes).movedim(-1, 1).to(
        torch.float32)


def soft_dice(net_output: torch.Tensor, gt_onehot: torch.Tensor,
              smooth: float = 1.0, smooth_in_nom: float = 1.0,
              only_intersect: bool = False) -> torch.Tensor:
    """Soft Dice over (B, C, *spatial) probabilities and one-hot targets."""
    axes = tuple(range(2, net_output.ndim))
    intersect = torch.sum(net_output * gt_onehot, dim=axes)
    denom = torch.sum(net_output + gt_onehot, dim=axes)
    result = -((2.0 * intersect + smooth_in_nom) / (denom + smooth))
    if only_intersect:
        return result
    return torch.mean(result)


def soft_dice_loss(probs: torch.Tensor, target: torch.Tensor,
                   do_bg: bool = True, smooth: float = 1e-5,
                   smooth_in_nom: bool = True,
                   only_intersect: bool = False) -> torch.Tensor:
    """``SoftDiceLoss.forward``; ``target`` is (B, *spatial) integers."""
    nom_smooth = smooth if smooth_in_nom else 0.0
    gt_onehot = one_hot_channels(target, probs.shape[1]).to(probs.dtype)
    if not do_bg:
        probs = probs[:, 1:]
        gt_onehot = gt_onehot[:, 1:]
    return soft_dice(probs, gt_onehot, smooth, nom_smooth, only_intersect)


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: Optional[int] = None,
                  reduction: str = "mean") -> torch.Tensor:
    """torch-style CE on (B, C, ...) logits and (B, ...) integer targets."""
    target = target.long()
    log_probs = F.log_softmax(logits, dim=1)
    safe_target = target
    if ignore_index is not None:
        safe_target = torch.where(target == ignore_index,
                                  torch.zeros_like(target), target)
    nll = -select_class(log_probs, safe_target)
    if ignore_index is not None:
        mask = (target != ignore_index).to(nll.dtype)
        nll = nll * mask
        if reduction == "mean":
            # in a data-parallel step the global batch's kept voxels,
            # over the data axis's size: the ranks' mean is the
            # single-device loss on the global batch
            shard = current_shard()
            size = 1 if shard is None else shard.size
            count = torch.clamp(global_sum(torch.sum(mask)), min=1.0)
            return torch.sum(nll) / (count / size)
    if reduction == "mean":
        return torch.mean(nll)
    if reduction == "none":
        return nll
    return torch.sum(nll)


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                 ignore_index: int = 0) -> torch.Tensor:
    """SoftDice(softmax) + CE when ``ignore_index`` is 0, plain CE with
    ``ignore_index`` otherwise (the GTA/Cityscapes 255 path)."""
    if ignore_index != 0:
        return cross_entropy(logits, target, ignore_index=ignore_index)
    probs = torch.softmax(logits, dim=1)
    return soft_dice_loss(probs, target) + cross_entropy(logits, target)


def aleatoric_sampling_loss(mu: torch.Tensor, s: torch.Tensor,
                            target: torch.Tensor, *,
                            generator: Optional[torch.Generator] = None,
                            n_samples: int = 10,
                            eps: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The aleatoric logit-sampling objective: sigma = exp(s/2); N logit
    samples mu + sigma*eps with eps (N, *mu.shape) standard normals,
    drawn from ``generator`` unless given; their log-softmaxes averaged
    as logsumexp - log N; Dice(exp(avg)) + NLL(avg)."""
    sigma = torch.exp(s / 2.0)
    if eps is None:
        eps = torch.randn((n_samples,) + tuple(mu.shape), generator=generator,
                          device=mu.device, dtype=mu.dtype)
    n_samples = eps.shape[0]
    samples = mu[None] + sigma[None] * eps
    # the reference's F.log_softmax without dim: dim 1 of its 5D inputs
    log_sample_prob = F.log_softmax(samples, dim=2)
    log_avg = torch.logsumexp(log_sample_prob, dim=0) - math.log(n_samples)
    return (soft_dice_loss(torch.exp(log_avg), target)
            + nll_loss(log_avg, target))


def ssn_mc_loglikelihood_loss(logit_samples: torch.Tensor,
                              target: torch.Tensor,
                              ignore_index: int = 0) -> torch.Tensor:
    """The SSN's Monte-Carlo log-likelihood loss
    (lightning_experiment.py:175-219): ``logit_samples`` (S, B, C,
    *spatial), ``target`` (B, *spatial) integers. Reduced as the JAX
    function orders it: per-voxel log-likelihoods (CE with
    ``ignore_index`` unless it is 0, ignored voxels 0) summed over the
    voxels, then ``logsumexp`` over the samples minus ``log S``, then the
    batch mean, negated."""
    n_samples, batch = logit_samples.shape[:2]
    target_rep = target[None].expand((n_samples,) + tuple(target.shape))
    flat_logits = logit_samples.reshape(n_samples * batch,
                                        logit_samples.shape[2], -1)
    flat_target = target_rep.reshape(n_samples * batch, -1)
    log_prob = -cross_entropy(
        flat_logits, flat_target,
        ignore_index=ignore_index if ignore_index != 0 else None,
        reduction="none").reshape(n_samples, batch, -1)
    loglik = torch.mean(torch.logsumexp(log_prob.sum(dim=-1), dim=0)
                        - math.log(n_samples))
    return -loglik
