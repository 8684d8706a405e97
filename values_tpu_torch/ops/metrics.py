"""Micro Dice with torchmetrics' deleted-column ``ignore_index``, NLL,
and the test metrics of ``metrics.json``.

Counterpart of ``values_tpu/ops/metrics.py:41-181``, and of the rater
mean in ``values_tpu/inference/scoring.py:94-107`` (reference:
test_3D.py:250-320): one-hot both label maps, delete the ``ignore_index``
column, then ``2 tp / (2 tp + fp + fn)`` over everything, 0 where the
denominator is 0. :func:`generalized_energy_distance` and
:func:`per_rater_test_metrics` are the sliding-window CLI's per-volume
metrics.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


def dice_stats(pred_labels: torch.Tensor, target_labels: torch.Tensor,
               ignore_index: Optional[int] = None,
               dim: Optional[Sequence[int]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tp, fp, fn) counts, summed over ``dim`` (all dims when None)."""
    pred_labels = pred_labels.long()
    target_labels = target_labels.long()
    agree = pred_labels == target_labels

    def count(mask):
        return (mask.sum() if dim is None else mask.sum(dim=tuple(dim)))

    if ignore_index is None:
        fp = count(~agree)
        return count(agree), fp, fp
    pred_keep = pred_labels != ignore_index
    tgt_keep = target_labels != ignore_index
    return (count(agree & tgt_keep), count(pred_keep & ~agree),
            count(tgt_keep & ~agree))


def dice_from_stats(tp: torch.Tensor, fp: torch.Tensor,
                    fn: torch.Tensor) -> torch.Tensor:
    """``2 tp / (2 tp + fp + fn)``, 0 where the denominator is 0; float64
    for integer counts, else the counts' float type."""
    dtype = torch.float64 if not tp.is_floating_point() else tp.dtype
    tp, fp, fn = (t.to(dtype) for t in (tp, fp, fn))
    denom = 2.0 * tp + fp + fn
    return torch.where(denom > 0, 2.0 * tp / torch.clamp(denom, min=1.0),
                       torch.zeros_like(denom))


def dice_score(preds: torch.Tensor, target: torch.Tensor,
               ignore_index: Optional[int] = None) -> torch.Tensor:
    """Micro Dice over everything (``values_tpu/ops/metrics.py:67-74``).
    ``preds`` are (B, C, ...) float scores, reduced by an argmax over C,
    or integer labels."""
    if preds.is_floating_point():
        preds = torch.argmax(preds, dim=1)
    return dice_from_stats(*dice_stats(preds, target, ignore_index))


def select_class(values: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
    """``values[b, target[b, ...], ...]`` of (B, C, ...) values."""
    return torch.gather(values, 1, target.long().unsqueeze(1)).squeeze(1)


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean negative log likelihood of (B, C, ...) log-probabilities at
    (B, ...) integer targets (``values_tpu/ops/metrics.py:154-161``)."""
    return -torch.mean(select_class(log_probs, target))


def mean_rater_dice(seg: torch.Tensor, gt: torch.Tensor,
                    ignore_index: Optional[int] = 0) -> torch.Tensor:
    """Per-item micro Dice of ``seg`` (B, *sp) against ``gt`` (B, *sp),
    or its mean over raters for ``gt`` (B, R, *sp) — the reference's
    metrics.json semantics. Returns (B,) float32."""
    dims = tuple(range(1, seg.ndim))
    if gt.ndim == seg.ndim + 1:
        dice = torch.stack([
            dice_from_stats(*dice_stats(seg, gt[:, r], ignore_index, dims))
            for r in range(gt.shape[1])]).mean(dim=0)
    else:
        dice = dice_from_stats(*dice_stats(seg, gt, ignore_index, dims))
    return dice.to(torch.float32)


def _pairwise_stats(a: torch.Tensor, b: torch.Tensor,
                    ignore_index: Optional[int]) -> torch.Tensor:
    """(N, M, 3) (tp, fp, fn) of every ordered pair of rows of label
    stacks a (N, V) and b (M, V): the micro Dice over the reference's
    repeat_interleave x tile stacking (test_3D.py:285-320) is that of
    their sums, without N*M copies of the volumes."""
    return torch.stack([torch.stack(dice_stats(row.expand_as(b), b,
                                               ignore_index, dim=(1,)), -1)
                        for row in a])


def pairwise_dice_matrix(a: torch.Tensor, b: torch.Tensor,
                         ignore_index: Optional[int] = None) -> torch.Tensor:
    """(N, M) per-pair micro Dices between label stacks (N, V), (M, V)."""
    stats = _pairwise_stats(a, b, ignore_index)
    return dice_from_stats(stats[..., 0], stats[..., 1], stats[..., 2])


def _pooled_dice(a, b, ignore_index):
    """One micro Dice over all ordered pairs of rows of a and b."""
    tp, fp, fn = _pairwise_stats(a, b, ignore_index).sum(dim=(0, 1))
    return dice_from_stats(tp, fp, fn)


def generalized_energy_distance(pred_softmax: torch.Tensor,
                                ground_truth: torch.Tensor,
                                ignore_index: int = 0,
                                ged_only: bool = False
                                ) -> Dict[str, torch.Tensor]:
    """GED between N predictions (N, C, *spatial) (softmax, or count-
    normalized sums) and M rater maps (M, *spatial); with M > 1 also the
    best Dice of each rater and the mean best Dice of the predictions
    (``values_tpu/ops/metrics.py:96-151``)."""
    n, m = pred_softmax.shape[0], ground_truth.shape[0]
    flat_pred = torch.argmax(pred_softmax, dim=1).reshape(n, -1)
    flat_gt = ground_truth.long().reshape(m, -1)
    dist_gt_pred = 1.0 - _pooled_dice(flat_pred, flat_gt, ignore_index)
    # the reference passes ignore_index to d(pred, pred) only when it is
    # 0, and to d(gt, gt) only when it occurs (test_3D.py:303-319)
    dist_pred_pred = 1.0 - _pooled_dice(
        flat_pred, flat_pred, ignore_index if ignore_index == 0 else None)
    gg_ignore = ignore_index if bool((flat_gt == ignore_index).any()) \
        else None
    dist_gt_gt = 1.0 - _pooled_dice(flat_gt, flat_gt, gg_ignore)
    out = {"ged": 2.0 * dist_gt_pred - dist_pred_pred - dist_gt_gt}
    if m > 1 and not ged_only:
        dice = pairwise_dice_matrix(flat_pred, flat_gt, ignore_index)
        # the reference's running max starts at 0
        per_rater = torch.clamp(dice.max(dim=0).values, min=0.0)
        for idx in range(m):
            out[f"max dice rater {idx}"] = per_rater[idx]
        out["max dice pred"] = torch.clamp(dice.max(dim=1).values,
                                           min=0.0).mean()
    return out


def per_rater_test_metrics(output_softmax: torch.Tensor,
                           ground_truth: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """SoftDice + NLL loss and micro Dice (``ignore_index`` 0) of a (1, C,
    *spatial) softmax against each rater map of (R, *spatial), averaged
    over the raters (``:164-181``; reference: test_3D.py:250-281)."""
    from .losses import soft_dice_loss  # losses imports this module
    losses, dices = [], []
    for rater in range(ground_truth.shape[0]):
        gt = ground_truth[rater][None].long()
        losses.append(soft_dice_loss(output_softmax, gt)
                      + nll_loss(torch.log(output_softmax), gt))
        dices.append(dice_score(output_softmax, gt, ignore_index=0))
    return {"loss": torch.stack(losses).mean(),
            "dice": torch.stack(dices).mean()}
