"""Micro Dice with torchmetrics' deleted-column ``ignore_index``, and NLL.

Counterpart of ``values_tpu/ops/metrics.py:41-74`` and :154-161, and of
the rater mean in ``values_tpu/inference/scoring.py:94-107`` (reference:
test_3D.py:250-281): one-hot both label maps, delete the ``ignore_index``
column, then ``2 tp / (2 tp + fp + fn)`` over everything, 0 where the
denominator is 0.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
