"""The uncertainty measures, Dice and aggregations of the ValUES reference
(``test_3D.py``, ``aggregate_uncertainties.py``, torchmetrics' Dice), in
plain float64 torch.

- softmax stacks (S, B, C, *spatial) -> the mean softmax, the predictive
  entropy of the mean (PE), the mean of the samples' entropies (EE) and
  their difference (MI), with 0 log 0 = 0;
- micro Dice with the ``ignore_index`` class's column deleted:
  ``2 tp / (2 tp + fp + fn)`` over every element, 0 when the denominator
  is 0;
- per volume: the largest sum over a 'valid' cube of side ``patch``, the
  sum over the volume, and the mean of the values at or over a threshold
  (their zero sum when none is);
- the generalized energy distance between N predicted and M reference
  label maps, each distance one micro Dice pooled over all ordered pairs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

MAPS = ("pred_entropy", "expected_entropy", "mutual_information")


def entropy(p: torch.Tensor, class_axis: int) -> torch.Tensor:
    return -torch.special.xlogy(p, p).sum(dim=class_axis)


def sample_statistics(probs: torch.Tensor, class_axis: int = 2
                      ) -> Dict[str, torch.Tensor]:
    """Over the leading sample axis of (S, ...) softmax samples."""
    mean = probs.mean(dim=0)
    pe = entropy(mean, class_axis - 1)
    ee = entropy(probs, class_axis).mean(dim=0)
    return {"mean_softmax": mean, "pred_entropy": pe,
            "expected_entropy": ee, "mutual_information": pe - ee}


def dice_counts(pred: torch.Tensor, target: torch.Tensor,
                ignore: Optional[int], dims) -> torch.Tensor:
    """(tp, fp, fn) stacked on the last axis, summed over ``dims``."""
    agree = pred == target
    if ignore is None:
        tp, fp = agree.sum(dims), (~agree).sum(dims)
        return torch.stack([tp, fp, fp], -1).double()
    keep_p, keep_t = pred != ignore, target != ignore
    return torch.stack([(agree & keep_t).sum(dims),
                        (keep_p & ~agree).sum(dims),
                        (keep_t & ~agree).sum(dims)], -1).double()


def dice_from_counts(c: torch.Tensor) -> torch.Tensor:
    tp, fp, fn = c.unbind(-1)
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp(min=1),
                       torch.zeros_like(denom))


def volume_dice(seg: torch.Tensor, raters: torch.Tensor,
                ignore: Optional[int]) -> torch.Tensor:
    """Mean over raters of each volume's Dice: seg (B, *sp), raters (B,
    R, *sp) -> (B,)."""
    dims = tuple(range(1, seg.ndim))
    return torch.stack([dice_from_counts(dice_counts(seg, raters[:, r],
                                                     ignore, dims))
                        for r in range(raters.shape[1])]).mean(0)


def patch_level(unc: torch.Tensor, patch: int) -> torch.Tensor:
    """Largest sum over a 'valid' patch^3 cube of each (B, D, H, W) map."""
    box = F.avg_pool3d(unc[:, None], patch, stride=1) * patch ** 3
    return box.flatten(1).amax(1)


def threshold_mean(unc: torch.Tensor, threshold: float) -> torch.Tensor:
    flat = unc.flatten(1)
    mask = flat >= threshold
    total = torch.where(mask, flat, torch.zeros_like(flat)).sum(1)
    count = mask.sum(1)
    return torch.where(count > 0, total / count.clamp(min=1), total)


def volume_scores(probs: torch.Tensor, raters: torch.Tensor, *,
                  agg_patch: int, threshold: float,
                  ignore_index: int) -> torch.Tensor:
    """(M, B, C, D, H, W) member softmaxes and (B, R, D, H, W) rater maps
    -> the (10, B) scores: Dice, then (patch, image, threshold) of PE, EE
    and MI."""
    stats = sample_statistics(probs, class_axis=2)
    seg = stats["mean_softmax"].argmax(1)
    rows = [volume_dice(seg, raters.long(), ignore_index)]
    for key in MAPS:
        unc = stats[key]
        rows += [patch_level(unc, agg_patch), unc.flatten(1).sum(1),
                 threshold_mean(unc, threshold)]
    return torch.stack(rows)


def pooled_dice(a: torch.Tensor, b: torch.Tensor,
                ignore: Optional[int]) -> torch.Tensor:
    """One micro Dice over all ordered pairs of rows of label stacks a
    (N, V) and b (M, V)."""
    counts = sum(dice_counts(row[None].expand_as(b), b, ignore, (1,)).sum(0)
                 for row in a)
    return dice_from_counts(counts)


def ged_of_labels(p: torch.Tensor, g: torch.Tensor, ignore: int
                  ) -> torch.Tensor:
    """GED of N predicted label maps (N, V) against M rater maps (M, V):
    2 d(pred, gt) - d(pred, pred) - d(gt, gt), d = 1 - Dice, the ignore
    class deleted where the reference deletes it (in d(pred, gt); in
    d(pred, pred) only for class 0; in d(gt, gt) where it occurs)."""
    g = g.long()
    d_pg = 1 - pooled_dice(p, g, ignore)
    d_pp = 1 - pooled_dice(p, p, ignore if ignore == 0 else None)
    d_gg = 1 - pooled_dice(g, g, ignore if bool((g == ignore).any())
                           else None)
    return 2 * d_pg - d_pp - d_gg


def ged(preds: torch.Tensor, raters: torch.Tensor, ignore: int
        ) -> torch.Tensor:
    """GED of N softmax predictions (N, C, H, W), by their argmax, against
    M rater maps (M, H, W)."""
    return ged_of_labels(preds.argmax(1).flatten(1), raters.flatten(1),
                         ignore)
