"""C3 aggregations of an uncertainty map to one score per volume.

Counterpart of ``values_tpu/ops/aggregation.py:29-119`` (reference:
aggregate_uncertainties.py:13-67). The patch-level box filter is three
separable cumulative-sum passes. Every map is aggregated on its own: the
JAX package's ``linear`` option, which derives MI's sums as PE - EE and
loses precision where PE ~ EE, is not ported.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Union

import torch

UNC_KEYS = ("pred_entropy", "expected_entropy", "mutual_information")


def _axis_window_sum(x: torch.Tensor, window: int, axis: int
                     ) -> torch.Tensor:
    """'valid' sliding-window sums along one axis: s[i] = c[i+w-1] -
    c[i-1] with c = cumsum(x) and c[-1] = 0."""
    c = torch.cumsum(x, dim=axis)
    n = x.shape[axis]
    upper = c.narrow(axis, window - 1, n - window + 1)
    lower = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)),
                       c.narrow(axis, 0, n - window)], dim=axis)
    return upper - lower


def box_filter_sum(x: torch.Tensor, window: Sequence[int],
                   spatial_axes: Sequence[int]) -> torch.Tensor:
    """Separable 'valid' box-filter sum over the given axes."""
    for w, axis in zip(window, spatial_axes):
        x = _axis_window_sum(x, int(w), int(axis))
    return x


def patch_level_max(unc: torch.Tensor, patch: int = 10) -> torch.Tensor:
    """Max 'valid' patch^3 box sum per volume: (B, D, H, W) -> (B,)."""
    box = box_filter_sum(unc, (patch,) * 3, (1, 2, 3))
    return box.reshape(box.shape[0], -1).amax(dim=-1)


def image_level_sum(unc: torch.Tensor) -> torch.Tensor:
    return unc.sum(dim=tuple(range(1, unc.ndim)))


def threshold_mean(unc: torch.Tensor, threshold: float) -> torch.Tensor:
    """Mean of the values >= threshold; the (zero) sum when none passes,
    the reference's count==0 quirk."""
    dims = tuple(range(1, unc.ndim))
    mask = unc >= threshold
    total = torch.where(mask, unc, torch.zeros_like(unc)).sum(dim=dims)
    count = mask.sum(dim=dims).to(total.dtype)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0),
                       total)


def aggregate_all(unc: torch.Tensor, patch: int = 10,
                  threshold: float = 0.3) -> Dict[str, torch.Tensor]:
    return {"patch_level": patch_level_max(unc, patch),
            "image_level": image_level_sum(unc),
            "threshold": threshold_mean(unc, threshold)}


def _per_key_thresholds(threshold) -> Sequence[float]:
    """A scalar applies to all three maps; a 3-sequence is keyed by
    UNC_KEYS order (PE, EE, MI)."""
    if isinstance(threshold, (tuple, list)):
        if len(threshold) != len(UNC_KEYS):
            raise ValueError(f"need {len(UNC_KEYS)} thresholds "
                             f"(PE, EE, MI), got {len(threshold)}")
        return tuple(float(t) for t in threshold)
    return (float(threshold),) * len(UNC_KEYS)


def aggregate_all_maps(maps: Mapping[str, torch.Tensor], patch: int = 10,
                       threshold: Union[float, Sequence[float]] = 0.3
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """:func:`aggregate_all` of each of the three C2 maps (B, *spatial):
    ``{key: {patch_level, image_level, threshold}}``."""
    return {k: aggregate_all(maps[k], patch=patch, threshold=t)
            for k, t in zip(UNC_KEYS, _per_key_thresholds(threshold))}
