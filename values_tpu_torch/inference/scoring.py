"""Per-volume scoring of the deep ensemble: only scalars come out.

Counterpart of ``values_tpu/inference/scoring.py`` (``UNC_KEYS``,
``AGG_KEYS``, ``score_rows`` :33-39; ``_score_from_stats`` and
``make_packed_scorer`` :118-165) and of the softmax + statistics step of
``values_tpu/ops/packed_stats.py:72-88``. One call runs the grouped
ensemble forward (K1 for every 3x3x3 conv), the softmax in float32, the
C2 statistics over the members (K2), the argmax and micro Dice against
the ground truth, and the three C3 aggregations of each uncertainty map,
and returns the (10, B) score matrix in :func:`score_rows` order.

This is the scorer of the OoD, failure-detection and active-learning
test beds, which need image-level scores and no per-voxel maps. The
port keeps the JAX scorer's call contract but not its lane layout:
tensors stay NDHWC, and B is any batch size.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Sequence, Tuple, Union

import torch

from ..core.device import resolve_device
from ..models.ensemble_unet3d import cast_weights, grouped_forward_fused
from ..ops.aggregation import UNC_KEYS, aggregate_all_maps
from ..ops.kernels.entropy import fused_entropy
from ..ops.metrics import mean_rater_dice

AGG_KEYS = ("patch_level", "image_level", "threshold")
# four 2x pools: every spatial dim must halve cleanly down to the center
PATCH_MULTIPLE = 16


def score_rows() -> List[str]:
    """Row labels of the (10, B) score matrix."""
    return ["dice"] + [f"{u}/{a}" for u in UNC_KEYS for a in AGG_KEYS]


def ensemble_statistics(logits: torch.Tensor) -> dict:
    """Logits (B, D, H, W, M, C) -> float32 softmax over C, then the C2
    statistics over the M members through K2. Returns ``mean_softmax``
    (C, N) and the PE/EE/MI maps (N,), N = B*D*H*W voxels."""
    m, c = logits.shape[-2:]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    # (N, M, C) channels-last -> an (M, C, N) view; K2 takes strides
    return fused_entropy(probs.reshape(-1, m, c).permute(1, 2, 0))


def score_from_statistics(stats: Mapping[str, torch.Tensor],
                          gt: torch.Tensor, *, agg_patch: int,
                          threshold, ignore_index: int) -> torch.Tensor:
    """K2's statistics of a (B, D, H, W) batch -> (10, B) float32."""
    b = gt.shape[0]
    spatial = gt.shape[-3:]
    seg = torch.argmax(stats["mean_softmax"], dim=0).reshape(b, *spatial)
    rows = [mean_rater_dice(seg, gt, ignore_index)]
    maps = {k: stats[k].to(torch.float32).reshape(b, *spatial)
            for k in UNC_KEYS}
    aggs = aggregate_all_maps(maps, patch=agg_patch, threshold=threshold)
    for key in UNC_KEYS:
        rows.extend(aggs[key][a] for a in AGG_KEYS)
    return torch.stack([r.to(torch.float32) for r in rows])


def make_scorer(members: int, patch: int, *, agg_patch: int = 10,
                threshold: Union[float, Sequence[float]] = 0.3,
                ignore_index: int = 0, dtype: torch.dtype = torch.bfloat16,
                device=None) -> Tuple[Callable, List[str]]:
    """Build the ensemble-entropy scorer.

    Returns ``(score_fn, rows)`` with ``score_fn(grouped_weights,
    volumes, gt) -> (10, B) float32`` on the scorer's device:

    - ``grouped_weights``: from
      :func:`values_tpu_torch.models.torch_import.group_member_state_dicts`;
    - ``volumes``: (B, p, p, p) or (B, p, p, p, 1), any B;
    - ``gt``: integer (B, p, p, p), or (B, R, p, p, p) for R raters, whose
      Dice row is then the mean over raters.

    ``threshold`` is a scalar or a (PE, EE, MI) triple. The forward runs
    in ``dtype``; softmax and statistics run in float32. ``device=None``
    means the CUDA card and raises when there is none.
    """
    device = resolve_device(device)
    if patch % PATCH_MULTIPLE:
        raise ValueError(f"patch={patch} must be a multiple of "
                         f"{PATCH_MULTIPLE} (four 2x pools)")
    if not 1 <= agg_patch <= patch:
        raise ValueError(f"agg_patch={agg_patch} must lie in [1, {patch}]")

    def score(grouped_weights, volumes, gt) -> torch.Tensor:
        volumes = torch.as_tensor(volumes, device=device)
        gt = torch.as_tensor(gt, device=device)
        if volumes.ndim == 4:
            volumes = volumes[..., None]
        if tuple(volumes.shape[1:]) != (patch, patch, patch, 1):
            raise ValueError(f"volumes: shape {tuple(volumes.shape)}, "
                             f"expected (B, {patch}, {patch}, {patch}[, 1])")
        if gt.shape[0] != volumes.shape[0] or gt.ndim not in (4, 5) \
                or tuple(gt.shape[-3:]) != (patch,) * 3:
            raise ValueError(f"gt: shape {tuple(gt.shape)}, expected "
                             f"({volumes.shape[0]}, [R,] {patch}, {patch}, "
                             f"{patch})")
        weights = cast_weights(grouped_weights, dtype, device)
        with torch.no_grad():
            logits = grouped_forward_fused(weights, volumes.to(dtype),
                                           members)
            stats = ensemble_statistics(logits)
            return score_from_statistics(stats, gt, agg_patch=agg_patch,
                                         threshold=threshold,
                                         ignore_index=ignore_index)

    return score, score_rows()
