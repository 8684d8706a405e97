"""Sliding windows: enumeration (numpy), extraction and stitching
(torch).

The port's copy of ``values_tpu/ops/window.py`` (reference:
toy_datamodule_3D.py:637-665, data_carrier_3D.py:99-221): window start
corners with the reference's stride ``int(patch_size * patch_overlap)``;
:func:`extract_windows` gathers windows from a volume on its device;
:func:`stitch_windows` adds windows into a zeroed volume one window
after another, in window order, as the JAX package's sequential scan
does (:76-91), so overlapping windows always add in the same order. It
uses plain slice adds, never ``index_add_``/``scatter_add_``, whose CUDA
atomics add in an order that changes from run to run.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def enumerate_window_starts(image_shape: Sequence[int], patch_size: int,
                            patch_overlap: float = 1.0) -> np.ndarray:
    """All window start corners, (n, 3) int32: axis 2 outermost, axis 0
    innermost, ``start <= dim - patch`` with stride ``int(patch_size *
    patch_overlap)``; an axis shorter than the patch gets the one start
    0."""
    stride = int(patch_size * patch_overlap)
    if stride <= 0:
        raise ValueError("patch_overlap must yield a positive stride")
    axes: List[List[int]] = []
    for dim in image_shape[:3]:
        starts = list(range(0, dim - patch_size + 1, stride))
        axes.append(starts if starts else [0])
    out = [(s0, s1, s2) for s2 in axes[2] for s1 in axes[1]
           for s0 in axes[0]]
    return np.asarray(out, dtype=np.int32)


def window_crop_tuples(starts: np.ndarray, patch_size: int) -> List[Tuple]:
    """((x0, x1), (y0, y1), (z0, z1)) tuples as reference samples store
    them."""
    return [tuple((int(s), int(s) + patch_size) for s in row)
            for row in starts]


def _start_rows(starts) -> List[Tuple[int, int, int]]:
    return [tuple(int(v) for v in row) for row in np.asarray(starts)]


def extract_windows(volume: torch.Tensor, starts, patch_size: int
                    ) -> torch.Tensor:
    """(N, p, p, p[, C]) windows of a (D0, D1, D2[, C]) volume, on its
    device (``values_tpu/ops/window.py:61-73``)."""
    p = patch_size
    return torch.stack([volume[s0:s0 + p, s1:s1 + p, s2:s2 + p]
                        for s0, s1, s2 in _start_rows(starts)])


def stitch_windows(windows: torch.Tensor, starts,
                   out_shape: Sequence[int]) -> torch.Tensor:
    """(N, p, p, p[, C]) windows added into a zeroed ``out_shape`` volume
    of their type and device, in window order (``:76-91``)."""
    out = torch.zeros(tuple(out_shape), dtype=windows.dtype,
                      device=windows.device)
    p = windows.shape[1]
    for i, (s0, s1, s2) in enumerate(_start_rows(starts)):
        out[s0:s0 + p, s1:s1 + p, s2:s2 + p] += windows[i]
    return out


def count_map(starts, patch_size: int, out_shape: Sequence[int],
              weight: Optional[torch.Tensor] = None,
              dtype: torch.dtype = torch.float32,
              device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """Per-voxel number of covering windows (``:94-98``), or with a
    (p, p, p) ``weight`` their summed weight, added in window order."""
    out = torch.zeros(tuple(out_shape[:3]), dtype=dtype, device=device)
    p = patch_size
    for s0, s1, s2 in _start_rows(starts):
        out[s0:s0 + p, s1:s1 + p, s2:s2 + p] += 1 if weight is None \
            else weight
    return out


def gaussian_weight_map(patch_size: int, sigma_scale: float = 0.125,
                        dtype: torch.dtype = torch.float32,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> torch.Tensor:
    """Separable Gaussian importance map (sigma = patch * sigma_scale),
    peak 1, floored at 1e-8 (``:101-109``)."""
    coords = np.arange(patch_size) - (patch_size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * (patch_size * sigma_scale) ** 2))
    w = g[:, None, None] * g[None, :, None] * g[None, None, :]
    w = w / w.max()
    return torch.as_tensor(np.maximum(w, 1e-8), dtype=dtype, device=device)
