"""Sliding-window enumeration, in numpy.

The port's copy of ``values_tpu/ops/window.py:30-57`` (reference:
toy_datamodule_3D.py:637-665): window start corners with the reference's
stride ``int(patch_size * patch_overlap)``. Extraction and stitching
belong to the sliding-window ``test_3d`` path and are not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


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
