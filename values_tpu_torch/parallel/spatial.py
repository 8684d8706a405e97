"""Spatial sharding: a volume's windows over the data axis, assembled
with one all-reduce.

Counterpart of ``values_tpu/parallel/spatial.py``. Each rank runs the C1
forward on its contiguous block of the window list, stitches its windows
into a full-volume partial sum on its device, and one all-reduce over the
data axis assembles the volume: the windows never reach the host, and
each voxel crosses the group once. The engine's ``"window"`` strategy
(``SlidingWindowEngine(mesh=...)``) does the same with zero-weight pad
windows; this module keeps the JAX package's pad-by-repeat form.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.window import extract_windows, stitch_windows
from .collectives import all_reduce_sum
from .mesh import Mesh


def pad_starts_to_shards(starts: np.ndarray, n_shards: int) -> np.ndarray:
    """Pad the window list to a multiple of ``n_shards`` by repeating the
    last window: the duplicates land on the count map too, so the
    count-normalized outputs stay exact (sums and counts scale
    together)."""
    n = starts.shape[0]
    padded = int(np.ceil(n / n_shards) * n_shards)
    if padded == n:
        return starts
    reps = np.repeat(starts[-1:], padded - n, axis=0)
    return np.concatenate([starts, reps], axis=0)


def make_sharded_volume_predictor(predictor: Callable, mesh: Mesh,
                                  patch_size: int,
                                  vol_shape: Tuple[int, int, int],
                                  num_classes: int,
                                  dtype: torch.dtype = torch.float32
                                  ) -> Callable:
    """``fn(weights, volume, starts, generator)`` -> (softmax sums (S,
    *vol, C), counts (*vol)), the window list split over the data axis.
    ``starts`` must already be padded to a multiple of the data axis
    (:func:`pad_starts_to_shards`); ``predictor`` is a C1 predictor of
    :mod:`~values_tpu_torch.inference.predictors`."""
    n_data = mesh.n_data
    out_shape = tuple(vol_shape) + (num_classes,)

    def sharded(weights, volume, starts, generator=None):
        starts = np.asarray(starts)
        if len(starts) % n_data:
            raise ValueError(f"{len(starts)} windows do not divide over "
                             f"{n_data} data ranks; pad them first")
        per = len(starts) // n_data
        mine = starts[mesh.data_index * per:(mesh.data_index + 1) * per]
        windows = extract_windows(volume, mine, patch_size)
        with torch.inference_mode():
            stack, _ = predictor(weights, windows[..., None].to(dtype),
                                 generator)
        sums = torch.stack([stitch_windows(sample, mine, out_shape)
                            for sample in stack])
        counts = stitch_windows(torch.ones(windows.shape,
                                           dtype=torch.float32,
                                           device=windows.device),
                                mine, tuple(vol_shape))
        return (all_reduce_sum(sums, mesh.data_group),
                all_reduce_sum(counts, mesh.data_group))

    return sharded
