"""Device selection for the port's entry points.

Counterpart of ``values_tpu/core/platform.py::resolve_interpret``: where
the JAX package picks Pallas interpret mode off the TPU, the port picks
a device. ``None`` means the CUDA card; there is no silent CPU fallback.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; any explicit device (``"cpu"``, ``"cuda:1"``)
    is taken as given. A CUDA device raises when none is present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return device
