"""Reading self-describing checkpoints.

The read half of ``values_tpu/training/checkpoint.py`` (``load_checkpoint``
:46, ``_is_torch_zipfile`` :56, ``load_any_checkpoint`` :62,
``is_orbax_checkpoint`` :345). A checkpoint carries the model state and
the complete experiment config (``hyper_parameters``), so inference
rebuilds everything from the file (reference: test_3D.py:635-668). The
port returns the state as a reference-layout ``state_dict`` (``model.``-
prefixed keys), whichever of these formats holds it:

- the JAX package's native pickle (a dict tagged ``FORMAT_KEY`` holding
  numpy flax trees), converted with
  :func:`values_tpu_torch.models.torch_import.unet3d_params_to_torch`;
- a reference Lightning ``.ckpt`` (zip), or a legacy (non-zip) torch
  pickle.

Orbax checkpoint directories are a JAX library's format and raise
``NotImplementedError``; writing checkpoints belongs to the training
slice.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, Tuple

import torch

from ..models.torch_import import (load_reference_checkpoint,
                                   require_unet3d, unet3d_params_to_torch)

FORMAT_KEY = "values_tpu_checkpoint"


def is_orbax_checkpoint(path: str) -> bool:
    return (Path(path).is_dir()
            and (Path(path) / "values_tpu_meta.pkl").exists())


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The native pickle payload (``state_dict`` as numpy flax trees)."""
    if is_orbax_checkpoint(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory; the port does not "
            "read orbax checkpoints yet (ROADMAP.md, Queue 1: \"3D training "
            "with K1b\")")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not (isinstance(payload, dict)
            and payload.get("format") == FORMAT_KEY):
        raise ValueError(f"{path} is not a values_tpu checkpoint")
    return payload


def _is_torch_zipfile(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def load_any_checkpoint(path: str
                        ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """``(hyper_parameters, state_dict)`` of a native or reference
    checkpoint, the state_dict in the reference layout."""
    if not is_orbax_checkpoint(path) and _is_torch_zipfile(path):
        return load_reference_checkpoint(path)
    try:
        payload = load_checkpoint(path)
    except (ValueError, pickle.UnpicklingError):
        # legacy torch pickle (non-zip) checkpoints
        return load_reference_checkpoint(path)
    hparams = payload["hyper_parameters"]
    require_unet3d(hparams, path)
    return hparams, unet3d_params_to_torch(payload["state_dict"])
