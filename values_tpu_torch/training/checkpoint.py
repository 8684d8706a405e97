"""Self-describing checkpoints.

The port's counterpart of ``values_tpu/training/checkpoint.py``
(``save_checkpoint`` :29, ``load_checkpoint`` :46, ``_is_torch_zipfile``
:56, ``load_any_checkpoint`` :62, ``CheckpointRetention`` :83-170,
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

The port writes the JAX package's native pickle (:func:`save_checkpoint`):
the flax-layout parameter tree as numpy, the config, epoch and step. The
torch optimizer's state goes under ``torch_optimizer_state``, not the
JAX package's ``opt_state``, so a JAX ``fit`` resuming from a port
checkpoint starts a fresh optax state. Orbax checkpoint directories are a
JAX library's format and raise ``NotImplementedError`` for good; the
message names the JAX package's conversion.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.io import save_pickle
from ..models.torch_import import (load_reference_checkpoint,
                                   require_unet3d, unet3d_params_to_torch)

FORMAT_KEY = "values_tpu_checkpoint"
TORCH_OPTIMIZER_KEY = "torch_optimizer_state"
ORBAX = ("orbax checkpoints are a JAX library's format and stay outside "
         "values_tpu_torch for good, since orbax imports jax (ROADMAP.md, "
         "'Not ported, on purpose'); convert one with the JAX package: "
         "values_tpu.training.checkpoint.load_any_checkpoint, then "
         "save_checkpoint, which writes the pickle format")


def to_numpy_tree(tree: Any) -> Any:
    """Nested dicts, lists and tuples with every tensor as a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    return tree


def to_torch_tree(tree: Any) -> Any:
    """The inverse of :func:`to_numpy_tree`: numpy arrays as tensors."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: to_torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch_tree(v) for v in tree)
    return tree


def save_checkpoint(path: str, variables: Any, hyper_parameters: Dict,
                    epoch: int = 0, global_step: int = 0,
                    torch_optimizer_state: Optional[Dict] = None) -> None:
    """Write the native pickle: ``variables`` (a flax-layout tree of
    tensors or arrays) as numpy, the config, epoch and step, and the
    optimizer's ``state_dict()`` (as numpy) when given."""
    payload = {"format": FORMAT_KEY, "state_dict": to_numpy_tree(variables),
               "hyper_parameters": hyper_parameters, "epoch": epoch,
               "global_step": global_step}
    if torch_optimizer_state is not None:
        payload[TORCH_OPTIMIZER_KEY] = to_numpy_tree(torch_optimizer_state)
    save_pickle(payload, path)


def is_orbax_checkpoint(path: str) -> bool:
    return (Path(path).is_dir()
            and (Path(path) / "values_tpu_meta.pkl").exists())


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The native pickle payload (``state_dict`` as numpy flax trees)."""
    if is_orbax_checkpoint(path):
        raise NotImplementedError(f"{path}: {ORBAX}")
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


class CheckpointRetention:
    """Retention policy around :func:`save_checkpoint` (the JAX package's
    :83-170, pickle format only):

    - ``last.ckpt`` is (re)written at every save;
    - ``every_n_epochs > 0`` also keeps ``epoch=<E>.ckpt`` at that cadence;
    - ``save_top_k > 0`` keeps the k best ``epoch=<E>-<monitor>=<v>.ckpt``
      by the monitored value (lower is better), deleting worse ones.
    """

    def __init__(self, ckpt_dir: str, save_top_k: int = 0,
                 every_n_epochs: int = 0, monitor: str = "val_loss",
                 fmt: str = "pickle"):
        if fmt != "pickle":
            raise NotImplementedError(f"checkpoint_format={fmt!r}: {ORBAX}")
        self.ckpt_dir = Path(ckpt_dir)
        self.save_top_k = int(save_top_k)
        self.every_n_epochs = int(every_n_epochs)
        self.monitor = monitor
        self._best: list = []  # (value, path), ascending

    def save(self, variables: Any, hyper_parameters: Dict, *, epoch: int,
             global_step: int, torch_optimizer_state: Optional[Dict] = None,
             monitored: Optional[float] = None) -> str:
        variables = to_numpy_tree(variables)
        if torch_optimizer_state is not None:
            torch_optimizer_state = to_numpy_tree(torch_optimizer_state)

        def write(name: str) -> str:
            path = str(self.ckpt_dir / name)
            save_checkpoint(path, variables, hyper_parameters, epoch=epoch,
                            global_step=global_step,
                            torch_optimizer_state=torch_optimizer_state)
            return path

        last = write("last.ckpt")
        if self.every_n_epochs > 0 and (epoch + 1) % self.every_n_epochs == 0:
            write(f"epoch={epoch}.ckpt")
        if self.save_top_k > 0 and monitored is not None \
                and np.isfinite(monitored):
            value = float(monitored)
            if len(self._best) < self.save_top_k \
                    or value < self._best[-1][0]:
                path = write(
                    f"epoch={epoch}-{self.monitor}={value:.4f}.ckpt")
                self._best.append((value, path))
                self._best.sort(key=lambda t: t[0])
                while len(self._best) > self.save_top_k:
                    _, worst = self._best.pop()
                    Path(worst).unlink(missing_ok=True)
        return last

    @property
    def best_path(self) -> str:
        return self._best[0][1] if self._best else str(
            self.ckpt_dir / "last.ckpt")
