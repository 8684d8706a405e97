"""Experiment: model initialisation, the optimizer, the train and
validation steps.

The port's counterpart of ``values_tpu/training/experiment.py`` (reference:
uncertainty_modeling/lightning_experiment.py:28-444) with its packed
backend (``train_backend="packed"``, :240-264, :309-330), the only one the
port has: the training forward is
:func:`~values_tpu_torch.models.ensemble_unet3d.train_forward`, whose
every 3x3x3 conv runs K1 forward and K1b backward, and validation runs
the fused inference forward at M=1. Two objectives, chosen as the
reference's ``training_step`` chooses (:239-266):

- aleatoric logit sampling (``aleatoric_loss``): Dice + NLL of the
  logsumexp-averaged log-softmax of N samples ``mu + exp(s/2) eps``;
- otherwise SoftDice(softmax) + CE, or CE with ``ignore_index``.

Parameters are a flax-layout tree of float32 leaf tensors (the JAX
package's tree, so checkpoints carry it unchanged); ``precision=bf16``
casts them and the batch to bfloat16 for the forward and backward, and
the optimizer updates the float32 leaves (``experiment.py:64-68``).
Refused with ``NotImplementedError``: dropout and SSN models (ROADMAP.md
Queue 1, "The MC-dropout, TTA and SSN scorers") and 2D models ("2D").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, instantiate
from ..core.device import resolve_device
from ..models.ensemble_unet3d import (PATCH_MULTIPLE, eval_forward,
                                      train_forward)
from ..models.torch_import import unet3d_params_from_torch
from ..ops import losses as L
from ..ops import metrics as M
from . import optim

@dataclasses.dataclass
class TrainState:
    """``params``: flax-layout tree of float32 leaf tensors; the
    optimizer over :func:`tree_leaves` of it; the number of steps taken."""
    params: Dict[str, Any]
    optimizer: torch.optim.Optimizer
    step: int = 0


def tree_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The leaves of a nested dict in sorted-key order (the optimizer's
    parameter order, so its state_dict is stable)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(tree_leaves(value) if isinstance(value, dict)
                   else [value])
    return out


def tree_map(fn, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _channel_first(x: torch.Tensor) -> torch.Tensor:
    return torch.movedim(x, -1, 1)


def check_patch_size(patch_size: int) -> None:
    if patch_size % PATCH_MULTIPLE:
        raise ValueError(f"patch_size={patch_size} must be a multiple of "
                         f"{PATCH_MULTIPLE} (four 2x pools)")


class Experiment:
    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ignore_index = int(cfg.select("datamodule.ignore_index", 0))
        self.learning_rate = float(cfg.get("learning_rate", 1e-4))
        self.weight_decay = float(cfg.get("weight_decay", 1e-6))
        self.aleatoric_loss = bool(cfg.get("aleatoric_loss") or False)
        self.n_aleatoric_samples = int(cfg.get("n_aleatoric_samples", 10))
        clip = cfg.get("gradient_clip_val")
        self.gradient_clip_val = float(clip) if clip else None
        precision = str(cfg.get("precision", "32")).lower()
        self.mixed_bf16 = precision in ("bf16", "16", "mixed", "bf16-mixed")
        model_kwargs = {}
        if cfg.get("aleatoric_loss") is not None:
            model_kwargs["aleatoric_loss"] = cfg.get("aleatoric_loss")
        # the model is built (and its config checked: dropout, SSN and 2D
        # targets raise) only under a seeded RNG, in init_state
        self._build_model = functools.partial(instantiate, cfg.model,
                                              **model_kwargs)
        with torch.random.fork_rng(devices=[]):
            self.num_classes = self._build_model().final.out_channels
        self.optimizer = self._build_optimizer()
        self.lr_schedule = self._build_lr_schedule()

    def _build_optimizer(self):
        opt_cfg = self.cfg.get("optimizer")
        if opt_cfg:
            return instantiate(opt_cfg)
        return optim.adam(lr=self.learning_rate,
                          weight_decay=self.weight_decay)

    def _build_lr_schedule(self) -> optim.LRSchedule:
        sched_cfg = self.cfg.get("lr_scheduler")
        base_lr = float(self.cfg.select("optimizer.lr", self.learning_rate))
        if sched_cfg:
            return instantiate(sched_cfg)(base_lr)
        return optim.LRSchedule("plateau", base_lr, patience=10,
                                interval="epoch")

    # ------------------------------------------------------------------
    def initial_params(self, seed: int) -> Dict[str, Any]:
        """The reference's torch initialisation of the port's UNet3D,
        under ``torch.manual_seed(seed)`` in a forked RNG, as a flax tree
        of numpy arrays: the heads flax never creates
        (``output_reconstruction_map``, ``final`` beside
        ``final_aleatoric``) are left out."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            model = self._build_model()
        params = unet3d_params_from_torch(model.state_dict())["params"]
        params.pop("output_reconstruction_map", None)
        if "final_aleatoric" in params:
            params.pop("final", None)
        return params

    def init_state(self, seed: int, patch_size: int) -> TrainState:
        """A state of :meth:`initial_params` for ``patch_size`` patches."""
        check_patch_size(patch_size)
        return self.state_from_variables(
            {"params": self.initial_params(seed)})

    def state_from_variables(self, variables: Dict[str, Any]) -> TrainState:
        """A state from flax-layout variables (numpy or tensors), copied
        (the optimizer updates its leaves in place) and contiguous (K1
        takes its weights so)."""
        params = variables["params"] if "params" in variables else variables
        params = tree_map(
            lambda a: torch.tensor(np.ascontiguousarray(a),
                                   dtype=torch.float32, device=self.device
                                   ).requires_grad_(True), params)
        return TrainState(params, self.optimizer(tree_leaves(params)))

    # ------------------------------------------------------------------
    def _cast(self, params, data):
        if not self.mixed_bf16:
            return params, data
        return (tree_map(lambda t: t.to(torch.bfloat16), params),
                data.to(torch.bfloat16))

    def _objective(self, out, target: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """The loss of a forward's output; losses reduce in float32."""
        if self.aleatoric_loss:
            mu, s = (_channel_first(t.to(torch.float32)) for t in out)
            return L.aleatoric_sampling_loss(
                mu, s, target, generator=generator,
                n_samples=self.n_aleatoric_samples)
        return L.dice_ce_loss(_channel_first(out.to(torch.float32)), target,
                              ignore_index=self.ignore_index)

    def loss(self, params, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The training loss of ``batch`` (``data`` (B, D, H, W, 1) float,
        ``seg`` (B, D, H, W) integer, on the experiment's device)."""
        p, data = self._cast(params, batch["data"])
        return self._objective(train_forward(p, data), batch["seg"].long(),
                               generator)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One update of ``state`` in place; returns it and the loss."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(state.params, batch, generator)
        loss.backward()
        if self.gradient_clip_val is not None:
            optim.clip_grads_by_global_norm(tree_leaves(state.params),
                                            self.gradient_clip_val)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    def eval_apply(self, params, data: torch.Tensor):
        """The gradient-free forward of validation: logits, or (mu, s)."""
        with torch.no_grad():
            p, data = self._cast(params, data)
            return eval_forward(p, data)

    @torch.no_grad()
    def val_step(self, params, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        target = batch["seg"].long()
        out = self.eval_apply(params, batch["data"])
        loss = self._objective(out, target, generator)
        scores = out[0] if self.aleatoric_loss else out
        dice = M.dice_score(_channel_first(scores), target,
                            ignore_index=self.ignore_index)
        return {"val_loss": loss, "val_dice": dice}
