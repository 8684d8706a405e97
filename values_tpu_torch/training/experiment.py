"""Experiment: model initialisation, the optimizer, the train and
validation steps.

The port's counterpart of ``values_tpu/training/experiment.py`` (reference:
uncertainty_modeling/lightning_experiment.py:28-444) with its packed
backend (``train_backend="packed"``, :188-358), the only one the port
has: the training forward is
:func:`~values_tpu_torch.models.ensemble_unet3d.train_forward` (or
``ssn_train_forward``), whose every 3x3x3 conv runs K1 forward and K1b
backward, and validation runs the fused inference forward at M=1. The
objectives, chosen as the reference's ``training_step`` chooses
(:175-266):

- SSN models: the Monte-Carlo log-likelihood of ``n_aleatoric_samples``
  logit samples of the low-rank normal, its factor zero while
  ``pretrain`` (the first ``pretrain_epochs`` epochs);
- aleatoric logit sampling (``aleatoric_loss``): Dice + NLL of the
  logsumexp-averaged log-softmax of N samples ``mu + exp(s/2) eps``;
- otherwise SoftDice(softmax) + CE, or CE with ``ignore_index``.

A dropout model draws the step's 17 keep masks first, then the SSN
normals or the aleatoric noise, from the step's one generator (the JAX
step's key order). Validation is deterministic: dropout stays off.

Parameters are a flax-layout tree of float32 leaf tensors (the JAX
package's tree, so checkpoints carry it unchanged); ``precision=bf16``
casts them and the batch to bfloat16 for the forward and backward (the
SSN heads run in float32 on the cast weights), and the optimizer updates
the float32 leaves (``experiment.py:64-68``). Every leaf gets a gradient
each step, zero where the step does not use it (the SSN's factor head
while pretraining), as ``jax.grad`` gives one: Adam then decays and
moves that leaf as optax does.

The 2D HRNet (``values_tpu/training/experiment.py``'s ``is_2d`` path,
:113-206) trains the port's :class:`~values_tpu_torch.models.hrnet.
HighResolutionNet` module itself: ``state.params`` is the module (its
float32 parameters and BatchNorm running statistics, channels-last on
the card), the optimizer runs over ``module.parameters()``, and
:meth:`Experiment.variables` gives the flax-layout ``{params,
batch_stats}`` tree that checkpoints carry. A training step runs the
module in training mode (batch statistics, flax's running update: the
JAX ``mutable`` + ``train=True``), draws its dropout masks (live branch
dropouts, DROPOUT_FINAL) and then the SSN's normals from the step's
generator, and reduces CE with ``ignore_index`` (255 on GTA) or the SSN's
log-likelihood in float32; validation runs it in eval mode on the running
statistics. ``precision=bf16`` runs the forward and backward under
``torch.autocast`` to bfloat16 (float32 master weights, BatchNorm
statistics and loss). ``MODEL.PRETRAINED`` naming a local ``.pth`` or
pickle merges those weights in with the reference's filtering; ``true``
is a no-op, as in the JAX package (ImageNet weights would need a
download).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, instantiate
from ..core.device import resolve_device
from ..core.tracing import span
from ..models.ensemble_unet3d import (PATCH_MULTIPLE, draw_keep_masks,
                                      eval_forward, single_member_tree,
                                      ssn_train_forward, train_forward)
from ..models.hrnet import HighResolutionNet
from ..models.ssn_unet3d import LowRankMVN, SsnUNet3D
from ..models.torch_import import (hrnet_params_from_torch,
                                   hrnet_params_to_torch,
                                   merge_pretrained_hrnet,
                                   strip_model_prefix,
                                   unet3d_params_from_torch)
from ..ops import losses as L
from ..ops import metrics as M
from ..parallel.collectives import draw_rows
from . import optim
from .checkpoint import to_numpy_tree

@dataclasses.dataclass
class TrainState:
    """``params``: flax-layout tree of float32 leaf tensors, or the 2D
    HRNet module; the optimizer over :func:`tree_leaves` of the tree or
    the module's parameters; the number of steps taken."""
    params: Any
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
        self.pretrain_epochs = int(cfg.get("pretrain_epochs", 5))
        clip = cfg.get("gradient_clip_val")
        self.gradient_clip_val = float(clip) if clip else None
        precision = str(cfg.get("precision", "32")).lower()
        self.mixed_bf16 = precision in ("bf16", "16", "mixed", "bf16-mixed")
        model_kwargs = {}
        if cfg.get("aleatoric_loss") is not None:
            model_kwargs["aleatoric_loss"] = cfg.get("aleatoric_loss")
        # the model is built (and its config checked: 2D models raise)
        # under a forked RNG here, and seeded in init_state
        self._build_model = functools.partial(instantiate, cfg.model,
                                              **model_kwargs)
        with torch.random.fork_rng(devices=[]):
            model = self._build_model()
        self.is_2d = isinstance(model, HighResolutionNet)
        if self.is_2d and self.aleatoric_loss:
            raise ValueError("aleatoric_loss takes a UNet3D; the HRNet has "
                             "no aleatoric head")
        self.is_ssn = isinstance(model, SsnUNet3D) or (
            self.is_2d and model.ssn)
        self.has_dropout = not self.is_2d and bool(model.do_dropout)
        self.num_classes = int(model.num_classes)
        self.rank = getattr(model, "rank", None)
        self.epsilon = getattr(model, "epsilon", None)
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
        ``final_aleatoric`` or the SSN's heads) are left out."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            model = self._build_model()
        params = unet3d_params_from_torch(model.state_dict())["params"]
        params.pop("output_reconstruction_map", None)
        if "final_aleatoric" in params or self.is_ssn:
            params.pop("final", None)
        return params

    def init_state(self, seed: int, patch_size: int) -> TrainState:
        """A state of :meth:`initial_params` for ``patch_size`` patches."""
        if self.is_2d:
            raise ValueError("a 2D model starts from init_state_2d")
        check_patch_size(patch_size)
        return self.state_from_variables(
            {"params": self.initial_params(seed)})

    def init_state_2d(self, seed: int, height: int, width: int,
                      in_channels: int = 3) -> TrainState:
        """The HRNet's torch initialisation under ``torch.manual_seed(seed)``
        in a forked RNG, merged with ``MODEL.PRETRAINED``'s weights where
        it names a file. The JAX signature: flax initialises from a
        (height, width) sample, torch's initialisation needs none, so
        only ``in_channels`` is checked against the model's."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            model = self._build_model()
        if model.conv1.in_channels != int(in_channels):
            raise ValueError(f"the HRNet takes {model.conv1.in_channels} "
                             f"channels, not {in_channels}")
        variables = hrnet_params_from_torch(model.state_dict())
        return self.state_from_variables(self._merge_pretrained_2d(variables))

    def _merge_pretrained_2d(self, variables: Dict[str, Any]
                             ) -> Dict[str, Any]:
        """``MODEL.PRETRAINED`` naming a torch ``.pth`` (zip) or the JAX
        package's pickle of converted weights: its matching leaves merged
        in (:func:`merge_pretrained_hrnet`). Nothing is fetched."""
        pretrained = self.cfg.select("MODEL.PRETRAINED", None)
        if not isinstance(pretrained, str) or not pretrained:
            return variables
        if not os.path.exists(pretrained):
            raise FileNotFoundError(
                f"MODEL.PRETRAINED={pretrained!r} not found (a local .pth "
                "or pickle of HRNet weights; nothing is downloaded)")
        with open(pretrained, "rb") as f:
            zipped = f.read(2) == b"PK"
        if zipped:
            state = torch.load(pretrained, map_location="cpu",
                               weights_only=True)
            converted = hrnet_params_from_torch(state.get("state_dict",
                                                          state))
        else:
            with open(pretrained, "rb") as f:
                payload = pickle.load(f)
            converted = payload.get("variables", payload)
        return merge_pretrained_hrnet(variables, converted)

    def state_from_variables(self, variables: Dict[str, Any]) -> TrainState:
        """A state from flax-layout variables (numpy or tensors), copied
        (the optimizer updates its leaves in place) and contiguous (K1
        takes its weights so). A 2D model's variables (``params`` and
        ``batch_stats``) load into a fresh module, built on the meta
        device, in training mode."""
        if self.is_2d:
            return self._state_2d(variables)
        params = variables["params"] if "params" in variables else variables
        params = tree_map(
            lambda a: torch.tensor(np.ascontiguousarray(a),
                                   dtype=torch.float32, device=self.device
                                   ).requires_grad_(True), params)
        return TrainState(params, self.optimizer(tree_leaves(params)))

    def _state_2d(self, variables: Dict[str, Any]) -> TrainState:
        with torch.device("meta"):
            model = self._build_model()
        state = hrnet_params_to_torch(
            to_numpy_tree(variables),
            self.cfg.model.to_container()["cfg"])
        model.load_state_dict(strip_model_prefix(state), assign=True)
        model = model.to(device=self.device, dtype=torch.float32).train()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return TrainState(model, self.optimizer(list(model.parameters())))

    def variables(self, state: TrainState) -> Dict[str, Any]:
        """The flax-layout variables of a state, as checkpoints carry
        them: ``{"params"}``, and ``batch_stats`` for the 2D HRNet."""
        if self.is_2d:
            return hrnet_params_from_torch(state.params.state_dict())
        return {"params": state.params}

    def leaves(self, state: TrainState) -> List[torch.Tensor]:
        """The tensors the optimizer updates, in its order."""
        if self.is_2d:
            return list(state.params.parameters())
        return tree_leaves(state.params)

    # ------------------------------------------------------------------
    def _images(self, data: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> the HRNet's (B, C, H, W) (integer images
        as float32), channels-last in memory on the card (cuDNN's
        tensor-core layout)."""
        if not data.is_floating_point():
            data = data.to(torch.float32)
        x = data.permute(0, 3, 1, 2)
        if self.device.type == "cuda":
            return x.contiguous(memory_format=torch.channels_last)
        return x.contiguous()

    def _autocast(self):
        if not self.mixed_bf16:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    @staticmethod
    def _float32(out):
        """The HRNet's output at least in float32 (a bfloat16 run's
        logits, or the SSN's distribution, sampled in float32)."""
        def up(t):
            return t.to(torch.float32) if t.dtype == torch.bfloat16 else t
        if isinstance(out, LowRankMVN):
            return LowRankMVN(up(out.mean), up(out.cov_diag),
                              up(out.cov_factor))
        return up(out)

    def forward_2d(self, model: HighResolutionNet, data: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   pretrain: bool = False):
        """The HRNet on (B, H, W, C) images in its current mode, under
        the run's precision; logits (B, C, H, W) or the SSN's distribution
        (``pretrain``: its mean-only head), float32 after bfloat16."""
        with self._autocast():
            out = model(self._images(data), generator=generator,
                        mean_only=pretrain)
        return self._float32(out)

    def _cast(self, params, data):
        if not self.mixed_bf16:
            return params, data
        return (tree_map(lambda t: t.to(torch.bfloat16), params),
                data.to(torch.bfloat16))

    def _objective(self, out, target: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """The loss of a forward's output (logits, (mu, s) or the SSN's
        distribution); losses reduce in float32."""
        if self.is_ssn:
            return L.ssn_mc_loglikelihood_loss(
                self._logit_samples(out, target.shape, generator), target,
                ignore_index=self.ignore_index)
        if self.aleatoric_loss:
            mu, s = (_channel_first(t.to(torch.float32)) for t in out)
            eps = draw_rows(lambda shape: torch.randn(
                shape, generator=generator, device=mu.device,
                dtype=mu.dtype), (self.n_aleatoric_samples,) + mu.shape,
                dim=1)
            return L.aleatoric_sampling_loss(mu, s, target, eps=eps)
        return L.dice_ce_loss(_channel_first(out.to(torch.float32)), target,
                              ignore_index=self.ignore_index)

    def _logit_samples(self, dist, target_shape,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """``n_aleatoric_samples`` draws of the SSN's distribution (in
        float32) as (S, B, C, *spatial) logits."""
        samples = dist.rsample(generator, self.n_aleatoric_samples)
        return samples.reshape(
            (self.n_aleatoric_samples, target_shape[0], self.num_classes)
            + tuple(target_shape[1:]))

    def forward(self, params, data: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                pretrain: bool = False):
        """The training forward of ``data`` under ``params`` (both already
        in the compute type): a dropout model first draws the step's keep
        masks from ``generator``."""
        masks = (draw_rows(lambda shape: draw_keep_masks(
            single_member_tree(params), shape, generator, data.device),
            data.shape) if self.has_dropout else None)
        if self.is_ssn:
            return ssn_train_forward(params, data, self.num_classes,
                                     self.rank, self.epsilon,
                                     mean_only=pretrain, keep_masks=masks)
        return train_forward(params, data, keep_masks=masks)

    def loss(self, params, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             pretrain: bool = False) -> torch.Tensor:
        """The training loss of ``batch`` (``data`` (B, D, H, W, 1) float,
        ``seg`` (B, D, H, W) integer, on the experiment's device; for
        the 2D HRNet, ``params`` is the module in training mode, ``data``
        (B, H, W, C) and ``seg`` (B, H, W)); ``pretrain``: the SSN's
        mean-only objective."""
        if self.is_2d:
            target = batch["seg"].long()
            out = self.forward_2d(params, batch["data"], generator, pretrain)
            if self.is_ssn:
                return L.ssn_mc_loglikelihood_loss(
                    self._logit_samples(out, target.shape, generator),
                    target, ignore_index=self.ignore_index)
            return L.dice_ce_loss(out, target,
                                  ignore_index=self.ignore_index)
        p, data = self._cast(params, batch["data"])
        return self._objective(self.forward(p, data, generator, pretrain),
                               batch["seg"].long(), generator)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   pretrain: bool = False, reduce_grads=None
                   ) -> Tuple[TrainState, torch.Tensor]:
        """One update of ``state`` in place; returns it and the loss.
        ``reduce_grads(leaves)``: run on the gradients between the
        backward and clipping (the data-parallel step's average,
        :func:`~values_tpu_torch.parallel.mesh.make_parallel_train_step`)."""
        with span("train_step"):
            state.optimizer.zero_grad(set_to_none=True)
            if self.is_2d:
                state.params.train()
            with span("train_step.forward"):
                loss = self.loss(state.params, batch, generator, pretrain)
            with span("train_step.backward"):
                loss.backward()
            with span("train_step.optimizer"):
                leaves = self.leaves(state)
                for leaf in leaves:
                    # unused this step: jax.grad gives 0
                    if leaf.grad is None:
                        leaf.grad = torch.zeros_like(leaf)
                if reduce_grads is not None:
                    reduce_grads(leaves)
                if self.gradient_clip_val is not None:
                    optim.clip_grads_by_global_norm(leaves,
                                                    self.gradient_clip_val)
                state.optimizer.step()
            state.step += 1
            return state, loss.detach()

    def eval_apply(self, params, data: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """The gradient-free, dropout-free forward of validation: logits,
        (mu, s), or the SSN's distribution. The 2D HRNet runs in eval mode
        on its running statistics (DROPOUT_FINAL draws from
        ``generator``), and goes back to training mode."""
        if self.is_2d:
            params.eval()
            try:
                with torch.no_grad():
                    return self.forward_2d(params, data, generator)
            finally:
                params.train()
        with torch.no_grad():
            p, data = self._cast(params, data)
            if self.is_ssn:
                return ssn_train_forward(p, data, self.num_classes,
                                         self.rank, self.epsilon,
                                         trainable=False)
            return eval_forward(p, data)

    @torch.no_grad()
    def val_step(self, params, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        """Loss and micro Dice of a validation batch; the SSN's Dice is the
        mean over its samples' argmax (``val_step``, :332-358)."""
        target = batch["seg"].long()
        out = self.eval_apply(params, batch["data"], generator)
        if self.is_ssn:
            samples = self._logit_samples(out, target.shape, generator)
            loss = L.ssn_mc_loglikelihood_loss(
                samples, target, ignore_index=self.ignore_index)
            dice = torch.stack([
                M.dice_score(labels, target, ignore_index=self.ignore_index)
                for labels in torch.argmax(samples, dim=2)]).mean()
            return {"val_loss": loss, "val_dice": dice}
        if self.is_2d:
            loss = L.dice_ce_loss(out, target,
                                  ignore_index=self.ignore_index)
            return {"val_loss": loss,
                    "val_dice": M.dice_score(
                        out, target, ignore_index=self.ignore_index)}
        loss = self._objective(out, target, generator)
        scores = out[0] if self.aleatoric_loss else out
        dice = M.dice_score(_channel_first(scores), target,
                            ignore_index=self.ignore_index)
        return {"val_loss": loss, "val_dice": dice}
