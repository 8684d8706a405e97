"""Joint deep-ensemble training: M members in one step.

The port's counterpart of ``values_tpu/training/ensemble.py`` (:56-227).
The reference trains each member as its own run with its own ``seed``
(reference: uncertainty_modeling/main.py; test_3D.py:424 then loads the M
checkpoints). Here the M members train together in one grouped forward
and backward: member m's weights are channel group m of every grouped
conv (:func:`~values_tpu_torch.models.ensemble_unet3d.
group_member_variables`), and member m's own batch rides in input channel
m of :func:`~values_tpu_torch.models.ensemble_unet3d.grouped_forward_train`.
On the card every 3x3x3 conv of the step is K1 forward and K1b backward
at G = M.

The members stay independent:

- grouped convs never mix channel groups, so the sum of the per-member
  losses gives each member the gradient of its own run;
- Adam is elementwise, so member m's update reads only its own gradients;
- member m starts from its own seed (``seed + m``, the reference's
  per-member seed override), sees its own data stream and, with the
  aleatoric objective, draws its normals from its own generator.

:meth:`EnsembleTrainer.save_member_checkpoints` writes one native
checkpoint per member, which ``test_3d --checkpoint_paths`` of either
package reads as a deep ensemble.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..config.instantiate import TARGET_ALIASES
from ..models.ensemble_unet3d import (grouped_forward_train,
                                      group_member_variables,
                                      ungroup_member_variables)
from .checkpoint import save_checkpoint, to_numpy_tree
from .experiment import (Experiment, check_patch_size, tree_leaves,
                         tree_map)
from . import optim

UNET3D = "values_tpu_torch.models.unet3d.UNet3D"


@dataclasses.dataclass
class EnsembleTrainState:
    """``params``: the grouped tree of float32 leaf tensors; the
    optimizer over :func:`tree_leaves` of it; the number of steps taken."""
    params: Dict[str, Dict[str, torch.Tensor]]
    optimizer: torch.optim.Optimizer
    step: int = 0


class EnsembleTrainer:
    """Step-level API for joint deep-ensemble training of the 3D UNet3D
    family (plain or aleatoric head), on ``device`` (the card unless
    ``"cpu"`` is asked for).

    Raises ValueError, as the JAX trainer does, for ``members < 1``, a
    model outside the UNet3D family (SSN and 2D models train per member
    through ``Experiment``) and ``gradient_clip_val`` (the global norm
    would couple the members); a dropout model raises
    NotImplementedError (ROADMAP.md Queue 1, "The MC-dropout, TTA and SSN
    scorers").
    """

    def __init__(self, cfg: Config, members: int, device=None):
        if members < 1:
            raise ValueError(f"members must be >= 1, got {members}")
        target = str(cfg.model.get("_target_", ""))
        if TARGET_ALIASES.get(target, target) != UNET3D:
            raise ValueError(
                "EnsembleTrainer supports the 3D UNet3D family only (got "
                f"{target}); train SSN/2D models per member via Experiment")
        if cfg.get("gradient_clip_val") is not None:
            raise ValueError(
                "gradient_clip_val couples members through the global grad "
                "norm; none of the 3D reference configs set it -- use "
                "per-member Experiment runs if you need clipping")
        self.cfg = cfg
        self.members = int(members)
        # one member's experiment: its config, objective and precision
        self.member = Experiment(cfg, device)
        self.device = self.member.device
        self.optimizer = optim.adam(lr=self.member.learning_rate,
                                    weight_decay=self.member.weight_decay)

    # ------------------------------------------------------------------
    def init_state(self, seed: int, patch_size: int) -> EnsembleTrainState:
        """Member m initialised as ``Experiment.init_state(seed + m)``
        would, then grouped."""
        check_patch_size(patch_size)
        grouped = group_member_variables(
            [self.member.initial_params(seed + m)
             for m in range(self.members)])["params"]
        params = tree_map(
            lambda a: torch.tensor(a, dtype=torch.float32,
                                   device=self.device).requires_grad_(True),
            grouped)
        return EnsembleTrainState(params, self.optimizer(tree_leaves(params)))

    # ------------------------------------------------------------------
    def _member_outputs(self, params, data: torch.Tensor) -> torch.Tensor:
        """data (M, B, D, H, W, Cin) -> the grouped forward's output (M,
        B, D, H, W, C_out), member m's batch in input channel block m."""
        m, b, d, h, w, cin = data.shape
        if m != self.members:
            raise ValueError(f"data holds {m} member batches, the trainer "
                             f"{self.members} members")
        x = data.movedim(0, -2).reshape(b, d, h, w, m * cin)
        params, x = self.member._cast(params, x)
        return grouped_forward_train(params, x, m).movedim(-2, 0)

    def loss(self, params, batch: Dict[str, torch.Tensor],
             generators: Optional[Sequence[torch.Generator]] = None
             ) -> torch.Tensor:
        """Per-member losses (M,): ``batch["data"]`` (M, B, D, H, W, Cin)
        float and ``batch["seg"]`` (M, B, D, H, W) integer hold member m's
        own stream in row m; ``generators[m]`` draws member m's aleatoric
        normals."""
        out = self._member_outputs(params, batch["data"])
        target = batch["seg"].long()
        gens = generators or [None] * self.members
        losses = []
        for m in range(self.members):
            out_m = (tuple(torch.chunk(out[m], 2, dim=-1))
                     if self.member.aleatoric_loss else out[m])
            losses.append(self.member._objective(out_m, target[m], gens[m]))
        return torch.stack(losses)

    def train_step(self, state: EnsembleTrainState,
                   batch: Dict[str, torch.Tensor],
                   generators: Optional[Sequence[torch.Generator]] = None
                   ) -> Tuple[EnsembleTrainState, torch.Tensor]:
        """One joint update of ``state`` in place; returns it and the
        per-member losses (M,)."""
        state.optimizer.zero_grad(set_to_none=True)
        losses = self.loss(state.params, batch, generators)
        losses.sum().backward()
        state.optimizer.step()
        state.step += 1
        return state, losses.detach()

    # ------------------------------------------------------------------
    def member_variables(self, state: EnsembleTrainState) -> List[Dict]:
        """The M flax-layout ``{"params": ...}`` member trees (numpy)."""
        return ungroup_member_variables(to_numpy_tree(state.params),
                                        self.members)

    def save_member_checkpoints(self, state: EnsembleTrainState,
                                ckpt_dir: str, *, epoch: int = 0,
                                extra_hparams: Optional[Dict[str, Any]]
                                = None) -> List[str]:
        """``member_{m}.ckpt`` in the native pickle format for each member,
        its ``hyper_parameters`` the config with ``ensemble_member`` m."""
        hparams = dict(self.cfg.to_container())
        hparams.update(extra_hparams or {})
        os.makedirs(ckpt_dir, exist_ok=True)
        paths = []
        for m, variables in enumerate(self.member_variables(state)):
            path = os.path.join(ckpt_dir, f"member_{m}.ckpt")
            save_checkpoint(path, variables, dict(hparams, ensemble_member=m),
                            epoch=epoch, global_step=state.step)
            paths.append(path)
        return paths
