"""The training step of the ValUES reference's ``softmax`` objective
(``lightning_experiment.py``, ``loss_modules.py``): SoftDice(softmax) +
cross entropy, then ``torch.optim.Adam``'s rule with L2 weight decay added
to the gradient, written out.

SoftDice: one-hot targets, per (item, class) ``-(2 I + s) / (S + s)``
with s = 1e-5 (I the intersection, S the sum of both), averaged.
Adam: g' = g + wd p; m = b1 m + (1 - b1) g'; v = b2 v + (1 - b2) g'^2;
p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import unet3d


def dice_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """logits (B, C, *sp) float32, target (B, *sp) integer."""
    probs = torch.softmax(logits, dim=1)
    onehot = F.one_hot(target.long(), logits.shape[1]).movedim(-1, 1) \
        .to(probs.dtype)
    axes = tuple(range(2, logits.ndim))
    inter = (probs * onehot).sum(axes)
    total = (probs + onehot).sum(axes)
    dice = -((2 * inter + 1e-5) / (total + 1e-5)).mean()
    return dice + F.cross_entropy(logits, target.long())


class Adam:
    """From zero moments at step 0, or from ``m``, ``v`` after ``t``
    steps."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 m=None, v=None, t: int = 0):
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                        *betas, eps)
        self.m = {k: (torch.zeros_like(p) if m is None
                      else m[k].detach().clone().float())
                  for k, p in params.items()}
        self.v = {k: (torch.zeros_like(p) if v is None
                      else v[k].detach().clone().float())
                  for k, p in params.items()}
        self.t = t

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + self.wd * p
                self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                p -= self.lr * (self.m[k] / c1) / (
                    (self.v[k] / c2).sqrt() + self.eps)


def train_steps(state: Dict[str, torch.Tensor], batches: List,
                lr: float, weight_decay: float, moments=None):
    """Float32 steps of the plain UNet3D from ``state`` over ``batches``
    of (x (B, 1, D, H, W), target (B, D, H, W)), from Adam's first step
    or from ``moments`` = (m, v, steps taken). Returns (losses, the
    first step's gradients with the weight decay added, as Adam takes
    them, the final parameters)."""
    params = {k: v.detach().clone().float() for k, v in state.items()}
    m, v, t = moments or (None, None, 0)
    opt = Adam(params, lr, weight_decay, m=m, v=v, t=t)
    losses, first = [], None
    for x, target in batches:
        leaves = {k: p.detach().clone().requires_grad_(True)
                  for k, p in params.items()}
        loss = dice_ce(unet3d.forward(leaves, x), target)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        if first is None:
            first = {k: g + weight_decay * params[k]
                     for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, params
