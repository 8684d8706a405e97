"""Optimizers and learning-rate schedules, on ``torch.optim``.

The port's counterpart of ``values_tpu/training/optim.py``. The reference
instantiates ``torch.optim.{Adam,SGD,RMSprop}`` and
``torch.optim.lr_scheduler.{PolynomialLR,ReduceLROnPlateau}`` from its
configs (reference: lightning_experiment.py:92-126); the JAX module
rebuilds torch's update rules on optax (its :1-23). Here the factories
build torch's own optimizers under the JAX module's names:

- :func:`adam`, :func:`sgd`, :func:`rmsprop` return a builder
  ``params -> torch.optim.Optimizer`` (the configs name no parameters;
  ``params`` is accepted and ignored, as in the JAX module). torch's
  rules are the JAX module's: Adam and SGD add the weight decay to the
  gradient first; SGD's momentum buffer starts at that gradient (optax's
  ``trace``), Nesterov adds ``momentum * buffer`` to it; RMSprop divides
  by ``sqrt(n) + eps``, eps outside the root;
- :class:`LRSchedule`, :func:`polynomial_lr`, :func:`reduce_lr_on_plateau`
  and :class:`PlateauTracker` are copies: the host applies the learning
  rate between steps through :func:`set_learning_rate`, the polynomial
  one before every step in its closed form ``base (1 - step / total) **
  power`` (not torch's recursive ``PolynomialLR``);
- :func:`clip_grads_by_global_norm` is ``clip_grad_norm_``'s rule.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Iterable, NamedTuple

import torch


def adam(params: Any = None, lr: float = 1e-4, weight_decay: float = 0.0,
         betas=(0.9, 0.999), eps: float = 1e-8, **_ignored) -> Callable:
    """Adam with L2 weight decay added to the gradient (not AdamW)."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=tuple(betas),
                             eps=eps, weight_decay=weight_decay)


def sgd(params: Any = None, lr: float = 0.01, momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False,
        **_ignored) -> Callable:
    return functools.partial(torch.optim.SGD, lr=lr, momentum=momentum,
                             weight_decay=weight_decay, nesterov=nesterov)


def rmsprop(params: Any = None, lr: float = 0.01, alpha: float = 0.99,
            eps: float = 1e-8, weight_decay: float = 0.0,
            **_ignored) -> Callable:
    return functools.partial(torch.optim.RMSprop, lr=lr, alpha=alpha,
                             eps=eps, weight_decay=weight_decay)


class LRSchedule(NamedTuple):
    """Host-applied learning-rate policy."""
    kind: str                      # "polynomial" | "plateau"
    base_lr: float
    total_iters: int = 0
    power: float = 1.0
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4        # torch rel-mode improvement threshold
    interval: str = "step"

    def value(self, step: int) -> float:
        if self.kind == "polynomial":
            frac = min(step, self.total_iters) / max(self.total_iters, 1)
            return self.base_lr * (1.0 - frac) ** self.power
        return self.base_lr


def polynomial_lr(optimizer: Any = None, total_iters: int = 1000,
                  power: float = 1.0,
                  **_ignored) -> Callable[[float], LRSchedule]:
    return lambda base_lr: LRSchedule("polynomial", base_lr,
                                      total_iters=int(total_iters),
                                      power=power, interval="step")


def reduce_lr_on_plateau(optimizer: Any = None, patience: int = 10,
                         factor: float = 0.1, threshold: float = 1e-4,
                         **_ignored) -> Callable[[float], LRSchedule]:
    return lambda base_lr: LRSchedule("plateau", base_lr, factor=factor,
                                      patience=patience,
                                      threshold=float(threshold),
                                      interval="epoch")


class PlateauTracker:
    """Host-side ReduceLROnPlateau state machine with torch's defaults
    (mode min, threshold_mode rel): improvement iff ``metric < best * (1 -
    threshold)``; after ``patience`` epochs without one the rate is
    scaled by ``factor``."""

    def __init__(self, schedule: LRSchedule):
        self.schedule = schedule
        self.best = float("inf")
        self.bad_epochs = 0
        self.lr_scale = 1.0

    def step(self, metric: float) -> float:
        """Record one epoch's monitored value; returns the current rate."""
        s = self.schedule
        if metric < self.best * (1.0 - s.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > s.patience:
                self.lr_scale *= s.factor
                self.bad_epochs = 0
        return s.base_lr * self.lr_scale


def clip_grads_by_global_norm(params: Iterable[torch.Tensor],
                              max_norm: float) -> torch.Tensor:
    """Scale every gradient in place by ``min(max_norm / (total_norm +
    1e-6), 1)``, total_norm being the 2-norm over all of them
    (``clip_grad_norm_``, which PL applies for ``gradient_clip_val``).
    Returns the total norm."""
    return torch.nn.utils.clip_grad_norm_(list(params), max_norm)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
