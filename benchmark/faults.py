"""Faults planted underneath the timed path, for showing that the output
check fails them: a step that returns its state unchanged (or a call
that returns the previous call's answers), half of the batch left out,
an answer altered where it is produced (a score, a map, a per-image
Dice or GED). Each is a context manager that
patches the program for its duration; the tests and
``calibrate.py --fault`` use them. The benchmark's own runs never do.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict


@contextlib.contextmanager
def _patched(owner, name: str, make: Callable):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def scorer_half_batch():
    """The first half of the batch scored, the rest given its mean (a
    batch of one scored at half its value)."""
    from values_tpu_torch.inference import scoring

    def make(real):
        def half(stats, gt, **kw):
            out = real(stats, gt, **kw)
            keep = max(1, out.shape[1] // 2)
            out[:, keep:] = out[:, :keep].mean(1, keepdim=True)
            if out.shape[1] == 1:
                out[:] = 0.5 * out
            return out
        return half
    return _patched(scoring, "score_from_statistics", make)


def scorer_stale():
    """Each call returns the previous call's scores."""
    from values_tpu_torch.inference import scoring

    def make(real):
        last = []

        def stale(stats, gt, **kw):
            out = real(stats, gt, **kw)
            prev = last[-1] if last else out
            last[:] = [out.clone()]
            return prev.clone()
        return stale
    return _patched(scoring, "score_from_statistics", make)


def scorer_altered():
    """The patch-level scores aggregated over half the patch."""
    from values_tpu_torch.inference import scoring

    def make(real):
        def altered(maps, patch, threshold):
            return real(maps, patch=max(1, patch // 2), threshold=threshold)
        return altered
    return _patched(scoring, "aggregate_all_maps", make)


def train_state_unchanged():
    """The optimizer's step does nothing."""
    import torch
    return _patched(torch.optim.Adam, "step",
                    lambda real: lambda self, closure=None: None)


def train_half_batch():
    """The loss's mean taken over the first half of the batch."""
    from values_tpu_torch.training.experiment import Experiment

    def make(real):
        def half(self, params, batch, generator=None, pretrain=False):
            n = batch["data"].shape[0] // 2
            return real(self, params, {k: v[:n] for k, v in batch.items()},
                        generator, pretrain)
        return half
    return _patched(Experiment, "loss", make)


def train_altered():
    """The loss handed back is 1% off the one the step minimized."""
    from values_tpu_torch.training.experiment import Experiment

    def make(real):
        def altered(self, state, batch, *args, **kw):
            state, loss = real(self, state, batch, *args, **kw)
            return state, loss * 1.01
        return altered
    return _patched(Experiment, "train_step", make)


def tester_half_batch():
    """Only the first half of each batch's images processed."""
    from values_tpu_torch.inference.test_2d import Tester2D

    def make(real):
        def half(self, all_preds, is_ssn):
            n = max(1, len(all_preds["image_id"]) // 2)
            cut = dict(all_preds,
                       softmax_pred=all_preds["softmax_pred"][:, :n],
                       image_id=all_preds["image_id"][:n],
                       gt=all_preds["gt"][:n],
                       dataset=all_preds["dataset"][:n])
            return real(self, cut, is_ssn)
        return half
    return _patched(Tester2D, "process_output", make)


def tester_altered():
    """The aleatoric and epistemic maps swapped where they are made."""
    from values_tpu_torch.ops import uncertainty

    def make(real):
        return lambda preds, ssn=False: real(preds, ssn=not ssn)
    return _patched(uncertainty, "uncertainty_measures", make)


def tester_stale():
    """Each member's forward returns the previous batch's softmax."""
    from values_tpu_torch.inference.test_2d import Tester2D

    def make(real):
        last: Dict[int, object] = {}

        def stale(self, model, x):
            out = real(self, model, x)
            prev = last.get(id(model), out)
            last[id(model)] = out
            return prev
        return stale
    return _patched(Tester2D, "_forward", make)


def tester_dice_no_ignore():
    """The per-image Dice with the ignored pixels counted as a class."""
    from values_tpu_torch.ops import metrics

    def make(real):
        return lambda preds, target, ignore_index=None: real(preds, target)
    return _patched(metrics, "dice_score", make)


def tester_ged_one_member():
    """The per-image GED over the first member's prediction alone."""
    from values_tpu_torch.ops import metrics

    def make(real):
        return lambda preds, gt, **kw: real(preds[:1], gt, **kw)
    return _patched(metrics, "generalized_energy_distance", make)


FAULTS = {"scorer": {"half_batch": scorer_half_batch,
                     "stale": scorer_stale, "altered": scorer_altered},
          "train_step": {"state_unchanged": train_state_unchanged,
                         "half_batch": train_half_batch,
                         "altered": train_altered},
          "tester2d": {"half_batch": tester_half_batch,
                       "altered": tester_altered, "stale": tester_stale,
                       "dice_no_ignore": tester_dice_no_ignore,
                       "ged_one_member": tester_ged_one_member}}
