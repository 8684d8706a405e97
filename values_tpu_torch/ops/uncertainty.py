"""C2 uncertainty measures over a stack of softmax samples.

Counterpart of ``values_tpu/ops/uncertainty.py:32-95`` (reference:
test_3D.py:486-534):

- PE = -sum_c guard(m_c log m_c), m the mean softmax over samples;
- EE = mean_s [-sum_c guard(p_sc log p_sc)];
- MI = PE - EE;
- guard: where ``p log p`` is NaN (p == 0: 0 * -inf) the term is 0;
- non-SSN models report aleatoric = EE, epistemic = MI; SSN swaps them.

The one-pass kernel form of :func:`fused_sample_statistics` is
:func:`values_tpu_torch.ops.kernels.entropy.fused_entropy`.
:func:`aleatoric_softmax_samples` is the C1 step of the aleatoric
predictors that keep every sample (test_3D.py:458-469).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def _guarded_plogp(p: torch.Tensor) -> torch.Tensor:
    val = p * torch.log(p)
    return torch.where(torch.isnan(val), torch.zeros_like(val), val)


def entropy(p: torch.Tensor, class_axis: int = 0) -> torch.Tensor:
    """-sum_c guard(p log p) along ``class_axis``."""
    return -torch.sum(_guarded_plogp(p), dim=class_axis)


def fused_sample_statistics(softmax_preds: torch.Tensor,
                            class_axis: int = 1) -> Dict[str, torch.Tensor]:
    """Mean softmax, PE, EE and MI over the leading sample axis;
    ``class_axis`` indexes the classes of ``softmax_preds``."""
    mean_softmax = torch.mean(softmax_preds, dim=0)
    mean_class_axis = class_axis - 1 if class_axis > 0 else class_axis
    pe = entropy(mean_softmax, class_axis=mean_class_axis)
    ee = torch.mean(entropy(softmax_preds, class_axis=class_axis), dim=0)
    return {"mean_softmax": mean_softmax, "pred_entropy": pe,
            "expected_entropy": ee, "mutual_information": pe - ee}


def uncertainty_measures(softmax_preds: torch.Tensor,
                         ssn: bool = False) -> Dict[str, torch.Tensor]:
    """PE / aleatoric / epistemic maps of an (N, C, *spatial) stack."""
    stats = fused_sample_statistics(softmax_preds, class_axis=1)
    ee, mi = stats["expected_entropy"], stats["mutual_information"]
    return {"pred_entropy": stats["pred_entropy"],
            "aleatoric_uncertainty": mi if ssn else ee,
            "epistemic_uncertainty": ee if ssn else mi}


def aleatoric_softmax_samples(mu: torch.Tensor, s: torch.Tensor,
                              eps: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The aleatoric predictors' samples, given their normals: mu and s
    (M, B, *spatial, C), eps (M, S, B, *spatial, C) -> the softmax of
    ``mu + exp(s/2) * eps`` over C and ``exp(s/2)`` repeated for each
    sample, both (M*S, B, *spatial, C), member-major
    (``values_tpu/inference/predictors.py:122-143``; the reference keeps
    one sigma per member for every sample)."""
    sigma = torch.exp(s / 2.0)
    probs = torch.softmax(mu[:, None] + sigma[:, None] * eps, dim=-1)
    sigmas = sigma[:, None].expand_as(probs)
    return probs.flatten(0, 1), sigmas.flatten(0, 1)
