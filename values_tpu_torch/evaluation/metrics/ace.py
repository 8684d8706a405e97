"""Calibration: Platt scaling (fit on val) and the Adaptive Calibration
Error.

The port's counterpart of ``values_tpu/evaluation/metrics/ace.py``
(:26-142; reference: evaluation/metrics/ace.py:13-143), on the host in
numpy:

- a Platt fit per image on (-uncertainty, rater correctness) pairs, the
  parameters averaged over images -> ``platt_scale_params.json`` on the
  experiment root,
- calibrated confidence = ``1 / (1 + exp(confid * a + b))`` with
  confid = -uncertainty,
- ACE = mean |acc - conf| over the non-empty of 20 equal-width bins
  (bins = linspace(0, 1 + 1e-8, 21)),
- an optional ``ignore_value`` (GTA: 255) masks reference voxels.

The card's machine has no scikit-learn, so :func:`_sigmoid_calibration`
is the port's copy of scikit-learn 1.9.0's (``sklearn/calibration.py``),
with its half-binomial loss (``sklearn/_loss/_loss.pyx.tp``,
``closs_grad_half_binomial``) in numpy.
"""
from __future__ import annotations

import json
import os
from math import log
from typing import Optional, Tuple

import numpy as np
from scipy.optimize import minimize

from ..experiment_dataloader import ExperimentDataloader


def _half_binomial_loss_gradient(y_true: np.ndarray,
                                 raw_prediction: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample loss ``log1p(exp(r)) - y r`` and gradient
    ``expit(r) - y``, taken piecewise as scikit-learn's
    ``HalfBinomialLoss`` takes them (in float64, so no |r| overflows),
    returned in ``raw_prediction``'s dtype. A piece that holds every
    sample (the common case) runs on the whole arrays."""
    y = y_true.astype(np.float64)
    r = raw_prediction.astype(np.float64)
    loss = np.empty_like(r)
    grad = np.empty_like(r)

    def piece(mask, fn):
        if mask.all():
            loss[:], grad[:] = fn(y, r)
        elif mask.any():
            loss[mask], grad[mask] = fn(y[mask], r[mask])

    def low(y, r):
        e = np.exp(r)
        return e - y * r, e - y

    def mid_low(y, r):
        e = np.exp(r)
        return np.log1p(e) - y * r, ((1 - y) * e - y) / (1 + e)

    def mid_high(y, r):
        e = np.exp(-r)
        return np.log1p(e) + (1 - y) * r, ((1 - y) - y * e) / (1 + e)

    def high(y, r):
        e = np.exp(-r)
        return e + (1 - y) * r, ((1 - y) - y * e) / (1 + e)

    piece(r <= -37, low)
    piece((r > -37) & (r <= -2), mid_low)
    piece((r > -2) & (r <= 18), mid_high)
    piece(r > 18, high)
    return (loss.astype(y_true.dtype, copy=False),
            grad.astype(raw_prediction.dtype, copy=False))


def _sigmoid_calibration(predictions, y):
    """Platt's sigmoid fit (Platt 2000), as scikit-learn 1.9.0's
    ``_sigmoid_calibration`` without sample weights: returns (a, b) with
    P(y = 1 | f) = 1 / (1 + exp(a f + b))."""
    predictions = np.asarray(predictions).ravel()
    y = np.asarray(y).ravel()

    F = predictions  # F follows Platt's notations
    scale_constant = 1.0
    max_prediction = np.max(np.abs(F))
    # large predictions are scaled into range; an unpenalized logistic
    # fit is invariant to scaling its feature
    if max_prediction >= 30:
        scale_constant = max_prediction
        F = F / scale_constant

    # Bayesian priors (Platt, end of section 2.2)
    mask_negative_samples = y <= 0
    prior0 = float(np.sum(mask_negative_samples))
    prior1 = y.shape[0] - prior0
    T = np.zeros_like(y, dtype=predictions.dtype)
    T[y > 0] = (prior1 + 1.0) / (prior1 + 2.0)
    T[y <= 0] = 1.0 / (prior0 + 2.0)

    def loss_grad(AB):
        raw_prediction = -(AB[0] * F + AB[1]).astype(dtype=predictions.dtype)
        l, g = _half_binomial_loss_gradient(T, raw_prediction)
        loss = l.sum()
        grad = np.asarray([-g @ F, -g.sum()], dtype=np.float64)
        return loss, grad

    AB0 = np.array([0.0, log((prior0 + 1.0) / (prior1 + 1.0))])
    opt_result = minimize(
        loss_grad, AB0, method="L-BFGS-B", jac=True,
        options={"gtol": 1e-6, "ftol": 64 * np.finfo(float).eps})
    AB_ = opt_result.x
    # the slope back on the input's scale; the offset needs no rescaling
    return AB_[0] / scale_constant, AB_[1]



def _paired_maps(exp_dataloader, image_id: str, unc_type: str):
    reference_segs = exp_dataloader.get_reference_segs(image_id)
    pred_seg = exp_dataloader.get_mean_pred_seg(image_id)
    unc_map = exp_dataloader.get_unc_map(image_id, unc_type)
    if pred_seg.shape != unc_map.shape:
        unc_map = np.swapaxes(unc_map, 0, 1)
    pred_seg = np.repeat(pred_seg[np.newaxis], reference_segs.shape[0], 0)
    unc_map = np.repeat(unc_map[np.newaxis], reference_segs.shape[0], 0)
    rater_correct = (reference_segs == pred_seg).astype(int)
    return reference_segs, unc_map, rater_correct


def platt_scale_params(val_exp_dataloader: ExperimentDataloader,
                       ignore_value: Optional[int] = None) -> None:
    ps_params_dict = {}
    for unc_type in val_exp_dataloader.exp_version.unc_types:
        ps_params_dict[unc_type] = {"a": [], "b": []}
        for image_id in val_exp_dataloader.image_ids:
            refs, unc_map, rater_correct = _paired_maps(
                val_exp_dataloader, image_id, unc_type)
            if ignore_value is not None:
                mask = refs != ignore_value
                a, b = _sigmoid_calibration(-unc_map[mask],
                                            rater_correct[mask])
            else:
                a, b = _sigmoid_calibration(
                    -unc_map.flatten(), np.array(rater_correct).flatten())
            ps_params_dict[unc_type]["a"].append(a)
            ps_params_dict[unc_type]["b"].append(b)
        ps_params_dict[unc_type]["a"] = float(np.mean(
            ps_params_dict[unc_type]["a"]))
        ps_params_dict[unc_type]["b"] = float(np.mean(
            ps_params_dict[unc_type]["b"]))
    with open(val_exp_dataloader.exp_version.exp_path /
              "platt_scale_params.json", "w") as f:
        json.dump(ps_params_dict, f, indent=2)


def platt_scale_confid(uncalib_confid: np.ndarray, platt_scale_file,
                       uncertainty: str) -> np.ndarray:
    with open(platt_scale_file) as f:
        params_dict = json.load(f)
    params = params_dict[uncertainty]
    return 1 / (1 + np.exp(uncalib_confid * params["a"] + params["b"]))


def calib_stats(correct: np.ndarray, calib_confids: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    n_bins = 20
    y_true = np.asarray(correct).ravel()
    y_prob = np.asarray(calib_confids).ravel()
    if y_prob.min() < 0 or y_prob.max() > 1:
        raise ValueError("y_prob has values outside [0, 1]")
    labels = np.unique(y_true)
    if len(labels) > 2:
        raise ValueError("Only binary classification is supported. "
                         f"Provided labels {labels}.")
    # scikit-learn's label_binarize(...)[:, 0]: 1 where y == labels[-1]
    # for two labels; all zero for the single label 0, all one for 1
    if len(labels) == 2:
        y_true = (y_true == labels[1]).astype(int)
    else:
        y_true = (y_true == labels[0]).astype(int) * int(labels[0] != 0)

    bins = np.linspace(0.0, 1.0 + 1e-8, n_bins + 1)
    binids = np.digitize(y_prob, bins) - 1
    bin_sums = np.bincount(binids, weights=y_prob, minlength=len(bins))
    bin_true = np.bincount(binids, weights=y_true, minlength=len(bins))
    bin_total = np.bincount(binids, minlength=len(bins))
    nonzero = bin_total != 0
    num_nonzero = int(nonzero.sum())
    prob_true = bin_true[nonzero] / bin_total[nonzero]
    prob_pred = bin_sums[nonzero] / bin_total[nonzero]
    prob_total = bin_total[nonzero] / bin_total.sum()
    return np.abs(prob_true - prob_pred), prob_total, num_nonzero


def calc_ace(correct: np.ndarray, calib_confids: np.ndarray) -> float:
    bin_discrepancies, _, num_nonzero = calib_stats(correct, calib_confids)
    return float((1 / num_nonzero) * np.sum(bin_discrepancies))


def calibration_error(exp_dataloader: ExperimentDataloader,
                      ignore_value: Optional[int] = None) -> None:
    calib_dict = {"mean": {}}
    platt_scale_file = (exp_dataloader.exp_version.exp_path /
                        "platt_scale_params.json")
    for unc_type in exp_dataloader.exp_version.unc_types:
        aces_unc = []
        for image_id in exp_dataloader.image_ids:
            calib_dict.setdefault(image_id, {})
            refs, unc_map, rater_correct = _paired_maps(
                exp_dataloader, image_id, unc_type)
            if ignore_value is not None:
                mask = refs != ignore_value
                confids = platt_scale_confid(
                    -unc_map[mask], platt_scale_file, unc_type)
                ace = calc_ace(rater_correct[mask], confids)
            else:
                confids = platt_scale_confid(
                    -unc_map.flatten(), platt_scale_file, unc_type)
                ace = calc_ace(rater_correct.flatten(), confids)
            calib_dict[image_id][unc_type] = {"metrics": {"ace": ace}}
            aces_unc.append(ace)
        calib_dict["mean"][unc_type] = {
            "metrics": {"ace": float(np.mean(aces_unc))}}
    with open(exp_dataloader.dataset_path / "calibration.json", "w") as f:
        json.dump(calib_dict, f, indent=2)


def main(exp_dataloader: ExperimentDataloader,
         ignore_value: Optional[int] = None) -> None:
    platt_file = (exp_dataloader.exp_version.exp_path /
                  "platt_scale_params.json")
    if not os.path.isfile(platt_file):
        val_loader = ExperimentDataloader(exp_dataloader.exp_version, "val")
        platt_scale_params(val_loader, ignore_value=ignore_value)
    calibration_error(exp_dataloader, ignore_value=ignore_value)
