"""OoD detection: AUROC over aggregated uncertainty scores and the
detection rate within the top-50% acquisition.

The port's counterpart of ``values_tpu/evaluation/metrics/auroc.py``
(:24-103; reference: evaluation/metrics/auroc.py), on the host in numpy.
The toy rule stays the reference's (a numeric id <= 20 is OoD, 21 OoD
samples); LIDC and GTA read the first-cycle splits' unlabeled pools.

The card's machine has no scikit-learn, so :func:`roc_curve` and
:func:`auc` are the port's own, to scikit-learn's contract: the scores
sorted descending (stably), one point per distinct threshold, collinear
points dropped, a leading (0, 0) point, NaN rates where a class is
missing, and the trapezoid area.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from scipy.integrate import trapezoid

from ..experiment_dataloader import ExperimentDataloader
from ..sorting import sort_uncertainties
from ..split_file_generation.second_cycle import (
    get_aggregated_uncertainties, get_samples_to_query,
    get_splits_first_cycle)


def roc_curve(y_true, y_score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``sklearn.metrics.roc_curve`` for labels in {0, 1} (1 positive):
    (fpr, tpr, thresholds). A point collinear with its two neighbours is
    dropped (scikit-learn's default ``drop_intermediate``). A split with
    one class gives NaN rates for the missing one, as scikit-learn does
    (it also warns)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    if not np.isfinite(y_score).all():
        raise ValueError("y_score contains NaN or infinity")
    if not np.isin(np.unique(y_true), (0, 1)).all():
        raise ValueError("y_true takes the labels 0 and 1 only")
    order = np.flip(np.argsort(np.flip(y_score), kind="stable"))
    order = y_score.size - 1 - order
    y_score = y_score[order]
    positive = (y_true[order] == 1).astype(np.float64)
    threshold_idxs = np.r_[np.flatnonzero(np.diff(y_score)),
                           y_true.size - 1]
    tps = np.cumsum(positive, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    thresholds = y_score[threshold_idxs]
    if fps.shape[0] > 2:
        keep = np.flatnonzero(np.r_[
            True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = (np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1])
    tpr = (np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1])
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """``sklearn.metrics.auc``: the trapezoid area under a monotonic
    curve."""
    x = np.asarray(x).ravel()
    y = np.asarray(y).ravel()
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area "
                         f"under curve, but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * trapezoid(y, x))


def is_ood_toy(sample: str) -> bool:
    return not int(sample.split(".")[0]) > 20


def is_ood_split(sample, splits, fold: int = 0) -> Optional[bool]:
    id_pool = splits[fold]["id_unlabeled_pool"]
    if len(id_pool) and isinstance(id_pool[0], tuple):
        id_pool = [image[0] for image in id_pool]
    ood_pool = splits[fold]["ood_unlabeled_pool"]
    if len(ood_pool) and isinstance(ood_pool[0], tuple):
        ood_pool = [image[0] for image in ood_pool]
    if sample in id_pool:
        return False
    if sample in ood_pool:
        return True
    print(f"Could not find sample {sample}!")
    return None


def is_ood(sample, splits=None, fold: int = 0):
    if splits is None:
        return is_ood_toy(sample)
    return is_ood_split(sample, splits, fold)


def get_ood_detection_rate(samples_to_query, splits=None,
                           fold: int = 0) -> float:
    samples_to_query = [f"{s.split('.')[0]}.npy" for s in samples_to_query]
    ood = sum(1 for s in samples_to_query
              if is_ood(sample=s, splits=splits, fold=fold))
    if splits is None:
        num_ood_samples = 21  # the reference's toy count (auroc.py:67-73)
    else:
        num_ood_samples = len(splits[fold]["ood_unlabeled_pool"])
    return ood / num_ood_samples


def get_auroc_input(uncertainties, aggregation, splits=None, fold: int = 0):
    y_labels, unc_scores = [], []
    for sample, unc in uncertainties.items():
        sample = f"{sample.split('.')[0]}.npy"
        flag = is_ood(sample=sample, splits=splits, fold=fold)
        if flag is None:
            print(f"Error for sample {sample}!")
            continue
        y_labels.append(1 if flag else 0)
        unc_scores.append(unc[aggregation]["max_score"])
    return y_labels, unc_scores


def ood_detection(exp_dataloader: ExperimentDataloader,
                  base_splits_path=None) -> None:
    base_splits_path = (Path(base_splits_path)
                        if base_splits_path is not None else None)
    shift = exp_dataloader.exp_version.version_params.get("shift")
    fold = exp_dataloader.exp_version.version_params.get("fold", 0)
    ood_det_dict = {"mean": {}}
    for unc, aggregated_unc_path in (
            exp_dataloader.get_aggregated_unc_files_dict().items()):
        ood_det_dict["mean"][unc] = {}
        for aggregation in exp_dataloader.exp_version.aggregations:
            splits = (get_splits_first_cycle(base_splits_path, shift=shift)
                      if base_splits_path is not None else None)
            uncertainties = get_aggregated_uncertainties(aggregated_unc_path)
            sorted_uncertainties = sort_uncertainties(uncertainties,
                                                      aggregation)
            samples_to_query = get_samples_to_query(sorted_uncertainties, 0.5)
            ood_detection_rate = get_ood_detection_rate(
                samples_to_query=samples_to_query, splits=splits, fold=fold)
            y_true, y_score = get_auroc_input(
                uncertainties=uncertainties, aggregation=aggregation,
                splits=splits, fold=fold)
            fpr, tpr, _ = roc_curve(y_true, y_score)
            roc_auc = auc(fpr, tpr)
            ood_det_dict["mean"][unc][aggregation] = {"metrics": {
                "ood_detection_rate": ood_detection_rate,
                "auroc": float(roc_auc)}}
            with open(exp_dataloader.exp_version.exp_path /
                      "ood_detection.json", "w") as f:
                json.dump(ood_det_dict, f, indent=4)
