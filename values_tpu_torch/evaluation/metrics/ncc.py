"""Ambiguity modeling: normalized cross correlation between the rater-
variance GT uncertainty map and the predicted map.

The port's counterpart of ``values_tpu/evaluation/metrics/ncc.py``
(:14-38; reference: evaluation/metrics/ncc.py:9-44): NCC =
sum((gt - mu_gt)(pred - mu_pred)) / (N sigma_gt sigma_pred) with ddof = 1
standard deviations. A zero variance gives NaN, which ``json.dump``
writes, as the JAX package and the reference do (ROADMAP.md, Queue 3,
R3).
"""
from __future__ import annotations

import json

import numpy as np

from ..experiment_dataloader import ExperimentDataloader


def compute_ncc(gt_unc_map: np.ndarray, pred_unc_map: np.ndarray) -> float:
    mu_gt = np.mean(gt_unc_map)
    mu_pred = np.mean(pred_unc_map)
    sigma_gt = np.std(gt_unc_map, ddof=1)
    sigma_pred = np.std(pred_unc_map, ddof=1)
    prod = np.sum((gt_unc_map - mu_gt) * (pred_unc_map - mu_pred))
    return float((1 / (np.size(gt_unc_map) * sigma_gt * sigma_pred)) * prod)


def main(exp_dataloader: ExperimentDataloader) -> None:
    ncc_dict = {"mean": {}}
    for unc_type in exp_dataloader.exp_version.unc_types:
        nccs_unc = []
        for image_id in exp_dataloader.image_ids:
            ncc_dict.setdefault(image_id, {})
            gt_unc_map = exp_dataloader.get_gt_unc_map(image_id)
            pred_unc_map = exp_dataloader.get_unc_map(image_id, unc_type)
            ncc = compute_ncc(gt_unc_map, pred_unc_map)
            ncc_dict[image_id][unc_type] = {"metrics": {"ncc": ncc}}
            nccs_unc.append(ncc)
        ncc_dict["mean"][unc_type] = {
            "metrics": {"ncc": float(np.mean(nccs_unc))}}
    with open(exp_dataloader.dataset_path / "ambiguity_modeling.json",
              "w") as f:
        json.dump(ncc_dict, f, indent=2)
