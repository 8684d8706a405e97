"""Threshold finding: two accumulated passes over the validation split.

The port's counterpart of ``values_tpu/evaluation/find_threshold.py``
(:31-111; reference: evaluation/uncertainty_aggregation/
find_threshold.py:11-117), on the host in numpy:

1. foreground quantile = mean over the predicted segs of
   ``1 - foreground/size`` -> ``quantile_analysis.json``,
2. per (pred_model, unc type): the pooled validation maps' quantile at
   the model's foreground quantile -> ``threshold_analysis.json``, with
   the cross-model means (Softmax left out of the aleatoric and
   epistemic means, NaN where no other model is there).

The quantile is numpy's: ``torch.quantile`` refuses inputs above 2^24
elements, which the pooled LIDC validation maps pass (N x 262,144
voxels).
"""
from __future__ import annotations

import json
import os
from itertools import chain
from pathlib import Path
from typing import Dict

import numpy as np

from .experiment_dataloader import ExperimentDataloader, _load_map


def calculate_foreground_quantile_image(image: np.ndarray) -> float:
    foreground = np.count_nonzero(image)
    return 1 - (foreground / image.size)


def get_foreground_quantile(exp_dataloader: ExperimentDataloader) -> Dict:
    quantile_dict = {exp_dataloader.exp_version.pred_model: {}}
    all_quantiles = []
    for image_id in exp_dataloader.image_ids:
        for pred_seg in exp_dataloader.get_pred_segs(image_id):
            all_quantiles.append(
                calculate_foreground_quantile_image(pred_seg))
    quantile_dict[exp_dataloader.exp_version.pred_model][
        exp_dataloader.exp_version.version_name] = all_quantiles
    return quantile_dict


def save_foreground_quantiles(results_dict: Dict, save_path) -> None:
    methods_results_dict = {}
    for method, versions in results_dict.items():
        methods_results_dict[method] = float(np.mean(
            list(chain.from_iterable(versions.values()))))
    if not os.path.isfile(str(save_path)):
        save_path = Path(save_path) / "quantile_analysis.json"
    with open(save_path, "w") as f:
        json.dump(methods_results_dict, f, indent=2)


def threshold_images_paths(exp_dataloader: ExperimentDataloader) -> Dict:
    out = {exp_dataloader.exp_version.pred_model: {
        exp_dataloader.exp_version.version_name: {}}}
    for unc_type in exp_dataloader.exp_version.unc_types:
        unc_dir = exp_dataloader.unc_path_dict[unc_type]
        out[exp_dataloader.exp_version.pred_model][
            exp_dataloader.exp_version.version_name][unc_type] = [
            unc_dir / f"{image_id}{exp_dataloader.exp_version.unc_ending}"
            for image_id in exp_dataloader.image_ids]
    return out


def find_threshold(results_dict: Dict, quantile_path, save_path) -> None:
    if not os.path.isfile(str(quantile_path)):
        quantile_path = Path(quantile_path) / "quantile_analysis.json"
    if not os.path.isfile(str(save_path)):
        save_path = Path(save_path) / "threshold_analysis.json"
    with open(quantile_path) as f:
        all_quantiles = json.load(f)

    pred_model_path_dict: Dict[str, Dict] = {}
    for pred_model, versions in results_dict.items():
        pred_model_path_dict[pred_model] = {}
        for _version, uncs in versions.items():
            for unc, paths in uncs.items():
                pred_model_path_dict[pred_model].setdefault(
                    unc, []).extend(paths)

    threshold_dict: Dict[str, Dict] = {}
    for pred_model, uncs in pred_model_path_dict.items():
        threshold_dict[pred_model] = {}
        for unc, paths in uncs.items():
            unc_images = np.array([_load_map(p) for p in paths])
            threshold = float(np.quantile(unc_images,
                                          all_quantiles[pred_model]))
            threshold_dict[pred_model][
                f"Mean {unc.split('_')[0]} threshold"] = threshold

    all_aleatoric, all_epistemic, all_predictive = [], [], []
    for key, value in threshold_dict.items():
        if key != "Softmax":
            all_aleatoric.append(value["Mean aleatoric threshold"])
            all_epistemic.append(value["Mean epistemic threshold"])
        all_predictive.append(value["Mean predictive threshold"])
    threshold_dict["Mean"] = {
        "Mean aleatoric threshold": float(np.mean(all_aleatoric))
        if all_aleatoric else float("nan"),
        "Mean epistemic threshold": float(np.mean(all_epistemic))
        if all_epistemic else float("nan"),
        "Mean predictive threshold": float(np.mean(all_predictive)),
    }
    with open(save_path, "w") as f:
        json.dump(threshold_dict, f, indent=2)
