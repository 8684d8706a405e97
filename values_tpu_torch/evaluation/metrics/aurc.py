"""Failure detection: AURC and E-AURC from the selective risk-coverage
curve.

The port's counterpart of ``values_tpu/evaluation/metrics/aurc.py``
(:21-148; reference: evaluation/metrics/aurc.py:14-153, adapted from
fd-shifts), on the host in numpy: risk = 1 - Dice per image (from
``metrics.json``), confidence = -max_score of the aggregated uncertainty;
the curve drops one sample at a time in ascending-confidence order and
records a point where the confidence changes (ties), with a trailing
zero-coverage point for the drops left over; AURC is the trapezoid area
with per-segment weights, E-AURC that minus the optimal ranking's AURC.
"""
from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

from ..experiment_dataloader import ExperimentDataloader


def rc_curve_stats(risks: np.ndarray, confids: np.ndarray
                   ) -> Tuple[List[float], List[float], List[float]]:
    """Selective risk-coverage curve points, vectorized over sorted
    confidence-group boundaries.

    Semantics (the contract the reference's sequential loop implements,
    evaluation/metrics/aurc.py:14-58): walk samples in ascending-confidence
    order, dropping one at a time; a curve point is recorded after each drop
    that begins a new confidence value, carrying the coverage and mean risk
    of the samples still retained plus a weight counting the drops since the
    previous point. Any drops left over past the final recorded point (ties
    at the top of the confidence range) collapse into a trailing
    zero-coverage point repeating the last selective risk.
    """
    risks = np.asarray(risks, dtype=float)
    confids = np.asarray(confids, dtype=float)
    assert (risks.ndim == 1 and confids.ndim == 1
            and risks.size == confids.size)
    n = risks.size
    order = np.argsort(confids)
    r_sorted = risks[order]
    c_sorted = confids[order]

    total = float(r_sorted.sum())
    coverages = [1.0]
    selective_risks = [total / n]
    weights: List[float] = []
    if n < 2:
        return coverages, selective_risks, weights

    # Drops happen at positions 0..n-2 (the highest-confidence sample is
    # never dropped). Position i records a point iff it starts a new
    # confidence value.
    new_group = np.empty(n - 1, dtype=bool)
    new_group[0] = True
    np.not_equal(c_sorted[1:n - 1], c_sorted[:n - 2], out=new_group[1:])
    pts = np.flatnonzero(new_group)

    retained = n - 1 - pts
    risk_after = total - np.cumsum(r_sorted)[pts]
    coverages += (retained / n).tolist()
    selective_risks += (risk_after / retained).tolist()
    weights += (np.diff(pts, prepend=-1) / n).tolist()

    leftover = (n - 2) - int(pts[-1])
    if leftover > 0:
        coverages.append(0.0)
        selective_risks.append(selective_risks[-1])
        weights.append(leftover / n)
    return coverages, selective_risks, weights


def aurc(risks: np.ndarray, confids: np.ndarray) -> float:
    _, risks_curve, weights = rc_curve_stats(risks, confids)
    return float(sum(
        (risks_curve[i] + risks_curve[i + 1]) * 0.5 * weights[i]
        for i in range(len(weights))))


def eaurc(risks: np.ndarray, confids: np.ndarray) -> float:
    """AURC minus the AURC of the optimal confidence-sorting function."""
    n = len(risks)
    selective_risks = np.sort(risks).cumsum() / np.arange(1, n + 1)
    aurc_opt = selective_risks.sum() / n
    return aurc(risks, confids) - float(aurc_opt)


def _lookup(metrics: dict, image_id: str) -> dict:
    if image_id in metrics:
        return metrics[image_id]
    matches = [k for k in metrics
               if k.split("/")[-1].split(".")[0] == image_id]
    if len(matches) > 1:
        print(f"Found multiple matches for image id {image_id}. "
              f"Using the first match {matches[0]}")
    return metrics[matches[0]]


def get_dice(image_id: str, metrics_file) -> float:
    with open(metrics_file) as f:
        metrics = json.load(f)
    entry = _lookup(metrics, image_id)
    if "dice" not in entry:
        return entry["metrics"]["dice"]
    return entry["dice"]


def get_risk(image_id: str, metrics_file) -> float:
    return 1 - get_dice(image_id, metrics_file)


def get_confid(image_name: str, aggregated_unc_file, aggregation_level: str,
               unc_file_ending: str) -> float:
    with open(aggregated_unc_file) as f:
        unc = json.load(f)
    return -unc[f"{image_name}{unc_file_ending}"][aggregation_level][
        "max_score"]


def get_risks_and_confids(dataset_path, image_ids, unc_type, aggregation,
                          unc_file_ending):
    risks, confids, dices = [], [], []
    for image in image_ids:
        risks.append(get_risk(image, dataset_path / "metrics.json"))
        dices.append(get_dice(image, dataset_path / "metrics.json"))
        confids.append(get_confid(
            image, dataset_path / f"aggregated_{unc_type}.json",
            aggregation, unc_file_ending))
    return risks, confids, dices


def main(exp_dataloader: ExperimentDataloader) -> None:
    results_dict = {"mean": {}}
    for unc_type in exp_dataloader.exp_version.unc_types:
        results_dict["mean"][unc_type] = {}
        for aggregation in exp_dataloader.exp_version.aggregations:
            risks, confids, _ = get_risks_and_confids(
                dataset_path=exp_dataloader.dataset_path,
                image_ids=exp_dataloader.image_ids,
                unc_type=unc_type, aggregation=aggregation,
                unc_file_ending=exp_dataloader.exp_version.unc_ending)
            results_dict["mean"][unc_type][aggregation] = {"metrics": {
                "aurc": aurc(np.array(risks), np.array(confids)),
                "eaurc": eaurc(np.array(risks), np.array(confids)),
            }}
    with open(exp_dataloader.dataset_path / "failure_detection.json",
              "w") as f:
        json.dump(results_dict, f, indent=2)
