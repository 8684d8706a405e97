"""Active-learning improvement: the relative Dice improvement of
uncertainty-driven acquisition over the random baseline.

The port's counterpart of ``values_tpu/evaluation/metrics/al_improvement.py``
(:16-54; reference: evaluation/metrics/al_improvement.py:6-72):
``(dice_2nd_unc/dice_1st - 1) - (dice_2nd_random/dice_1st - 1)`` per
(unc_type other than aleatoric) x aggregation, the second cycle's results
read from ``second_cycle_path/<model>/test_results/<unc>/<agg>/<version>/
<split>/metrics.json``. ``al_driver`` names its training versions
differently (ROADMAP.md, Queue 3): moving the second cycle's test_3d
trees into this layout is left to the user, as in the JAX package.
"""
from __future__ import annotations

import json

from ..experiment_dataloader import ExperimentDataloader


def _mean_dice(metrics_path) -> float:
    with open(metrics_path) as f:
        metrics = json.load(f)
    mean = metrics["mean"]
    if "metrics" in mean:
        return mean["metrics"]["dice"]
    return mean["dice"]


def main(exp_dataloader: ExperimentDataloader) -> None:
    al_improv_dict = {"mean": {}}
    dice_first = _mean_dice(exp_dataloader.dataset_path / "metrics.json")

    version = exp_dataloader.exp_version
    second_cycle_random = (
        version.second_cycle_path / version.pred_model / "test_results"
        / "random" / "random" / version.version_name
        / exp_dataloader.dataset_split / "metrics.json")
    dice_random = _mean_dice(second_cycle_random)

    for unc_type in version.unc_types:
        if unc_type == "aleatoric_uncertainty":
            continue
        al_improv_dict["mean"][unc_type] = {}
        for aggregation in version.aggregations:
            second_cycle_unc = (
                version.second_cycle_path / version.pred_model
                / "test_results" / unc_type / aggregation
                / version.version_name / exp_dataloader.dataset_split
                / "metrics.json")
            dice_unc = _mean_dice(second_cycle_unc)
            rel_improv_unc = (dice_unc / dice_first) - 1
            rel_improv_random = (dice_random / dice_first) - 1
            al_improv_dict["mean"][unc_type][aggregation] = {
                "metrics": {
                    "al_improvement": rel_improv_unc - rel_improv_random}}

    with open(exp_dataloader.dataset_path / "al_improvement.json", "w") as f:
        json.dump(al_improv_dict, f, indent=2)
