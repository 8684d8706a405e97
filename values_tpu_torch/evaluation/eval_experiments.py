"""Evaluation driver: version grid x dataset splits x tasks.

The port's counterpart of ``values_tpu/evaluation/eval_experiments.py``
(:25-121; reference: evaluation/eval_experiments.py:12-119): the versions
are the Cartesian product of each experiment's ``iter_params`` merged with
its per-model config; each task's ``function`` is instantiated with an
ExperimentDataloader; ``accumulated`` tasks deep-merge their results
across versions and run a ``postprocess_function``. The task targets of
``configs/evaluation/*.yaml`` (``values_tpu.evaluation.*`` and the
reference's ``evaluation.*``) resolve to this package
(``config/instantiate.py``).

CLI:
    python -m values_tpu_torch.evaluation.eval_experiments \\
        --config-dir configs/evaluation --config-name eval_config_lidc \\
        [key=value ...]

Every task but the ``use_device`` patch aggregation runs on the host in
numpy; that one takes the CUDA card unless its config names a
``device``.
"""
from __future__ import annotations

import argparse
from itertools import product
from pathlib import Path
from typing import Dict, List

from ..config import Config, compose, instantiate, make_config
from .experiment_dataloader import ExperimentDataloader
from .experiment_version import ExperimentVersion


def deep_update(base: Dict, update: Dict) -> Dict:
    """pydantic.utils.deep_update semantics: nested dicts merge, the
    update wins, other values are overwritten."""
    out = dict(base)
    for key, value in update.items():
        if (key in out and isinstance(out[key], dict)
                and isinstance(value, dict)):
            out[key] = deep_update(out[key], value)
        else:
            out[key] = value
    return out


def _instantiate_task_fn(function_cfg, **kwargs):
    node = make_config(dict(function_cfg))
    return instantiate(node, **kwargs)


class EvalExperiments:
    def __init__(self, config: Config):
        self.base_path = Path(config["base_path"])
        self.second_cycle_path = config.get("second_cycle_path")
        self.versions = self._init_versions(config)
        self.tasks = config["tasks"]
        self.config = config

    def _init_versions(self, config) -> List[ExperimentVersion]:
        versions = []
        for experiment in config["experiments"]:
            iter_lists = [
                [(key, v) for v in values]
                for key, values in experiment["iter_params"].items()]
            for params in product(*iter_lists):
                version_params = {k: v for k, v in params}
                exp_config = {k: v for k, v in experiment.items()
                              if k != "iter_params"}
                version_params.update(exp_config)
                version_params["base_path"] = self.base_path
                version_params["second_cycle_path"] = self.second_cycle_path
                version_params.update(dict(
                    experiment["prediction_models"][
                        version_params["pred_model"]]))
                version_params.pop("prediction_models", None)
                versions.append(ExperimentVersion(**version_params))
        return versions

    def _dataset_splits(self, task_params) -> List:
        if "datasets" in task_params:
            return list(task_params["datasets"])
        return [None]

    def analyse_accumulated(self, task_params) -> None:
        results_dict_task: Dict = {}
        for version in self.versions:
            for dataset_split in self._dataset_splits(task_params):
                exp_dataloader = ExperimentDataloader(version, dataset_split)
                results = _instantiate_task_fn(
                    task_params["function"], exp_dataloader=exp_dataloader)
                results_dict_task = deep_update(results_dict_task, results)
        _instantiate_task_fn(task_params["postprocess_function"],
                             results_dict=results_dict_task)

    def analyse_single_version(self, task_params) -> None:
        for version in self.versions:
            for dataset_split in self._dataset_splits(task_params):
                exp_dataloader = ExperimentDataloader(version, dataset_split)
                _instantiate_task_fn(task_params["function"],
                                     exp_dataloader=exp_dataloader)

    def _analyse_one(self, task_params) -> None:
        accumulated = bool(task_params.get("accumulated", False))
        if accumulated:
            self.analyse_accumulated(task_params)
        else:
            self.analyse_single_version(task_params)

    def analyse(self) -> None:
        for task in self.tasks:
            task_params = self.config["task_params"][task]
            if isinstance(task_params, list):
                for subtask_params in task_params:
                    self._analyse_one(subtask_params)
            else:
                self._analyse_one(task_params)
            print(task)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-dir", "-cd", default="configs/evaluation")
    parser.add_argument("--config-name", "-cn", default="eval_config_lidc")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = compose(args.config_dir, args.config_name, args.overrides)
    EvalExperiments(cfg).analyse()


if __name__ == "__main__":
    main()
