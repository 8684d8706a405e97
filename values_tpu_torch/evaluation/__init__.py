"""The evaluation test beds: C3 aggregation, thresholds, OoD detection,
failure detection, calibration, ambiguity modeling, the AL splits, the
second cycle, GTA's loaders (``gta.py``) and the reporting layer
(``visualization/``: the results table and the bar plots); the
counterpart of ``values_tpu/evaluation``."""
from .experiment_version import ExperimentVersion
from .experiment_dataloader import ExperimentDataloader
from .eval_experiments import EvalExperiments, deep_update

__all__ = ["ExperimentVersion", "ExperimentDataloader", "EvalExperiments",
           "deep_update"]
