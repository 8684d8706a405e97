"""The evaluation test beds: C3 aggregation, thresholds, OoD detection,
failure detection, calibration, ambiguity modeling, the AL splits and the
second cycle (counterpart of ``values_tpu/evaluation``, without
``visualization/`` and ``gta.py``)."""
from .experiment_version import ExperimentVersion
from .experiment_dataloader import ExperimentDataloader
from .eval_experiments import EvalExperiments, deep_update

__all__ = ["ExperimentVersion", "ExperimentDataloader", "EvalExperiments",
           "deep_update"]
