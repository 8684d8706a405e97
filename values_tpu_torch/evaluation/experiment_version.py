"""Experiment-version naming schemes.

The port's counterpart of ``values_tpu/evaluation/experiment_version.py``
(:14-45; reference: evaluation/experiment_version.py:4-51):
``exp_path = base_path / naming_scheme_pred_model.format(**params) /
"test_results" / naming_scheme_version.format(**params)``, so the result
trees of either package evaluate unchanged.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional


class ExperimentVersion:
    def __init__(self, base_path, naming_scheme_version: str,
                 pred_model: str, image_ending: str, unc_ending: str,
                 unc_types: List[str], aggregations: List[str],
                 n_reference_segs: int, second_cycle_path=None,
                 n_classes: int = 2,
                 naming_scheme_pred_model: str = "{pred_model}",
                 datamodule_config: Optional[Dict] = None,
                 pred_seg_loading: Optional[Dict] = None,
                 gt_unc_map_loading: Optional[Dict] = None,
                 **kwargs: Any):
        self.pred_model = pred_model
        self.naming_scheme_pred_model = naming_scheme_pred_model
        self.version_name = naming_scheme_version.format(**kwargs)
        self.naming_scheme_version = naming_scheme_version
        self.base_path = Path(base_path)
        self.exp_path = (
            self.base_path
            / naming_scheme_pred_model.format(pred_model=pred_model, **kwargs)
            / "test_results" / self.version_name)
        self.second_cycle_path = (
            Path(second_cycle_path) if second_cycle_path is not None else None)
        self.image_ending = image_ending
        self.unc_ending = unc_ending
        self.n_reference_segs = n_reference_segs
        self.n_classes = n_classes
        self.unc_types = list(unc_types)
        self.aggregations = list(aggregations)
        self.datamodule_config = datamodule_config
        self.pred_seg_loading = pred_seg_loading
        self.gt_unc_map_loading = gt_unc_map_loading
        self.version_params = kwargs
