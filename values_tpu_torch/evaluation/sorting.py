"""Acquisition sorting of aggregated uncertainties.

The port's counterpart of ``values_tpu/evaluation/sorting.py`` (:11-16;
reference: evaluation/utils/sort_uncertainties.py:1-38): image names
sorted by the given aggregation level's max_score, descending.
"""
from __future__ import annotations

from typing import Dict, List

_LEVELS = {"image_level", "patch_level", "threshold"}


def sort_uncertainties(uncertainties: Dict, level: str) -> List[str]:
    if level not in _LEVELS:
        raise Exception("Uncertainty level not known!")
    score_dict = {key: value[level]["max_score"]
                  for key, value in uncertainties.items()}
    return sorted(score_dict, key=score_dict.get, reverse=True)
