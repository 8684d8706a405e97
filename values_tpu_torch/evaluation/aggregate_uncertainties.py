"""C3 aggregation: reduce per-voxel heatmaps to per-image scalars.

The port's counterpart of ``values_tpu/evaluation/aggregate_uncertainties.py``
(:41-118; reference: evaluation/uncertainty_aggregation/
aggregate_uncertainties.py:13-96):

- patch_level: N-d 'valid' box-filter sum (window ``patch_size``), the
  max and the first (lexicographic) near-max bounding box (np.isclose).
  On the host it is scipy's float64 convolution, as in the JAX package;
  with ``use_device=True`` the box sum runs on ``device`` (default: the
  CUDA card) through ``ops/aggregation.py::box_filter_sum``, where the
  JAX package runs XLA's float32 ``reduce_window``: in float64, since the
  float32 prefix sums of a 64^3 map are off by up to ~1e-6 of a box's
  sum, which moves the first near-max box across np.isclose's 1e-5 edge
  on a near-uniform map (an H100 run picked a box 10 voxels from the
  host's),
- image_level: sum (or mean),
- threshold: mean of the values >= threshold (the threshold read per
  (pred_model, unc class) from ``threshold_analysis.json``); the sum
  where the count is 0 even with mean=True, the reference's quirk,
- :func:`aggregate_uncertainties` writes ``aggregated_<unc>.json``.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from ..config import instantiate, make_config
from ..core.device import resolve_device
from ..ops.aggregation import box_filter_sum
from .experiment_dataloader import ExperimentDataloader


def _box_filter_sum(image: np.ndarray, patch_shape, device=None
                    ) -> np.ndarray:
    """The 'valid' box-filter sum of ``image`` in float64 on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float64))
    x = x.to(resolve_device(device))
    out = box_filter_sum(x, patch_shape, range(x.ndim))
    return out.cpu().numpy()


def patch_level_aggregation(image: np.ndarray, patch_size,
                            mean: bool = False, use_device: bool = False,
                            device=None, **kwargs) -> Dict:
    if isinstance(patch_size, int):
        patch_size = len(image.shape) * [patch_size]
    if use_device:
        patch_aggregated = np.asarray(
            _box_filter_sum(np.asarray(image), tuple(patch_size), device),
            dtype=np.float64)
    else:
        from scipy.signal import convolve
        patch_aggregated = convolve(image, np.ones(patch_size), mode="valid")
    if mean:
        patch_aggregated = patch_aggregated / np.prod(patch_size)
    all_max_indices = np.where(
        np.isclose(patch_aggregated, np.max(patch_aggregated)))
    max_indices_slice = [
        (int(indices[0]), int(indices[0] + patch_size[dim]))
        for dim, indices in enumerate(all_max_indices)]
    return {"max_score": float(np.max(patch_aggregated)),
            "bounding_box": max_indices_slice}


def image_level_aggregation(image: np.ndarray, mean: bool = False,
                            **kwargs):
    if mean:
        return float(np.sum(image) / image.size)
    return {"max_score": float(np.sum(image))}


def threshold_aggregation(image: np.ndarray, threshold: Optional[float] = None,
                          threshold_path: Optional[str] = None,
                          pred_model: Optional[str] = None,
                          unc_type: Optional[str] = None,
                          mean: bool = True) -> Dict:
    if threshold is None:
        if threshold_path is None:
            raise Exception(
                "A threshold needs to be provided for threshold aggregation!")
        with open(threshold_path) as f:
            threshold_json = json.load(f)
        if pred_model is None or unc_type is None:
            raise Exception(
                "If you want to load the threshold from a json file, you "
                "have to provide the prediction model and the uncertainty "
                "type")
        unc_type_split = unc_type.split("_")[0]
        threshold = threshold_json[pred_model][
            f"Mean {unc_type_split} threshold"]
    uncertainty_sum = float(image[image >= threshold].sum())
    count = int((image >= threshold).sum())
    if mean and count > 0:
        return {"max_score": uncertainty_sum / count, "threshold": threshold}
    # the reference's quirk: count == 0 returns the (zero) sum, mean or not
    return {"max_score": uncertainty_sum, "threshold": threshold}


def aggregate_uncertainties(exp_dataloader: ExperimentDataloader,
                            aggregations: Dict) -> None:
    """Per unc_type: every image map through every configured
    aggregation -> ``aggregated_<unc>.json``."""
    for unc, unc_path in exp_dataloader.unc_path_dict.items():
        all_uncs: Dict[str, Dict] = {}
        for image_id in exp_dataloader.image_ids:
            key = f"{image_id}{exp_dataloader.exp_version.unc_ending}"
            all_uncs[key] = {}
            for aggregation in aggregations:
                unc_image = exp_dataloader.get_unc_map(image_id, unc)
                unc_dict = instantiate(
                    make_config(dict(aggregations[aggregation])),
                    image=unc_image,
                    pred_model=exp_dataloader.exp_version.pred_model,
                    unc_type=unc)
                all_uncs[key][aggregation] = unc_dict
        save_path = exp_dataloader.dataset_path / f"aggregated_{unc}.json"
        with open(save_path, "w") as f:
            json.dump(all_uncs, f, indent=4)
