"""VolumeCarrier: the stitched volumes of a split, their C2 maps and
metrics, and the reference-layout result tree.

The port's counterpart of ``values_tpu/inference/carrier.py`` (:40-199;
reference: uncertainty_modeling/data_carrier_3D.py). Volumes arrive
stitched by the engine; the carrier keeps them as numpy arrays, computes
C2 and the metrics with the port's torch functions on ``device``, and
writes the same tree, file for file:

    save_dir/<exp_name>/test_results/<version>/<split>/
        input/<id>.nii.gz
        gt_seg/<id>_<rater:02d>.nii.gz
        pred_seg/<id>_{mean|<pred:02d>}.nii.gz
        pred_prob/<id>_{mean|<pred:02d>}_<class+1:02d>.nii.gz
        (sigma/<id>_<class+1:02d>.nii.gz)
        pred_entropy/<id>.nii.gz
        aleatoric_uncertainty/<id>.nii.gz
        epistemic_uncertainty/<id>.nii.gz
        metrics.json

The reference's semantics stay: the stored arrays are raw stitched sums
with a ``num_predictions`` count map (num_classes, *spatial); C2 runs on
the raw sums (test_3D.py:486-534), and the sums are divided by
clip(count, 1) only when saved or scored (data_carrier_3D.py:208-221,
test_3D.py:537-575).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core import nifti
from ..core.io import save_json
from ..ops import metrics as ops_metrics
from ..ops import uncertainty as ops_uncertainty


class VolumeCarrier:
    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self.data: Dict[str, Dict] = {}
        self.save_dir: Optional[str] = None
        self.device = torch.device(device)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- accumulation -----------------------------------------------------
    def add_volume(self, image_path: str, label_paths: Optional[List[str]],
                   data_sums: np.ndarray, seg_sums: Optional[np.ndarray],
                   softmax_sums: np.ndarray, count: np.ndarray,
                   sigma_sums: Optional[np.ndarray] = None) -> None:
        """Store one stitched volume: data_sums (D0, D1, D2), seg_sums (R,
        D0, D1, D2) or None, softmax_sums (S, C, D0, D1, D2), count (D0,
        D1, D2), sigma_sums (S, C, D0, D1, D2) or None."""
        num_classes = softmax_sums.shape[1]
        entry = {
            "label_paths": label_paths,
            "data": np.asarray(data_sums),
            "softmax_pred": np.asarray(softmax_sums),
            "num_predictions": np.broadcast_to(
                np.asarray(count), (num_classes,) + tuple(count.shape)).copy(),
        }
        if seg_sums is not None:
            entry["seg"] = np.asarray(seg_sums)
        if sigma_sums is not None:
            entry["sigma"] = np.asarray(sigma_sums)
        self.data[image_path] = entry

    # -- C2 uncertainty (reference: test_3D.py:486-534) -------------------
    def compute_uncertainty(self) -> None:
        for value in self.data.values():
            measures = ops_uncertainty.uncertainty_measures(
                self._tensor(value["softmax_pred"]))
            value.update({k: v.cpu().numpy() for k, v in measures.items()})

    # -- metrics (reference: test_3D.py:537-575) --------------------------
    def compute_metrics(self) -> None:
        for value in self.data.values():
            if "seg" not in value:
                value["metrics"] = {}
                continue
            clip_count = np.where(value["num_predictions"] == 0, 1,
                                  value["num_predictions"])
            mean_softmax = np.mean(
                value["softmax_pred"] / clip_count[0], axis=0)[None]
            # the raw rater sums, as the reference scores them
            metrics = {k: float(v) for k, v in
                       ops_metrics.per_rater_test_metrics(
                           self._tensor(mean_softmax),
                           self._tensor(value["seg"])).items()}
            n_raters, n_preds = (value["seg"].shape[0],
                                 value["softmax_pred"].shape[0])
            if n_raters > 1 or n_preds > 1:
                gt = np.asarray(value["seg"] / np.stack([clip_count[0]]
                                                        * n_raters),
                                dtype=np.intc)
                softmax_pred = value["softmax_pred"] / np.stack(
                    [clip_count] * n_preds)
                ged = ops_metrics.generalized_energy_distance(
                    self._tensor(softmax_pred), self._tensor(gt))
                metrics.update({k: float(v) for k, v in ged.items()})
            value["metrics"] = metrics

    # -- persistence ------------------------------------------------------
    def _create_save_dirs(self, root_dir: str, exp_name: str, version,
                          sigma_save_dir: bool, test_split: str) -> None:
        self.save_dir = os.path.join(root_dir, exp_name, "test_results",
                                     str(version), test_split)
        for sub in ["input", "gt_seg", "pred_seg", "pred_prob"] + (
                ["sigma"] if sigma_save_dir else []):
            os.makedirs(os.path.join(self.save_dir, sub), exist_ok=True)

    @staticmethod
    def _image_id(key: str) -> str:
        return os.path.basename(key).split(".")[0]

    def save_data(self, root_dir: str, exp_name: str, version,
                  org_data_path: Optional[str] = None,
                  test_split: str = "id") -> None:
        has_sigma = any("sigma" in v for v in self.data.values())
        self._create_save_dirs(root_dir, exp_name, version, has_sigma,
                               test_split)

        def save(arr, sub, name, header):
            nifti.save(arr, os.path.join(self.save_dir, sub, name), header)

        for key, value in self.data.items():
            image_id = self._image_id(key)
            clip_count = np.where(value["num_predictions"] == 0, 1,
                                  value["num_predictions"])
            header = None
            if org_data_path:
                org_file = os.path.join(org_data_path, image_id + ".nii.gz")
                if os.path.exists(org_file):
                    _, header = nifti.load(org_file)

            save(value["data"] / clip_count[0], "input",
                 image_id + ".nii.gz", header)
            if "seg" in value:
                gt_seg = value["seg"] / clip_count[0]
                for seg_idx in range(gt_seg.shape[0]):
                    save(gt_seg[seg_idx], "gt_seg",
                         f"{image_id}_{seg_idx:02d}.nii.gz", header)

            softmax_pred = value["softmax_pred"] / clip_count
            if softmax_pred.shape[0] > 1:
                mean_prob = np.mean(softmax_pred, axis=0)
                save(np.argmax(mean_prob, axis=0).astype(np.uint8),
                     "pred_seg", f"{image_id}_mean.nii.gz", header)
                for class_idx in range(mean_prob.shape[0]):
                    save(mean_prob[class_idx], "pred_prob",
                         f"{image_id}_mean_{class_idx + 1:02d}.nii.gz",
                         header)
            for pred_idx in range(softmax_pred.shape[0]):
                save(np.argmax(softmax_pred[pred_idx], axis=0).astype(
                    np.uint8), "pred_seg",
                    f"{image_id}_{pred_idx + 1:02d}.nii.gz", header)
                for class_idx in range(softmax_pred.shape[1]):
                    save(softmax_pred[pred_idx, class_idx], "pred_prob",
                         f"{image_id}_{pred_idx + 1:02d}_"
                         f"{class_idx + 1:02d}.nii.gz", header)
                    if "sigma" in value and pred_idx == 0:
                        sigma = value["sigma"][pred_idx, class_idx] \
                            / clip_count[class_idx]
                        save(sigma, "sigma",
                             f"{image_id}_{class_idx + 1:02d}.nii.gz",
                             header)

            for unc_key in ("pred_entropy", "aleatoric_uncertainty",
                            "epistemic_uncertainty"):
                if unc_key in value:
                    save(value[unc_key] / clip_count[0], unc_key,
                         image_id + ".nii.gz", header)

    def log_metrics(self) -> None:
        """metrics.json: each image's metrics and their mean over images
        (data_carrier_3D.py:373-391)."""
        metrics_dict: Dict[str, Dict] = {}
        mean_acc: Dict[str, List[float]] = {}
        for image_path, value in self.data.items():
            metrics_dict[image_path] = {}
            for metric, score in value.get("metrics", {}).items():
                metrics_dict[image_path][metric] = score
                mean_acc.setdefault(metric, []).append(score)
        metrics_dict["mean"] = {metric: float(np.mean(scores))
                                for metric, scores in mean_acc.items()}
        save_json(metrics_dict, os.path.join(self.save_dir, "metrics.json"))
