"""Filesystem accessor for one experiment version and dataset split.

The port's counterpart of ``values_tpu/evaluation/experiment_dataloader.py``
(:29-163; reference: evaluation/experiment_dataloader.py:11-169), on the
host in numpy:

- image ids discovered from ``pred_seg/`` (the last ``_..`` part
  stripped),
- Softmax: ``pred_entropy/`` written lazily as 1 - max softmax of the
  first prediction's ``pred_prob`` files,
- ``predictive_uncertainty`` maps to the ``pred_entropy`` directory,
- reference segs from ``gt_seg/``, or from a datamodule re-instantiated
  from a carried ``datamodule_config`` (the 2D GTA path, which the port
  refuses through :func:`~values_tpu_torch.config.instantiate`),
- GT uncertainty map = per-voxel variance across raters, or a configured
  loader,
- mean pred seg = ``<id>_mean``, Softmax's ``<id>_01``.

Constructing one seeds python's, numpy's and torch's global RNGs with the
version's seed, as the JAX one seeds python's and numpy's, so the random
acquisition splits come out the same.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import instantiate, make_config
from ..core import nifti
from ..core.seed import set_seed
from .experiment_version import ExperimentVersion


def _load_map(path) -> np.ndarray:
    path = str(path)
    if path.endswith((".nii.gz", ".nii")):
        arr, _ = nifti.load(path)
        return arr
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith((".png", ".tif", ".tiff")):
        import cv2
        arr = cv2.imread(path, -1)
        if arr is None:
            from PIL import Image
            arr = np.asarray(Image.open(path))
        return arr
    raise ValueError(f"Unsupported map format: {path}")


class ExperimentDataloader:
    def __init__(self, exp_version: ExperimentVersion,
                 dataset_split: Optional[str]):
        self.exp_version = exp_version
        set_seed(int(exp_version.version_params["seed"]))
        self.dataset_split = dataset_split
        self.dataset_path = (exp_version.exp_path / dataset_split
                             if dataset_split else exp_version.exp_path)
        self.pred_seg_dir = self.dataset_path / "pred_seg"
        self.pred_prob_dir = (self.dataset_path / "pred_prob"
                              if (self.dataset_path / "pred_prob").exists()
                              else None)
        self.image_ids = sorted(self._get_image_ids())
        if self.exp_version.pred_model == "Softmax":
            self._setup_pred_entropy_softmax()
        self.unc_path_dict = self._setup_unc_path_dict()
        if self.exp_version.datamodule_config is not None:
            self.dataloader = self.setup_dataloader()
            self.ref_seg_dir = None
        else:
            self.dataloader = None
            self.ref_seg_dir = self.dataset_path / "gt_seg"

    # ------------------------------------------------------------------
    def _get_image_ids(self):
        return set(
            "_".join(name.split("_")[:-1])
            for name in os.listdir(self.pred_seg_dir)
            if name.endswith(self.exp_version.image_ending))

    def get_max_softmax_pred(self, image_id: str) -> np.ndarray:
        probs = []
        for class_prob in range(self.exp_version.n_classes):
            prob_file = (self.pred_prob_dir /
                         f"{image_id}_01_{class_prob + 1:02d}"
                         f"{self.exp_version.unc_ending}")
            probs.append(_load_map(prob_file))
        return 1.0 - np.max(np.array(probs), axis=0)

    def _setup_pred_entropy_softmax(self) -> None:
        out_dir = self.dataset_path / "pred_entropy"
        if out_dir.exists():
            return
        out_dir.mkdir(parents=True)
        for image_id in self.image_ids:
            one_minus_msr = self.get_max_softmax_pred(image_id)
            nifti.save(one_minus_msr, out_dir /
                       f"{image_id}{self.exp_version.unc_ending}")

    def _setup_unc_path_dict(self) -> Dict[str, Path]:
        out = {}
        for unc_type in self.exp_version.unc_types:
            if unc_type == "predictive_uncertainty":
                out[unc_type] = self.dataset_path / "pred_entropy"
            else:
                out[unc_type] = self.dataset_path / unc_type
        return out

    # ------------------------------------------------------------------
    def get_pred_seg_paths(self, image_id: str) -> List[Path]:
        return [self.pred_seg_dir / name
                for name in os.listdir(self.pred_seg_dir)
                if name.startswith(image_id)
                and name.endswith(self.exp_version.image_ending)]

    def get_pred_segs(self, image_id: str) -> List[np.ndarray]:
        return [_load_map(p) for p in self.get_pred_seg_paths(image_id)]

    def get_aggregated_unc_files_dict(self) -> Dict[str, Path]:
        out = {}
        for unc in self.unc_path_dict:
            path = self.dataset_path / f"aggregated_{unc}.json"
            if path.is_file():
                out[unc] = path
        return out

    def setup_dataloader(self):
        dm = instantiate(make_config(dict(self.exp_version.datamodule_config,
                                          _recursive_=False)),
                         test_split=self.dataset_split)
        dm.setup("test")
        return dm.test_dataloader()

    def get_reference_segs(self, image_id: str) -> np.ndarray:
        if self.dataloader is not None:
            idx = self.dataloader.dataset.image_ids.index(image_id)
            data = self.dataloader.dataset[idx]
            seg = np.asarray(data["seg"])
            return seg.squeeze()
        paths = [self.ref_seg_dir /
                 f"{image_id}_{i:02d}{self.exp_version.image_ending}"
                 for i in range(self.exp_version.n_reference_segs)]
        return np.array([_load_map(p) for p in paths])

    def get_gt_unc_map(self, image_id: str) -> np.ndarray:
        if self.exp_version.gt_unc_map_loading is None:
            refs = np.array([
                _load_map(self.ref_seg_dir /
                          f"{image_id}_{i:02d}{self.exp_version.image_ending}")
                for i in range(self.exp_version.n_reference_segs)])
            return np.var(refs, axis=0)
        return instantiate(
            make_config(dict(self.exp_version.gt_unc_map_loading)),
            image_id=image_id, dataloader=self.dataloader)

    def get_mean_pred_seg(self, image_id: str) -> np.ndarray:
        suffix = "mean" if self.exp_version.pred_model != "Softmax" else "01"
        path = (self.pred_seg_dir /
                f"{image_id}_{suffix}{self.exp_version.image_ending}")
        if self.exp_version.pred_seg_loading is None:
            return _load_map(path)
        return instantiate(
            make_config(dict(self.exp_version.pred_seg_loading)),
            pred_seg_path=path)

    def get_unc_map(self, image_id: str, unc_type: str) -> np.ndarray:
        return _load_map(self.unc_path_dict[unc_type] /
                         f"{image_id}{self.exp_version.unc_ending}")
