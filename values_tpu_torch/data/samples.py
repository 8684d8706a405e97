"""Sample enumeration of the 3D datasets.

The port's copy of ``values_tpu/data/samples.py:21-89`` (reference:
toy_datamodule_3D.py:526-665, duplicated in lidc_idri_datamodule_3D.py):

- train samples: one dict per image;
- val/test samples: one dict per sliding-window position.

Label files are ``<stem>_<rater:02d><label_suffix>.npy`` (``_mask`` for
LIDC). ``flat_dirs`` selects the LIDC layout ``images/`` + ``labels/``
instead of ``images{Tr,Ts}/`` + ``labels{Tr,Ts}/``.
"""
from __future__ import annotations

import fnmatch
import os
from typing import Dict, List, Optional

import numpy as np

from ..ops.window import enumerate_window_starts, window_crop_tuples


def _resolve_label_paths(label_dir: str, label_filenames: List[str],
                         image_filename: str, num_raters: int,
                         label_suffix: str = "") -> Optional[List[str]]:
    stem = image_filename.split(".")[0]
    label_paths = [os.path.join(label_dir, name)
                   for name in (f"{stem}_{rater:02d}{label_suffix}.npy"
                                for rater in range(num_raters))
                   if name in label_filenames]
    return label_paths or None


def _listing(image_dir: str, label_dir: str, pattern: str,
             subject_ids: Optional[List[str]]):
    """(image filenames matching ``pattern`` and ``subject_ids``, label
    filenames), both sorted."""
    images = sorted(fnmatch.filter(sorted(os.listdir(image_dir)), pattern))
    if subject_ids is not None:
        images = [f for f in images if f in subject_ids]
    labels = (sorted(os.listdir(label_dir)) if os.path.isdir(label_dir)
              else [])
    return images, labels


def get_train_data_samples(base_dir: str, pattern: str = "*.npy",
                           subject_ids: Optional[List[str]] = None,
                           num_raters: int = 1, label_suffix: str = "",
                           flat_dirs: bool = False) -> List[Dict]:
    """One ``{"image_path", "label_paths"}`` dict per training image."""
    image_dir = os.path.join(base_dir, "images" if flat_dirs else "imagesTr")
    label_dir = os.path.join(base_dir, "labels" if flat_dirs else "labelsTr")
    images, labels = _listing(image_dir, label_dir, pattern, subject_ids)
    return [{"image_path": os.path.join(image_dir, f),
             "label_paths": _resolve_label_paths(label_dir, labels, f,
                                                 num_raters, label_suffix)}
            for f in images]


def get_val_test_data_samples(base_dir: str, pattern: str = "*.npy",
                              subject_ids: Optional[List[str]] = None,
                              num_raters: int = 1, test: bool = False,
                              patch_size: int = 64,
                              patch_overlap: float = 1.0,
                              label_suffix: str = "",
                              flat_dirs: bool = False) -> List[Dict]:
    """One ``{"image_path", "label_paths", "crop_idx"}`` dict per sliding
    window of each val/test image."""
    split = "Ts" if test else "Tr"
    image_dir = os.path.join(base_dir,
                             "images" if flat_dirs else f"images{split}")
    label_dir = os.path.join(base_dir,
                             "labels" if flat_dirs else f"labels{split}")
    images, labels = _listing(image_dir, label_dir, pattern, subject_ids)
    samples = []
    for image_filename in images:
        image_path = os.path.join(image_dir, image_filename)
        label_paths = _resolve_label_paths(label_dir, labels, image_filename,
                                           num_raters, label_suffix)
        shape = np.load(image_path, mmap_mode="r").shape
        starts = enumerate_window_starts(shape, patch_size, patch_overlap)
        samples.extend({"image_path": image_path,
                        "label_paths": label_paths, "crop_idx": crop}
                       for crop in window_crop_tuples(starts, patch_size))
    return samples
