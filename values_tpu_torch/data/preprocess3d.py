"""Shared 3D preprocessing: z-score normalization + padding to npy (L0->L1).

Reproduces the reference's preprocessing numerics (reference:
uncertainty_modeling/toy_datamodule_3D.py:119-196 and
datasets/preprocess_datasets_3d.py:66-168):

- z-score normalize with eps 1e-8,
- pad each axis to ``shape + (shape % stride)`` (the reference's exact —
  quirky — formula; a no-op for the shipped 64^3 data) with the image
  minimum as constant, split centered like batchgenerators' pad_nd_image
  (below = diff//2, above = diff//2 + diff%2),
- save as ``preprocessed/images{Tr,Ts}/<id>.npy`` and
  ``preprocessed/labels{Tr,Ts}/<id>_<rater:02d>.npy``.

The port's copy of ``values_tpu/data/preprocess3d.py`` (:26-113). Its
k-fold split is scikit-learn's ``KFold(shuffle=True, random_state=seed)``
written out in numpy, which the port does not need to have installed;
the preprocessing CLI stays in the JAX package.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..core import nifti
from ..core.io import save_pickle, subfiles


def pad_to_shape(image: np.ndarray, new_shape: Sequence[int],
                 constant_value: float) -> np.ndarray:
    pads = []
    for old, new in zip(image.shape, new_shape):
        diff = max(0, new - old)
        pads.append((diff // 2, diff // 2 + diff % 2))
    return np.pad(image, pads, mode="constant", constant_values=constant_value)


def reference_pad_shape(shape: Sequence[int], stride: int) -> tuple:
    """``shape + (shape % stride)`` per axis (toy_datamodule_3D.py:144-152)."""
    return tuple(int(s) + (int(s) % stride) for s in shape)


def normalize_zscore(image: np.ndarray) -> np.ndarray:
    return (image - image.mean()) / (image.std() + 1e-8)


def preprocess_dataset(root_dir: str, num_raters: int, patch_size: int = 64,
                       patch_overlap: float = 1.0,
                       label_suffix: str = "") -> None:
    """Normalize+pad nii.gz into preprocessed npy (both Tr and Ts splits).

    ``label_suffix`` supports the LIDC naming ``<id>_<rater:02d>_mask``
    (preprocess_datasets_3d.py:113-119).
    """
    stride = int(patch_size * patch_overlap)
    for folder in ("Tr", "Ts"):
        image_dir = os.path.join(root_dir, f"images{folder}")
        label_dir = os.path.join(root_dir, f"labels{folder}")
        if not os.path.isdir(image_dir):
            continue
        out_images = os.path.join(root_dir, "preprocessed", f"images{folder}")
        out_labels = os.path.join(root_dir, "preprocessed", f"labels{folder}")
        os.makedirs(out_images, exist_ok=True)
        os.makedirs(out_labels, exist_ok=True)

        for fname in subfiles(image_dir, suffix=".nii.gz", prefix="0",
                              join=False):
            image, _ = nifti.load(os.path.join(image_dir, fname))
            image = normalize_zscore(image)
            new_shape = reference_pad_shape(image.shape, stride)
            image = pad_to_shape(image, new_shape, image.min())
            image_id = fname.split(".")[0]
            np.save(os.path.join(out_images, image_id + ".npy"), image)
            for rater in range(num_raters):
                label_name = f"{image_id}_{rater:02d}{label_suffix}.nii.gz"
                label_path = os.path.join(label_dir, label_name)
                if not os.path.exists(label_path):
                    continue
                label, _ = nifti.load(label_path)
                label = pad_to_shape(label, new_shape, label.min())
                np.save(os.path.join(
                    out_labels,
                    f"{image_id}_{rater:02d}{label_suffix}.npy"), label)


def kfold_indices(n_samples: int, n_splits: int, seed: int):
    """(train, val) index arrays of each fold, as scikit-learn's
    ``KFold(n_splits, shuffle=True, random_state=seed).split`` gives them:
    a RandomState(seed) shuffle cut into consecutive folds, the first
    ``n_samples % n_splits`` one longer; both index sets ascending."""
    order = np.arange(n_samples)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n_samples // n_splits, dtype=int)
    sizes[:n_samples % n_splits] += 1
    start = 0
    for size in sizes:
        val = np.zeros(n_samples, dtype=bool)
        val[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~val), np.flatnonzero(val)


def create_kfold_splits(output_dir: str, image_dir: str, test_dir: str,
                        seed: int, n_splits: int = 5) -> None:
    """splits.pkl: list of {train, val, test} (toy_datamodule_3D.py:198-228)."""
    np.random.seed(seed)
    train_files = subfiles(image_dir, suffix=".npy", join=False, sort=True)
    test_files = subfiles(test_dir, suffix=".npy", join=False, sort=True)
    splits = []
    for train_idx, val_idx in kfold_indices(len(train_files), n_splits,
                                            seed):
        splits.append({
            "train": np.array(train_files)[train_idx],
            "val": np.array(train_files)[val_idx],
            "test": np.array(test_files),
        })
    save_pickle(splits, os.path.join(output_dir, "splits.pkl"))
