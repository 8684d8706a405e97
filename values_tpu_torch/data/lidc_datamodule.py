"""LIDC-IDRI 3D datamodule (L1).

Interface parity with the reference's ``LidcIdriDataModule3D``
(reference: uncertainty_modeling/lidc_idri_datamodule_3D.py:24-350): flat
``preprocessed/{images,labels}`` layout, label naming
``<id>_<rater:02d>_mask.npy``, 4 raters, shift-feature-driven first-cycle
splits from ``id_ood.csv`` (created when missing), split keys
``train/val/id_test/ood_test/{id,ood}_unlabeled_pool``.

The port's copy of ``values_tpu/data/lidc_datamodule.py``, its splits made
by the port's pandas-free :mod:`.lidc`.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core import nifti
from ..core.io import load_pickle, subfiles
from .lidc import create_first_cycle_splits
from .pipeline import NumpyBatchLoader
from .preprocess3d import normalize_zscore, pad_to_shape, reference_pad_shape
from .samples import get_train_data_samples, get_val_test_data_samples
from .toy_datamodule import ToyDataModule3D


class LidcIdriDataModule3D(ToyDataModule3D):
    label_suffix = "_mask"

    def __init__(self, dataset_name: str = "LIDC-IDRI",
                 shift_feature: Optional[str] = "texture",
                 num_raters: int = 4,
                 splits_path: Optional[str] = None, *args, **kwargs):
        super().__init__(dataset_name=dataset_name, num_raters=num_raters,
                         *args, **kwargs)
        self.shift_feature = shift_feature
        self.splits_path = splits_path

    @property
    def dataset_dir(self) -> str:
        # LIDC lives directly under data_input_dir (no dataset subfolder;
        # lidc_idri_datamodule_3D.py:137-140)
        return self.data_input_dir

    @property
    def preprocessed_dir(self) -> str:
        return os.path.join(self.dataset_dir, "preprocessed")

    def _splits_file(self) -> str:
        if self.splits_path:
            return self.splits_path
        name = (f"splits_{self.shift_feature}.pkl"
                if self.shift_feature else "splits.pkl")
        return os.path.join(self.dataset_dir, name)

    def prepare_data(self) -> None:
        if not os.path.exists(self.preprocessed_dir):
            print("Preprocessing data. [STARTED]")
            self._preprocess_flat()
            print("Preprocessing data. [DONE]")
        splits_file = self._splits_file()
        if not os.path.exists(splits_file):
            print("Creating first-cycle splits from id_ood.csv")
            create_first_cycle_splits(
                output_path=splits_file,
                shift_feature=self.shift_feature,
                metadata_csv=os.path.join(self.dataset_dir, "id_ood.csv"),
                seed=self.seed, n_splits=self.data_num_folds)

    def _preprocess_flat(self) -> None:
        """z-score + pad nii.gz -> npy in the flat images/labels layout
        (lidc_idri_datamodule_3D.py:130-199)."""
        stride = int(self.patch_size * self.patch_overlap)
        image_dir = os.path.join(self.dataset_dir, "images")
        label_dir = os.path.join(self.dataset_dir, "labels")
        out_images = os.path.join(self.preprocessed_dir, "images")
        out_labels = os.path.join(self.preprocessed_dir, "labels")
        os.makedirs(out_images, exist_ok=True)
        os.makedirs(out_labels, exist_ok=True)
        for fname in subfiles(image_dir, suffix=".nii.gz", join=False):
            image, _ = nifti.load(os.path.join(image_dir, fname))
            image = normalize_zscore(image)
            new_shape = reference_pad_shape(image.shape, stride)
            image = pad_to_shape(image, new_shape, image.min())
            image_id = fname.split(".")[0]
            np.save(os.path.join(out_images, image_id + ".npy"), image)
            for rater in range(self.num_raters):
                label_name = f"{image_id}_{rater:02d}_mask.nii.gz"
                label_path = os.path.join(label_dir, label_name)
                if not os.path.exists(label_path):
                    continue
                label, _ = nifti.load(label_path)
                label = pad_to_shape(label, new_shape, label.min())
                np.save(os.path.join(
                    out_labels, f"{image_id}_{rater:02d}_mask.npy"), label)

    def setup(self, stage: Optional[str] = None) -> None:
        splits = load_pickle(self._splits_file())
        fold = splits[self.data_fold_id]
        self.tr_keys = list(fold["train"])
        self.val_keys = list(fold["val"])
        self.test_keys = list(fold["id_test"])

    def train_dataloader(self) -> NumpyBatchLoader:
        samples = get_train_data_samples(
            base_dir=self.preprocessed_dir, subject_ids=self.tr_keys,
            num_raters=self.num_raters, label_suffix="_mask",
            flat_dirs=True)
        return NumpyBatchLoader(samples, self.batch_size, self.patch_size,
                                training=True, augment=self.augment,
                                seed=self.seed,
                                num_workers=self.num_workers)

    def val_dataloader(self) -> NumpyBatchLoader:
        samples = get_val_test_data_samples(
            base_dir=self.preprocessed_dir, subject_ids=self.val_keys,
            num_raters=self.num_raters, test=False,
            patch_size=self.patch_size, patch_overlap=self.patch_overlap,
            label_suffix="_mask", flat_dirs=True)
        return NumpyBatchLoader(samples, 1, self.patch_size, training=False,
                                seed=self.seed)
