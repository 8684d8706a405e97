"""Toy-shapes 3D datamodule (L1).

Interface-parity with the reference's ``ToyDataModule3D``
(reference: uncertainty_modeling/toy_datamodule_3D.py:22-366):
``prepare_data`` (idempotent preprocessing + splits creation), ``setup``
(fold key loading), ``train_dataloader``/``val_dataloader``. Instantiable
from the same YAML configs (``_target_`` alias maps the reference path).

The port's copy of ``values_tpu/data/toy_datamodule.py``.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional

from ..core.io import load_pickle
from .pipeline import NumpyBatchLoader
from .preprocess3d import create_kfold_splits, preprocess_dataset
from .samples import get_train_data_samples, get_val_test_data_samples


class ToyDataModule3D:
    label_suffix = ""

    def __init__(self, dataset_name: str = "Case_1", num_raters: int = 3,
                 data_input_dir: Optional[str] = None,
                 data_num_folds: int = 5, data_fold_id: int = 0,
                 batch_size: int = 16, patch_size: int = 64,
                 patch_overlap: float = 1, num_workers: int = 8,
                 seed: int = 42, augment: bool = False, *args, **kwargs):
        self.dataset_name = dataset_name
        self.num_raters = num_raters
        self.data_input_dir = os.environ.get(
            "DATASET_LOCATION",
            data_input_dir if data_input_dir is not None else os.getcwd())
        self.data_num_folds = data_num_folds
        self.data_fold_id = data_fold_id
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.patch_overlap = patch_overlap
        self.num_workers = num_workers
        self.seed = seed
        self.augment = augment
        self.tr_keys: Optional[List[str]] = None
        self.val_keys: Optional[List[str]] = None
        self.test_keys: Optional[List[str]] = None

    @property
    def num_classes(self) -> int:
        return 2

    @property
    def dataset_dir(self) -> str:
        return os.path.join(self.data_input_dir, self.dataset_name)

    @property
    def preprocessed_dir(self) -> str:
        return os.path.join(self.dataset_dir, "preprocessed")

    def prepare_data(self) -> None:
        if not os.path.exists(self.preprocessed_dir):
            print("Preprocessing data. [STARTED]")
            preprocess_dataset(self.dataset_dir, self.num_raters,
                               self.patch_size, self.patch_overlap,
                               label_suffix=self.label_suffix)
            print("Preprocessing data. [DONE]")
        splits_file = os.path.join(self.dataset_dir, "splits.pkl")
        if not os.path.exists(splits_file):
            print(f"Creating new splits file for {self.data_num_folds} "
                  "fold cross-validation.")
            create_kfold_splits(
                output_dir=self.dataset_dir,
                image_dir=os.path.join(self.preprocessed_dir, "imagesTr"),
                test_dir=os.path.join(self.preprocessed_dir, "imagesTs"),
                seed=self.seed, n_splits=self.data_num_folds)

    def setup(self, stage: Optional[str] = None) -> None:
        splits = load_pickle(os.path.join(self.dataset_dir, "splits.pkl"))
        self.tr_keys = list(splits[self.data_fold_id]["train"])
        self.val_keys = list(splits[self.data_fold_id]["val"])
        self.test_keys = list(splits[self.data_fold_id]["test"])

    def train_dataloader(self) -> NumpyBatchLoader:
        samples = get_train_data_samples(
            base_dir=self.preprocessed_dir, subject_ids=self.tr_keys,
            num_raters=self.num_raters, label_suffix=self.label_suffix)
        return NumpyBatchLoader(samples, self.batch_size, self.patch_size,
                                training=True, augment=self.augment,
                                seed=self.seed,
                                num_workers=self.num_workers)

    def val_dataloader(self) -> NumpyBatchLoader:
        samples = get_val_test_data_samples(
            base_dir=self.preprocessed_dir, subject_ids=self.val_keys,
            num_raters=self.num_raters, test=False,
            patch_size=self.patch_size, patch_overlap=self.patch_overlap,
            label_suffix=self.label_suffix)
        return NumpyBatchLoader(samples, 1, self.patch_size, training=False,
                                seed=self.seed)
