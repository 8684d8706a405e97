"""Generic 2D datamodule: dataset, augmentation pipelines and loaders.

The port's copy of ``values_tpu/data/base_datamodule.py`` (reference:
uncertainty_modeling/data/torch_dataloader.py:124-300): pipelines built
from the YAML augmentation config per split, datasets instantiated from a
``dataset`` config node, ``max_steps()`` for the polynomial LR schedule,
a train loader that shuffles with ``RandomState(seed + epoch)`` and
drops the last batch. The loaders run on the host in numpy; the trainer
and the tester move each batch to the device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..config import instantiate, make_config
from .augment2d import get_augmentations_from_config


def get_max_steps(size_dataset: int, batch_size: int, num_devices: int,
                  accumulate_grad_batches: int, num_epochs: int,
                  drop_last: bool = True):
    """(torch_dataloader.py:40-73)."""
    if drop_last:
        steps_per_epoch = size_dataset // batch_size
    else:
        steps_per_epoch = math.ceil(size_dataset / batch_size)
    steps_per_gpu = int(math.ceil(steps_per_epoch / num_devices))
    steps_per_epoch = int(math.ceil(steps_per_gpu / accumulate_grad_batches))
    return num_epochs * steps_per_epoch, steps_per_epoch


class SimpleDataLoader:
    """Minimal batch iterator over a map-style dataset (host-side)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            items = [self.dataset[int(j)] for j in idx]
            batch: Dict[str, Any] = {}
            for key in items[0]:
                vals = [it[key] for it in items]
                if isinstance(vals[0], np.ndarray):
                    batch[key] = np.stack(vals)
                else:
                    batch[key] = vals
            yield batch


class BaseDataModule:
    def __init__(self, data_input_dir: str, dataset, batch_size: int,
                 val_batch_size: int, num_workers: int, augmentations,
                 tta: bool = False, **kwargs):
        self.data_input_dir = data_input_dir
        self.dataset = dataset
        self.batch_size = batch_size
        self.val_batch_size = val_batch_size
        self.num_workers = num_workers
        self.augmentations = augmentations
        self.tta = tta
        self.test_split = kwargs.get("test_split")
        self.num_classes = kwargs.get("num_classes", 24)
        self.ignore_index = kwargs.get("ignore_index", 255)
        self.max_epochs: int = kwargs.get("max_epochs", 1)
        self.num_devices: int = kwargs.get("num_devices", 1)
        self.accumulate_grad_batches: int = kwargs.get(
            "accumulate_grad_batches", 1)
        self.DS_train = self.DS_val = self.DS_test = None

    def prepare_data(self) -> None:  # dataset construction is offline
        pass

    def _make_dataset(self, split: str, transforms, tta: bool = False):
        return instantiate(make_config(dict(self.dataset)),
                           base_dir=self.data_input_dir, split=split,
                           transforms=transforms, tta=tta)

    def setup(self, stage: Optional[str] = None) -> None:
        aug = self.augmentations
        if stage in (None, "fit"):
            transforms_train = get_augmentations_from_config(
                aug["TRAIN"])[0]
            self.DS_train = self._make_dataset("train", transforms_train)
        if stage in (None, "fit", "validate"):
            transforms_val = get_augmentations_from_config(
                aug["VALIDATION"])[0]
            self.DS_val = self._make_dataset("val", transforms_val,
                                             tta=self.tta)
        if stage in (None, "test"):
            transforms_test = get_augmentations_from_config(aug["TEST"])[0]
            test_split = (self.test_split
                          if self.test_split in ("unlabeled", "val")
                          else f"{self.test_split}_test")
            self.DS_test = self._make_dataset(test_split, transforms_test,
                                              tta=self.tta)

    def max_steps(self) -> int:
        max_steps, per_epoch = get_max_steps(
            size_dataset=len(self.DS_train), batch_size=self.batch_size,
            num_devices=self.num_devices,
            accumulate_grad_batches=self.accumulate_grad_batches,
            num_epochs=self.max_epochs, drop_last=True)
        print(f"Number of Training steps: {max_steps} "
              f"({per_epoch} steps per epoch)")
        return max_steps

    def train_dataloader(self) -> SimpleDataLoader:
        return SimpleDataLoader(self.DS_train, self.batch_size,
                                shuffle=True, drop_last=True)

    def val_dataloader(self) -> SimpleDataLoader:
        return SimpleDataLoader(self.DS_val, self.val_batch_size)

    def test_dataloader(self) -> SimpleDataLoader:
        return SimpleDataLoader(self.DS_test, self.val_batch_size)
