"""GTA5 + Cityscapes mixed dataset (the 2D path's data).

The port's copy of ``values_tpu/data/cityscapes_dataset.py`` (reference:
uncertainty_modeling/data/cityscapes_dataset.py:12-171): samples resolved
from (filename, "gta"|"cs") split tuples against
``OriginalData/preprocessed`` and ``CityScapesOriginalData/preprocessed``;
``__getitem__`` returns {data, seg, image_id, dataset}; TTA mode returns
the 4 variants [orig, hflip, noise, hflip+noise] plus transform
bookkeeping. Arrays are channels-last numpy; the tester moves them
to the device.
"""
from __future__ import annotations

import fnmatch
import os
import pickle
from typing import Dict, List

import numpy as np

from .augment2d import GaussNoise, HorizontalFlip


class CityscapesDataset:
    def __init__(self, splits_path: str, base_dir: str, split: str = "train",
                 file_pattern: str = "*.npy", transforms=None,
                 data_fold_id: int = 0, tta: bool = False):
        self.splits_path = splits_path
        self.data_fold_id = data_fold_id
        self.get_split_keys()
        subject_ids = {
            "train": self.tr_keys, "val": self.val_keys,
            "id_test": self.id_test_keys, "ood_test": self.ood_test_keys,
            "unlabeled": self.unlabeled_keys,
        }.get(split)
        if subject_ids is None:
            print(f"{split} split not specified!")
            subject_ids = []

        self.samples: List[Dict] = []
        for dataset in ["gta", "cs"]:
            ds_subjects = [s[0] for s in subject_ids if s[1] == dataset]
            ds_dir = os.path.join(
                base_dir,
                "OriginalData" if dataset == "gta"
                else "CityScapesOriginalData", "preprocessed")
            self.samples.extend(get_data_samples(
                base_dir=ds_dir, pattern=file_pattern,
                subject_ids=ds_subjects, dataset=dataset))

        self.imgs = [s["image_path"] for s in self.samples]
        self.masks = [s["label_path"] for s in self.samples]
        self.image_ids = [s["image_id"] for s in self.samples]
        self.datasets = [s["dataset"] for s in self.samples]
        self.transforms = transforms
        self.tta = tta
        print(f"Dataset: Cityscape {split} - {len(self.imgs)} images - "
              f"{len(self.masks)} masks")

    def __len__(self) -> int:
        return len(self.imgs)

    def __getitem__(self, idx: int) -> Dict:
        img = np.load(self.imgs[idx])
        mask = np.load(self.masks[idx])
        if self.tta:
            # [orig, hflip, noise, hflip+noise] (cityscapes_dataset.py:76-99)
            flip = HorizontalFlip(p=1.0)
            noise = GaussNoise(p=1.0)
            flipped = flip(image=img)["image"]
            images = [img, flipped, noise(image=img)["image"],
                      noise(image=flipped)["image"]]
            transforms_used = [[], ["HorizontalFlip"], ["GaussNoise"],
                               ["HorizontalFlip", "GaussNoise"]]
            images = [self.transforms(image=im)["image"] for im in images]
            transformed = self.transforms(image=img, mask=mask)
            return {"data": images, "seg": transformed["mask"],
                    "image_id": self.image_ids[idx],
                    "dataset": self.datasets[idx],
                    "transforms": transforms_used}
        transformed = self.transforms(image=img, mask=mask)
        return {"data": transformed["image"], "seg": transformed["mask"],
                "image_id": self.image_ids[idx],
                "dataset": self.datasets[idx]}

    def get_split_keys(self) -> None:
        with open(self.splits_path, "rb") as f:
            splits = pickle.load(f)
        fold = splits[self.data_fold_id]
        self.tr_keys = fold["train"]
        self.val_keys = fold["val"]
        self.id_test_keys = fold["id_test"]
        self.ood_test_keys = fold["ood_test"]
        pools = [np.asarray(fold["id_unlabeled_pool"]),
                 np.asarray(fold["ood_unlabeled_pool"])]
        pools = [pool for pool in pools if pool.size]
        self.unlabeled_keys = (np.concatenate(pools) if pools
                               else np.asarray([]))


def get_data_samples(base_dir: str, pattern: str = "*.npy",
                     subject_ids=None, dataset: str = "gta") -> List[Dict]:
    samples = []
    image_dir = os.path.join(base_dir, "images")
    label_dir = os.path.join(base_dir, "labels")
    image_filenames = sorted(os.listdir(image_dir)) if os.path.isdir(
        image_dir) else []
    label_filenames = set(os.listdir(label_dir)) if os.path.isdir(
        label_dir) else set()
    subject_set = set(subject_ids) if subject_ids is not None else None
    for image_filename in sorted(fnmatch.filter(image_filenames, pattern)):
        if subject_set is not None and image_filename not in subject_set:
            continue
        samples.append({
            "image_path": os.path.join(image_dir, image_filename),
            "label_path": (os.path.join(label_dir, image_filename)
                           if image_filename in label_filenames else None),
            "image_id": image_filename.split(".")[0],
            "dataset": dataset,
        })
    return samples
