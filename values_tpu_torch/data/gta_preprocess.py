"""GTA5 + Cityscapes preprocessing and the first-cycle splits (the 2D
path's data).

The port's copy of ``values_tpu/data/gta_preprocess.py`` (reference:
datasets/gta_cityscapes/preprocess_gta_cityscapes.py:47-182 and
gta_cs_splits_first_cycle.py:56-146), without cv2 or scikit-learn, which
the card's machine lacks:

- preprocessing: a centre crop to 1024x1912, the 0.25x resize (linear
  for images: at 4x it is cv2's uint8 rule ``(a + b + c + d + 2) // 4``
  over the central 2x2 of each 4x4 block; nearest for masks: the block's
  top-left pixel), Cityscapes labelIds -> trainIds through the label
  table, GTA colour masks -> trainIds through the colour table
  (asserting no unknown colour), saving
  ``preprocessed/{images,labels}/<id>.npy`` and the vis PNGs; PNGs are
  read with :func:`values_tpu_torch.core.image_io.read_png` (cv2's
  arrays) and the vis PNGs written with ``write_png_rgb``;
- splits: GTA-only training: Cityscapes train cities are the
  ood_unlabeled_pool, val cities the ood_test, an equal-size random GTA
  id_unlabeled_pool, 25% of the rest GTA id_test, 5 folds on the rest
  (:func:`values_tpu_torch.data.preprocess3d.kfold_indices`, scikit-
  learn's shuffled ``KFold``); entries are (filename, "gta" | "cs").

CLI: ``python -m values_tpu_torch.data.gta_preprocess preprocess
--dataset_path <raw> --save_path <out> --dataset gta|cityscapes`` and
``... splits --dataset_path <out> --original_dataset_path <raw>``.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..core.image_io import read_png, write_png_rgb
from ..core.io import subfiles
from . import cityscapes_labels as cs_labels
from .preprocess3d import kfold_indices

CROP = (1024, 1912)
CORRUPT_GTA_FILES = ("15188.png", "17705.png")


def center_crop(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = arr.shape[:2]
    y = max(0, (h - height) // 2)
    x = max(0, (w - width) // 2)
    return arr[y:y + height, x:x + width]


def _check_quarter(arr: np.ndarray) -> None:
    if arr.shape[0] % 4 or arr.shape[1] % 4:
        raise ValueError(f"the 0.25x resize takes sides that are multiples "
                         f"of 4, got {arr.shape[:2]}")


def quarter_linear(image: np.ndarray) -> np.ndarray:
    """cv2.resize(image, fx=0.25, fy=0.25, INTER_LINEAR) of a uint8 image:
    each output pixel samples the centre of a 4x4 block, between its rows
    and columns 1 and 2, with weights 1/2 rounded half up."""
    _check_quarter(image)
    h, w = image.shape[:2]
    blocks = image.reshape(h // 4, 4, w // 4, 4, *image.shape[2:])
    centre = blocks[:, 1:3, :, 1:3].astype(np.uint16)
    return ((centre.sum(axis=(1, 3)) + 2) // 4).astype(np.uint8)


def quarter_nearest(mask: np.ndarray) -> np.ndarray:
    """cv2.resize(mask, fx=0.25, fy=0.25, INTER_NEAREST): the top-left
    pixel of each 4x4 block."""
    _check_quarter(mask)
    return np.ascontiguousarray(mask[::4, ::4])


def color_mask_to_train_ids(mask_color: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB -> trainIds through a 24-bit key table; unknown
    colours give 128."""
    keys = (mask_color[..., 0].astype(np.int32) << 16) \
        | (mask_color[..., 1].astype(np.int32) << 8) \
        | mask_color[..., 2].astype(np.int32)
    table = np.full(1 << 24, 128, dtype=np.int32)
    for color, train_id in cs_labels.color2trainId.items():
        table[(color[0] << 16) | (color[1] << 8) | color[2]] = train_id
    return table[keys]


def label_ids_to_train_ids(mask_labels: np.ndarray) -> np.ndarray:
    out = mask_labels.copy()
    for k, v in cs_labels.id2trainId.items():
        out[mask_labels == k] = v
    return out


def train_ids_to_color(mask_train: np.ndarray) -> np.ndarray:
    color = np.zeros((*mask_train.shape, 3), dtype=np.uint8)
    for k, v in cs_labels.trainId2color.items():
        color[mask_train == k] = np.array(v)
    return color


def _dirs(dataset_dir: Path, dataset: str):
    if dataset != "cityscapes":
        return [dataset_dir / "images"], [dataset_dir / "labels"]
    image_dirs, label_dirs = [], []
    for split in ("train", "val"):
        split_img = dataset_dir / "images" / "leftImg8bit" / split
        split_lbl = dataset_dir / "labels" / "gtFine" / split
        for city in sorted(os.listdir(split_img)):
            if (split_img / city).is_dir():
                image_dirs.append(split_img / city)
                label_dirs.append(split_lbl / city)
    return sorted(image_dirs), sorted(label_dirs)


def preprocess_dataset(dataset_dir: str, save_dir: str,
                       dataset: str) -> int:
    """``dataset`` is 'cityscapes' or 'gta'; returns the number of images
    written (those already there are skipped)."""
    dataset_dir, save_dir = Path(dataset_dir), Path(save_dir)
    out_images = save_dir / "preprocessed" / "images"
    out_labels = save_dir / "preprocessed" / "labels"
    for d in (out_images, out_labels, out_images / "vis",
              out_labels / "vis"):
        os.makedirs(d, exist_ok=True)
    written = 0
    for image_dir, label_dir in zip(*_dirs(dataset_dir, dataset)):
        for image_name in subfiles(image_dir, suffix=".png", join=False):
            if image_name.startswith(".") \
                    or image_name in CORRUPT_GTA_FILES:
                continue
            image_id = (image_name.split("_leftImg8bit")[0]
                        if dataset == "cityscapes"
                        else image_name.split(".")[0])
            if (out_images / f"{image_id}.npy").is_file() and (
                    out_labels / f"{image_id}.npy").is_file():
                continue
            label_name = (f"{image_id}_gtFine_labelIds.png"
                          if dataset == "cityscapes" else image_name)
            image = read_png(image_dir / image_name)[..., ::-1]  # RGB
            mask_raw = read_png(label_dir / label_name)
            if image.shape[:2] != mask_raw.shape[:2]:
                print(f"Different resolutions for {image_name}!")
                continue
            image = quarter_linear(center_crop(image, *CROP).astype(np.uint8))
            mask_raw = center_crop(mask_raw, *CROP)
            if dataset == "cityscapes":
                mask_train = label_ids_to_train_ids(
                    quarter_nearest(mask_raw.astype(np.uint8)))
                mask_color = train_ids_to_color(mask_train)
            else:
                mask_color = quarter_nearest(
                    mask_raw.astype(np.uint8)[..., 2::-1])
                mask_train = color_mask_to_train_ids(mask_color)
                assert 128 not in mask_train, \
                    f"Unknown color value in mask for image {image_name}!"
            np.save(out_images / f"{image_id}.npy", image)
            write_png_rgb(str(out_images / "vis" / f"{image_id}.png"), image)
            np.save(out_labels / f"{image_id}.npy", mask_train)
            write_png_rgb(str(out_labels / "vis" / f"{image_id}.png"),
                          mask_color)
            written += 1
    return written


def create_splits(base_dir: str, orig_base_dir: str, splits_path: str,
                  seed: int = 123, n_splits: int = 5) -> None:
    """(filename, 'gta' | 'cs') tuple splits (gta_cs_splits_first_cycle),
    the JAX package's ``np.random.choice`` streams and folds."""
    np.random.seed(seed)
    base_dir, orig_base_dir = Path(base_dir), Path(orig_base_dir)
    gta_dir = base_dir / "OriginalData" / "preprocessed" / "images"
    cs_dir = base_dir / "CityScapesOriginalData" / "preprocessed" / "images"
    gta_images: List[Tuple[str, str]] = sorted(
        (f, "gta") for f in os.listdir(gta_dir)
        if f.endswith(".npy") and not f.startswith("._"))
    cs_images: List[Tuple[str, str]] = sorted(
        (f, "cs") for f in os.listdir(cs_dir)
        if f.endswith(".npy") and not f.startswith("._"))

    def cs_cities(split):
        root = (orig_base_dir / "CityScapesOriginalData" / "images"
                / "leftImg8bit" / split)
        return sorted(d for d in os.listdir(root) if (root / d).is_dir())

    cs_train_images = [img for city in cs_cities("train")
                       for img in cs_images if city in img[0]]
    cs_test_images = [img for city in cs_cities("val")
                      for img in cs_images if city in img[0]]

    pool_idx = set(np.random.choice(len(gta_images),
                                    size=len(cs_train_images),
                                    replace=False).tolist())
    gta_pool = [img for i, img in enumerate(gta_images) if i in pool_idx]
    gta_rest = [img for i, img in enumerate(gta_images) if i not in pool_idx]
    num_test = int(0.25 * len(gta_rest))
    test_idx = set(np.random.choice(len(gta_rest), size=num_test,
                                    replace=False).tolist())
    gta_test = [img for i, img in enumerate(gta_rest) if i in test_idx]
    gta_train_val = [img for i, img in enumerate(gta_rest)
                     if i not in test_idx]

    splits = []
    for train_idx, _ in kfold_indices(len(gta_train_val), n_splits, seed):
        train_set = set(train_idx.tolist())
        splits.append({
            "train": [img for i, img in enumerate(gta_train_val)
                      if i in train_set],
            "val": [img for i, img in enumerate(gta_train_val)
                    if i not in train_set],
            "id_test": gta_test,
            "ood_test": cs_test_images,
            "id_unlabeled_pool": gta_pool,
            "ood_unlabeled_pool": cs_train_images,
        })
    splits_path = Path(splits_path)
    splits_path.parent.mkdir(parents=True, exist_ok=True)
    with open(splits_path, "wb") as f:
        pickle.dump(splits, f)


def main(argv=None) -> None:
    """CLI: preprocess GTA/Cityscapes or create the first-cycle splits."""
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    prep = sub.add_parser("preprocess")
    prep.add_argument("--dataset_path", required=True)
    prep.add_argument("--save_path", default=None)
    prep.add_argument("--dataset", choices=["cityscapes", "gta"],
                      required=True)
    spl = sub.add_parser("splits")
    spl.add_argument("--dataset_path", required=True)
    spl.add_argument("--original_dataset_path", default=None)
    spl.add_argument("--splits_path", default=None)
    spl.add_argument("--seed", type=int, default=123)
    args = parser.parse_args(argv)
    if args.command == "preprocess":
        n = preprocess_dataset(args.dataset_path,
                               args.save_path or args.dataset_path,
                               args.dataset)
        print(f"preprocessed {n} images")
    else:
        splits_path = args.splits_path or str(
            Path(args.dataset_path) / "splits" / "firstCycle" /
            "splits.pkl")
        create_splits(args.dataset_path,
                      args.original_dataset_path or args.dataset_path,
                      splits_path, seed=args.seed)


if __name__ == "__main__":
    main()
