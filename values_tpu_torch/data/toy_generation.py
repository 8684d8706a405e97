"""Toy-shapes dataset generation (L0).

Rebuilds the reference's STL-voxelization pipeline (reference:
datasets/toy_data_generation/dataset_generation.py:144-254,
stl_to_nifty.py:82-150) with direct analytic rasterization: the two shipped
assets are a sphere (``ballSphere.stl``) and a cube (``Cube.stl``), which
rasterize exactly without the stltovoxel dependency. The statistical
contract is preserved:

- object resolution ~ U[max(size)/min_ratio, max(size)/max_ratio]
- random in-bounds offset, or over-border placement with random flips
- optional gray value U(0.5, 0.9), Gaussian blur (sigma 2 or 8), background
  noise (uniform noise at half the background voxels)
- multi-rater segmentations by thresholding the blurred object at
  quantile-spaced thresholds (aleatoric ambiguity control,
  dataset_generation.py:144-166)
- file naming ``<idx:04d>.nii.gz`` / ``<idx:04d>_<rater:02d>.nii.gz``

Benchmark cases (Case_1/2/3a/3b) mirror the reference's JSON configs
(datasets/toy_data_generation/configs/*/).

The port's copy of ``values_tpu/data/toy_generation.py``: the same seed
gives the same arrays and files (Python's ``random``, numpy's global
RNG and scipy's ``gaussian_filter``, as there), written by the port's
own ``core/nifti.py``. Run as
``python -m values_tpu_torch.data.toy_generation --base_save_path <dir>
--dataset_name Case_1``.
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

from ..core import nifti


def rasterize_shape(shape_name: str, resolution: int) -> np.ndarray:
    """Binary voxelization of the two reference assets at ``resolution``."""
    if shape_name in ("ballSphere", "sphere", "ballSphere.stl"):
        coords = np.arange(resolution) - (resolution - 1) / 2.0
        x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
        r = (resolution - 1) / 2.0
        return (x ** 2 + y ** 2 + z ** 2 <= r ** 2).astype(np.float32)
    if shape_name in ("Cube", "cube", "Cube.stl"):
        return np.ones((resolution,) * 3, dtype=np.float32)
    raise ValueError(f"Unknown toy shape '{shape_name}'")


def embed_object(offset: Sequence[int], obj: np.ndarray,
                 image_size: Sequence[int]) -> np.ndarray:
    image = np.zeros(tuple(image_size), dtype=np.float32)
    image[offset[0]:offset[0] + obj.shape[0],
          offset[1]:offset[1] + obj.shape[1],
          offset[2]:offset[2] + obj.shape[2]] = obj
    return image


def embed_object_negative_offset(offset: Sequence[int], obj: np.ndarray,
                                 image_size: Sequence[int]) -> np.ndarray:
    """Placement allowing negative offsets (object partially outside;
    stl_to_nifty.py:127-142)."""
    image = np.zeros(tuple(image_size), dtype=np.float32)
    starts = [max(o, 0) for o in offset]
    obj_starts = [0 if o > 0 else -o for o in offset]
    ends = [min(offset[d] + obj.shape[d], image_size[d]) for d in range(3)]
    obj_ends = [obj_starts[d] + (ends[d] - starts[d]) for d in range(3)]
    image[starts[0]:ends[0], starts[1]:ends[1], starts[2]:ends[2]] = (
        obj[obj_starts[0]:obj_ends[0], obj_starts[1]:obj_ends[1],
            obj_starts[2]:obj_ends[2]])
    return image


def add_noise(noise_prob: float, image: np.ndarray) -> np.ndarray:
    """Background noise: uniform noise at ~half the background voxels
    (stl_to_nifty.py:145-150)."""
    prob_array = np.random.rand(*image.shape)
    noise_array = np.random.rand(*image.shape)
    noise_array[prob_array <= noise_prob] = 0
    image = image.copy()
    image[image < 0.1] = noise_array[image < 0.1]
    return image


def rater_thresholds(image: np.ndarray, n_raters: int,
                     all_raters_same: bool = False) -> np.ndarray:
    """Quantile-spaced segmentation thresholds per rater
    (dataset_generation.py:144-160)."""
    if n_raters == 1:
        return np.asarray([0.1])
    if all_raters_same:
        return np.asarray([0.1] * n_raters)
    perc_step = (1 - 0.1) / (n_raters - 1)
    perc_thresholds = np.arange(0.1, 1 + perc_step, perc_step)
    object_ratio = np.count_nonzero(image >= 0.1) / image.size
    perc_thresholds = perc_thresholds * object_ratio
    return np.quantile(image, 1 - perc_thresholds)


@dataclass
class ToyGenConfig:
    input_files: List[str] = field(default_factory=lambda: ["ballSphere.stl"])
    save_path: str = ""
    n_samples: int = 10
    image_size: Tuple[int, int, int] = (64, 64, 64)
    min_object_ratio: int = 5
    max_object_ratio: int = 2
    gauss_sigma: int = 8
    object_gray: bool = False
    blur: bool = False
    noise: bool = False
    segmentation: bool = True
    all_raters_same: bool = False
    n_raters: int = 1
    object_over_border: bool = False
    sample_offset: int = 0
    seed: int = 22


def generate_samples(cfg: ToyGenConfig) -> None:
    """Generate one image folder (+ ``segmentation/`` subfolder)."""
    os.makedirs(cfg.save_path, exist_ok=True)
    image_size = tuple(cfg.image_size) if len(cfg.image_size) == 3 else (
        (cfg.image_size[0],) * 3)
    for sample_idx in range(cfg.n_samples):
        resolution = random.randint(
            int(max(image_size) / cfg.min_object_ratio),
            int(max(image_size) / cfg.max_object_ratio))
        obj = rasterize_shape(cfg.input_files[0], resolution)
        max_offset = [image_size[d] - obj.shape[d] for d in range(3)]
        if not cfg.object_over_border:
            offset = [random.randint(0, max_offset[d]) for d in range(3)]
            image = embed_object(offset, obj, image_size)
        else:
            min_offset = [int(-2 * obj.shape[d] / 3) for d in range(3)]
            rand_number = random.randint(1, 7)
            bits = format(rand_number, "b").zfill(3)
            offset = [
                random.randint(min_offset[d], 0) if int(bits[d])
                else random.randint(0, max_offset[d]) for d in range(3)]
            image = embed_object_negative_offset(offset, obj, image_size)
            if random.random() > 0.5:
                image = np.fliplr(image)
            if random.random() > 0.5:
                image = np.flipud(image)
        if cfg.object_gray:
            image = image * random.uniform(0.5, 0.9)
        if cfg.blur:
            image = gaussian_filter(image, sigma=cfg.gauss_sigma)

        if cfg.segmentation:
            seg_dir = Path(cfg.save_path) / "segmentation"
            seg_dir.mkdir(exist_ok=True)
            thresholds = rater_thresholds(image, cfg.n_raters,
                                          cfg.all_raters_same)
            for rater_idx, thr in enumerate(thresholds):
                seg = np.where(image >= thr, 1, 0).astype(np.intc)
                nifti.save(seg, seg_dir / (
                    f"{cfg.sample_offset + sample_idx:04d}_"
                    f"{rater_idx:02d}.nii.gz"))

        if cfg.noise:
            image = add_noise(0.5, image)
        nifti.save(np.asarray(image, dtype=np.float64), Path(cfg.save_path) /
                   f"{cfg.sample_offset + sample_idx:04d}.nii.gz")


# ----------------------------------------------------------------------
# Benchmark cases (values mirror datasets/toy_data_generation/configs/)
# ----------------------------------------------------------------------
BENCHMARK_CASES = {
    "Case_1": {
        "train": [dict(input_files=["ballSphere.stl"], n_samples=200,
                       image_size=(64, 64, 64), min_object_ratio=5,
                       max_object_ratio=2, gauss_sigma=2, blur=True,
                       noise=False, segmentation=True, n_raters=3, seed=16)],
        "test": [dict(input_files=["ballSphere.stl"], n_samples=20,
                      image_size=(64, 64, 64), min_object_ratio=5,
                      max_object_ratio=2, gauss_sigma=2, blur=True,
                      noise=False, segmentation=True, n_raters=3, seed=5)],
    },
    "Case_2": {
        "train": [dict(input_files=["ballSphere.stl"], n_samples=200,
                       image_size=(64, 64, 64), min_object_ratio=5,
                       max_object_ratio=2, gauss_sigma=8, blur=False,
                       noise=True, segmentation=True, n_raters=1, seed=1)],
        "test": [
            dict(input_files=["ballSphere.stl"], n_samples=7,
                 image_size=(64, 64, 64), min_object_ratio=5,
                 max_object_ratio=2, gauss_sigma=8, object_gray=True,
                 blur=False, noise=True, segmentation=True, n_raters=1,
                 sample_offset=0, seed=14),
            dict(input_files=["ballSphere.stl"], n_samples=7,
                 image_size=(64, 64, 64), min_object_ratio=5,
                 max_object_ratio=2, gauss_sigma=8, blur=True, noise=True,
                 segmentation=True, n_raters=1, sample_offset=7, seed=15),
            dict(input_files=["Cube.stl"], n_samples=7,
                 image_size=(64, 64, 64), min_object_ratio=5,
                 max_object_ratio=2, gauss_sigma=8, blur=False, noise=True,
                 segmentation=True, n_raters=1, sample_offset=14, seed=16),
            dict(input_files=["ballSphere.stl"], n_samples=7,
                 image_size=(64, 64, 64), min_object_ratio=5,
                 max_object_ratio=2, gauss_sigma=8, blur=False, noise=True,
                 segmentation=True, n_raters=1, object_over_border=True,
                 sample_offset=21, seed=17),
        ],
    },
}

_CASE3_TESTS = [
    dict(input_files=["ballSphere.stl"], n_samples=7,
         image_size=(64, 64, 64), min_object_ratio=5, max_object_ratio=2,
         gauss_sigma=8, object_gray=True, blur=False, noise=True,
         segmentation=True, n_raters=1, sample_offset=0, seed=14),
    dict(input_files=["Cube.stl"], n_samples=7, image_size=(64, 64, 64),
         min_object_ratio=5, max_object_ratio=2, gauss_sigma=8, blur=False,
         noise=True, segmentation=True, n_raters=1, sample_offset=7,
         seed=17),
    dict(input_files=["ballSphere.stl"], n_samples=7,
         image_size=(64, 64, 64), min_object_ratio=5, max_object_ratio=2,
         gauss_sigma=8, blur=False, noise=True, segmentation=True,
         n_raters=1, object_over_border=True, sample_offset=14, seed=19),
    dict(input_files=["ballSphere.stl"], n_samples=21,
         image_size=(64, 64, 64), min_object_ratio=5, max_object_ratio=2,
         gauss_sigma=8, blur=False, noise=True, segmentation=True,
         n_raters=1, sample_offset=21, seed=24),
]

# Case_3a/3b: training mixes blurred/ambiguous and clean halves
# (configs/Case_3a, Case_3b)
BENCHMARK_CASES["Case_3a"] = {
    "train": [
        dict(input_files=["ballSphere.stl"], n_samples=100,
             image_size=(64, 64, 64), min_object_ratio=5,
             max_object_ratio=2, gauss_sigma=8, blur=True, noise=True,
             segmentation=True, n_raters=3, sample_offset=0, seed=63),
        dict(input_files=["ballSphere.stl"], n_samples=100,
             image_size=(64, 64, 64), min_object_ratio=5,
             max_object_ratio=2, gauss_sigma=8, blur=False, noise=True,
             segmentation=True, n_raters=3, sample_offset=100, seed=36),
    ],
    "test": list(_CASE3_TESTS),
}
BENCHMARK_CASES["Case_3b"] = {
    "train": BENCHMARK_CASES["Case_3a"]["train"],
    "test": _CASE3_TESTS + [
        dict(input_files=["ballSphere.stl"], n_samples=21,
             image_size=(64, 64, 64), min_object_ratio=5,
             max_object_ratio=2, gauss_sigma=8, blur=True, noise=True,
             segmentation=True, n_raters=3, sample_offset=42, seed=34),
    ],
}


def generate_benchmark_case(dataset_name: str, base_save_path: str) -> None:
    """Generate images{Tr,Ts}/labels{Tr,Ts} for one benchmark case
    (dataset_generation_benchmark.py)."""
    import shutil
    case = BENCHMARK_CASES[dataset_name]
    base = Path(base_save_path) / dataset_name
    for split, ending in (("train", "Tr"), ("test", "Ts")):
        images_dir = base / f"images{ending}"
        labels_dir = base / f"labels{ending}"
        for cfg_dict in case[split]:
            cfg = ToyGenConfig(save_path=str(images_dir), **cfg_dict)
            random.seed(cfg.seed)
            np.random.seed(cfg.seed)
            generate_samples(cfg)
            seg_dir = images_dir / "segmentation"
            if seg_dir.exists():
                labels_dir.mkdir(parents=True, exist_ok=True)
                for f in seg_dir.iterdir():
                    shutil.copy(f, labels_dir / f.name)
                shutil.rmtree(seg_dir)


def main(argv=None) -> None:
    """CLI: generate a benchmark case (dataset_generation_benchmark.py)."""
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--base_save_path", required=True)
    parser.add_argument("--dataset_name", default="Case_1",
                        choices=sorted(BENCHMARK_CASES))
    args = parser.parse_args(argv)
    generate_benchmark_case(args.dataset_name, args.base_save_path)


if __name__ == "__main__":
    main()
