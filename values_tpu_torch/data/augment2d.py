"""2D augmentation pipeline: an albumentations-compatible transform
registry in numpy.

The port's copy of ``values_tpu/data/augment2d.py`` (reference:
uncertainty_modeling/data/torch_dataloader.py:76-121; the pipelines of
configs/data_augmentations/tta_augmentations.yaml). The same YAML drives
it, and the random streams are the host's python ``random`` and numpy
global RNGs, as in the JAX package, so a seeded batch is byte-equal to
its batch:

- HorizontalFlip(p), PadIfNeeded (centred), RandomCrop, GaussNoise (var
  ~ U(10, 50) on the 0-255 scale), Normalize ((x/255 - mean)/std),
- StochasticLabelSwitches: per image, each of the 5 switch classes flips
  to its ``*_2`` twin with p = 1/3; ``n_reference_samples`` stacked
  masks for multi-rater evaluation (reference: augmentations.py:9-50),
- ToTensorV2: arrays stay channels-last numpy; the tester moves them.

``Rotate`` and ``RandomScale`` need an image warp and resize (cv2 in the
JAX package, which the card's machine lacks) and only the TRAIN pipeline
uses them: they raise ``NotImplementedError`` until 2D training is
ported (ROADMAP.md, Queue 1: "2D").
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import cityscapes_labels as cs_labels


class Transform2D:
    """Base: callable(image=..., mask=...) -> dict, like albumentations."""
    p: float = 0.5

    def __call__(self, image: np.ndarray,
                 mask: Optional[np.ndarray] = None, **_kw) -> Dict[str, Any]:
        if random.random() < self.p:
            image, mask = self.apply(image, mask)
        out = {"image": image}
        if mask is not None:
            out["mask"] = mask
        return out

    def apply(self, image, mask):
        return image, mask


class Compose(Transform2D):
    def __init__(self, transforms: Sequence[Transform2D], p: float = 1.0):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, image, mask=None, **_kw):
        for t in self.transforms:
            out = t(image=image, mask=mask)
            image = out["image"]
            mask = out.get("mask", mask)
        out = {"image": image}
        if mask is not None:
            out["mask"] = mask
        return out


class HorizontalFlip(Transform2D):
    def __init__(self, p: float = 0.5, **_kw):
        self.p = p

    def apply(self, image, mask):
        image = np.ascontiguousarray(image[:, ::-1])
        if mask is not None:
            mask = np.ascontiguousarray(mask[:, ::-1])
        return image, mask


class _TrainOnly(Transform2D):
    """A TRAIN-pipeline transform the port has not ported yet."""

    def __init__(self, *_args, **_kw):
        raise NotImplementedError(
            f"{type(self).__name__} belongs to the 2D training pipeline, "
            "which is not ported yet (ROADMAP.md, Queue 1: '2D')")


class Rotate(_TrainOnly):
    pass


class RandomScale(_TrainOnly):
    pass


class PadIfNeeded(Transform2D):
    def __init__(self, min_height: int, min_width: int,
                 border_mode: int = 0, value: float = 0,
                 mask_value: float = 255, p: float = 1.0, **_kw):
        self.min_height = min_height
        self.min_width = min_width
        self.value = value
        self.mask_value = mask_value
        self.p = 1.0  # albumentations pads unconditionally

    def apply_pad(self, arr, fill):
        h, w = arr.shape[:2]
        pad_h = max(0, self.min_height - h)
        pad_w = max(0, self.min_width - w)
        pads = [(pad_h // 2, pad_h - pad_h // 2),
                (pad_w // 2, pad_w - pad_w // 2)]
        pads += [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pads, constant_values=fill)

    def __call__(self, image, mask=None, **_kw):
        out = {"image": self.apply_pad(image, self.value)}
        if mask is not None:
            out["mask"] = self.apply_pad(mask, self.mask_value)
        return out


class RandomCrop(Transform2D):
    def __init__(self, height: int, width: int, p: float = 1.0, **_kw):
        self.height = height
        self.width = width
        self.p = 1.0

    def __call__(self, image, mask=None, **_kw):
        h, w = image.shape[:2]
        y = random.randint(0, max(0, h - self.height))
        x = random.randint(0, max(0, w - self.width))
        out = {"image": image[y:y + self.height, x:x + self.width]}
        if mask is not None:
            out["mask"] = mask[y:y + self.height, x:x + self.width]
        return out


class GaussNoise(Transform2D):
    def __init__(self, var_limit=(10.0, 50.0), mean: float = 0,
                 p: float = 0.5, **_kw):
        self.var_limit = var_limit
        self.mean = mean
        self.p = p

    def apply(self, image, mask):
        var = random.uniform(self.var_limit[0], self.var_limit[1])
        noise = np.random.normal(self.mean, var ** 0.5, image.shape)
        return image.astype(np.float32) + noise.astype(np.float32), mask


class Normalize(Transform2D):
    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 max_pixel_value: float = 255.0, p: float = 1.0, **_kw):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.max_pixel_value = max_pixel_value
        self.p = 1.0

    def __call__(self, image, mask=None, **_kw):
        image = (image.astype(np.float32)
                 - self.mean * self.max_pixel_value) / (
            self.std * self.max_pixel_value)
        out = {"image": image}
        if mask is not None:
            out["mask"] = mask
        return out


class ToTensorV2(Transform2D):
    """Contiguous float32 channels-last image; the tester moves it."""

    def __init__(self, **_kw):
        self.p = 1.0

    def __call__(self, image, mask=None, **_kw):
        out = {"image": np.ascontiguousarray(image, dtype=np.float32)}
        if mask is not None:
            out["mask"] = np.ascontiguousarray(mask)
        return out


class StochasticLabelSwitches(Transform2D):
    """Simulated rater ambiguity by class switches (augmentations.py:9-50)."""

    def __init__(self, always_apply: bool = False, p: float = 0.5,
                 n_reference_samples: int = 1, **_kw):
        self.p = 1.0 if always_apply else p
        self.n_reference_samples = n_reference_samples

    def __call__(self, image, mask=None, **_kw):
        out = {"image": image}
        if mask is None:
            return out
        name2id = cs_labels.name2trainId
        masks = []
        for _ in range(self.n_reference_samples):
            mask_copy = np.array(mask).copy()
            for c, p in cs_labels.LABEL_SWITCHES.items():
                if np.random.binomial(1, p, 1)[0]:
                    mask_copy[mask_copy == name2id[c]] = name2id[c + "_2"]
            masks.append(mask_copy)
        out["mask"] = np.array(masks) if len(masks) > 1 else masks[0]
        return out


_REGISTRY = {cls.__name__: cls for cls in [
    Compose, HorizontalFlip, Rotate, RandomScale, PadIfNeeded, RandomCrop,
    GaussNoise, Normalize, ToTensorV2, StochasticLabelSwitches]}


def get_augmentations_from_config(augmentations: List) -> List[Transform2D]:
    """Build the pipeline from the YAML spec (torch_dataloader.py:76-121)."""
    trans: List[Transform2D] = []
    for augmentation in augmentations:
        for name, parameters in dict(augmentation).items():
            parameters = dict(parameters or {})
            if name not in _REGISTRY:
                print(f"No Operation Found: {name}")
                continue
            if "transforms" in parameters:
                inner = get_augmentations_from_config(
                    parameters.pop("transforms"))
                trans.append(_REGISTRY[name](transforms=inner, **parameters))
            else:
                trans.append(_REGISTRY[name](**parameters))
    return trans
