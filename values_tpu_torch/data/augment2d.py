"""2D augmentation pipeline: an albumentations-compatible transform
registry in numpy.

The port's copy of ``values_tpu/data/augment2d.py`` (reference:
uncertainty_modeling/data/torch_dataloader.py:76-121; the pipelines of
configs/data_augmentations/tta_augmentations.yaml). The same YAML drives
it, and the random streams are the host's python ``random`` and numpy
global RNGs, drawn in the JAX package's order, so a seeded batch equals
its batch:

- HorizontalFlip(p), PadIfNeeded (centred), RandomCrop, GaussNoise (var
  ~ U(10, 50) on the 0-255 scale), Normalize ((x/255 - mean)/std),
- Rotate(limit, border 0, mask 255) and RandomScale (scale 1 + U(limit)):
  the JAX package runs cv2's ``warpAffine`` and ``resize``; the card's
  machine has no cv2, so :func:`warp_rotate` and :func:`resize` redo
  them in numpy by cv2's rules: the image bilinear at the inverse-mapped
  point, 0 outside (cv2 rounds that point to 1/32 pixel: within 1.5e-3 of
  it on 0-255 values), the mask at ``floor(src + 0.5)``, 255 outside; the
  resize at half-pixel centres clamped at the edges (linear), the mask
  at ``floor(x * (1 / (dst / src)))`` (nearest),
- StochasticLabelSwitches: per image, each of the 5 switch classes flips
  to its ``*_2`` twin with p = 1/3; ``n_reference_samples`` stacked
  masks for multi-rater evaluation (reference: augmentations.py:9-50),
- ToTensorV2: arrays stay channels-last numpy; the caller moves them.
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


def _rotation_matrix(center, angle: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, 1.0): the 2x3 map of a
    source point to its destination, angle in degrees, counter-
    clockwise."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a), np.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _source_points(matrix: np.ndarray, h: int, w: int):
    """The source (x, y) of every destination pixel, float64 (H, W): the
    inverse of the 2x3 ``matrix`` applied, as cv2.warpAffine does."""
    a, t = matrix[:, :2], matrix[:, 2]
    inv = np.linalg.inv(a)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dx, dy = xs - t[0], ys - t[1]
    return inv[0, 0] * dx + inv[0, 1] * dy, inv[1, 0] * dx + inv[1, 1] * dy


def warp_rotate(image: np.ndarray, mask: Optional[np.ndarray],
                angle: float, value: float, mask_value: float):
    """The JAX ``Rotate``'s two warpAffine calls: the float32 image
    bilinear at each destination's source point (samples outside the
    image are ``value``), the mask at the nearest source pixel
    (``mask_value`` outside), as int64."""
    h, w = image.shape[:2]
    sx, sy = _source_points(
        _rotation_matrix((w / 2 - 0.5, h / 2 - 0.5), angle), h, w)
    img = image.astype(np.float32)
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    out = np.zeros(img.shape, dtype=np.float32)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            sample = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            inside = inside[..., None] if img.ndim == 3 else inside
            out += wy * wx * np.where(inside, sample, np.float32(value))
    if mask is None:
        return out, None
    xn = np.floor(sx + 0.5).astype(np.int64)
    yn = np.floor(sy + 0.5).astype(np.int64)
    inside = (xn >= 0) & (xn < w) & (yn >= 0) & (yn < h)
    m = mask.astype(np.float32)[np.clip(yn, 0, h - 1), np.clip(xn, 0, w - 1)]
    return out, np.where(inside, m, np.float32(mask_value)).astype(np.int64)


def _linear_taps(dst: int, src: int):
    """cv2.resize's INTER_LINEAR taps along one axis: the source at
    half-pixel centres, clamped at both edges; (i0, i1, weight of i1)."""
    scale = 1.0 / (dst / src)
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    frac[i0 < 0] = 0
    i0 = np.clip(i0, 0, src - 1)
    frac[i0 >= src - 1] = 0
    return i0, np.minimum(i0 + 1, src - 1), frac


def resize(image: np.ndarray, mask: Optional[np.ndarray], size):
    """The JAX ``RandomScale``'s two cv2.resize calls to ``size`` = (W,
    H): the float32 image bilinear, the mask nearest (as int64)."""
    w, h = size
    img = image.astype(np.float32)
    x0, x1, fx = _linear_taps(w, img.shape[1])
    y0, y1, fy = _linear_taps(h, img.shape[0])
    if img.ndim == 3:
        fx = fx[:, None]
    rows = img[:, x0] * (1 - fx) + img[:, x1] * fx
    fy = fy.reshape((-1,) + (1,) * (rows.ndim - 1))
    out = rows[y0] * (1 - fy) + rows[y1] * fy
    if mask is None:
        return out, None
    xn = np.minimum(np.floor(np.arange(w) * (1.0 / (w / mask.shape[1]))
                             ).astype(np.int64), mask.shape[1] - 1)
    yn = np.minimum(np.floor(np.arange(h) * (1.0 / (h / mask.shape[0]))
                             ).astype(np.int64), mask.shape[0] - 1)
    return out, mask.astype(np.float32)[yn[:, None], xn].astype(np.int64)


class Rotate(Transform2D):
    def __init__(self, limit: float = 90, border_mode: int = 0,
                 value: float = 0, mask_value: float = 255, p: float = 0.5,
                 **_kw):
        self.limit = limit if isinstance(limit, (list, tuple)) else (
            -limit, limit)
        self.value = value
        self.mask_value = mask_value
        self.p = p

    def apply(self, image, mask):
        angle = random.uniform(self.limit[0], self.limit[1])
        return warp_rotate(image, mask, angle, self.value, self.mask_value)


class RandomScale(Transform2D):
    def __init__(self, scale_limit=(-0.1, 0.1), p: float = 0.5, **_kw):
        self.scale_limit = (scale_limit if isinstance(scale_limit,
                                                      (list, tuple))
                            else (-scale_limit, scale_limit))
        self.p = p

    def apply(self, image, mask):
        scale = 1.0 + random.uniform(self.scale_limit[0],
                                     self.scale_limit[1])
        h, w = image.shape[:2]
        return resize(image, mask, (int(w * scale), int(h * scale)))


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
