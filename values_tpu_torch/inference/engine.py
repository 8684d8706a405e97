"""Sliding-window inference engine: window gather -> C1 forward -> ordered
stitching, on the device, one volume at a time.

The port's counterpart of ``values_tpu/inference/engine.py`` (:29-590;
reference hot loop: test_3D.py:399-483 + data_carrier_3D.py:99-179) for
the ``default`` and ``aleatoric`` modes. Each volume is staged on the
device once; its windows run in chunks of ``window_batch`` through the
predictor, and each chunk's stacks are stitched in window order
(:func:`~values_tpu_torch.ops.window.stitch_windows`) and added to the
volume's sums, as the JAX engine adds its chunk programs' outputs. Only
the assembled volumes go back to the host, as the reference-layout numpy
arrays the carrier takes.

The forward: the M members run as M channel groups of one fused forward
(:func:`~values_tpu_torch.inference.predictors.make_predictor`), M = 1
included, so every 3x3x3 conv is K1 on the card. Where the JAX package
picks between its grouped Pallas forward and a vmapped flax apply, the
port has that one lowering: ``backend`` takes the JAX CLI's
``auto``/``xla``/``pallas`` and chooses nothing. Stacks leave the
predictor in float32 (float64 in a float64 run, which is CPU-only: K1
has no float64 regime). The coverage map (window counts, or summed
Gaussian weights) is stitched once per volume over all its windows.

``mesh`` (window or sample sharding over several devices) is ROADMAP.md
Queue 1's "torch.distributed" item and raises NotImplementedError.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.ensemble_unet3d import cast_weights, group_member_variables
from ..models.unet3d import UNet3D
from ..ops.window import (count_map, enumerate_window_starts,
                          extract_windows, gaussian_weight_map,
                          stitch_windows)
from ..training.checkpoint import to_torch_tree
from .carrier import VolumeCarrier
from .predictors import make_predictor, not_ported, total_passes

BACKENDS = ("auto", "xla", "pallas")


class SlidingWindowEngine:
    """Runs one C1 prediction mode over full volumes.

    Args:
        model: the port's :class:`~values_tpu_torch.models.unet3d.UNet3D`
            built from the checkpoint's config; its head must suit
            ``mode`` (``aleatoric_loss`` for "aleatoric").
        variables_list: M flax-layout member trees (``{"params": ...}``,
            numpy or tensors); M > 1 is a deep ensemble.
        mode: "default" | "aleatoric".
        patch_size / patch_overlap: the reference's window stride.
        window_batch: windows per forward; the last chunk is ragged.
        dtype: float32, bfloat16, or float64 (the CPU parity mode).
        seed: seeds the generator of the aleatoric normals.
        weight_mode: "uniform" (the reference's count average) or
            "gaussian" (a separable Gaussian importance map, sigma =
            patch / 8).
        shape_bucket: pad each volume dim up to a multiple (outputs are
            cropped back; identical on the original extent).
        device: the card unless ``"cpu"`` is asked for.

    :meth:`run_samples` loads and stages the next volume on a worker
    thread while the current one runs.
    """

    def __init__(self, model: Any, variables_list: List[Any],
                 mode: str = "default", n_pred: int = 1,
                 n_aleatoric_samples: int = 10, patch_size: int = 64,
                 patch_overlap: float = 1.0, window_batch: int = 8,
                 dtype: torch.dtype = torch.float32, seed: int = 123,
                 mesh: Any = None,
                 weight_mode: str = "uniform", backend: str = "auto",
                 shape_bucket: Optional[int] = None, device=None):
        if mesh is not None:
            raise not_ported("window or sample sharding over a mesh",
                             "torch.distributed")
        if weight_mode not in ("uniform", "gaussian"):
            raise ValueError(f"unknown weight_mode {weight_mode!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if type(model) is not UNet3D:
            raise TypeError(f"the engine runs the port's UNet3D, not "
                            f"{type(model).__name__}")
        if (mode == "aleatoric") != bool(getattr(model, "aleatoric_loss",
                                                 False)):
            raise ValueError(f"the {mode!r} mode needs a model "
                             + ("with" if mode == "aleatoric" else "without")
                             + " the aleatoric head")
        self.total_samples = total_passes(mode, len(variables_list), n_pred,
                                          n_aleatoric_samples)
        self.device = resolve_device(device)
        if dtype == torch.float64 and self.device.type == "cuda":
            raise ValueError("float64 is the CPU parity mode: K1 has no "
                             "float64 regime on the card")
        self.model = model
        self.n_models = len(variables_list)
        self.mode = mode
        self.n_pred = n_pred
        self.n_aleatoric_samples = n_aleatoric_samples
        self.patch_size = patch_size
        self.patch_overlap = patch_overlap
        self.window_batch = window_batch
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.weight_mode = weight_mode
        self.shape_bucket = shape_bucket
        grouped = to_torch_tree(
            group_member_variables(variables_list)["params"])
        self.stacked_variables = cast_weights(grouped, dtype, self.device)
        self.predictor = make_predictor(mode, self.n_models, n_pred,
                                        n_aleatoric_samples)

    def _window_weight(self, dtype: torch.dtype) -> Optional[torch.Tensor]:
        """(p, p, p) stitching weight, or None for uniform."""
        if self.weight_mode != "gaussian":
            return None
        return gaussian_weight_map(self.patch_size, dtype=dtype,
                                   device=self.device)

    def _coverage(self, starts: np.ndarray, vol_shape,
                  dtype: torch.dtype) -> torch.Tensor:
        """(*vol) window count, or summed Gaussian weight, over all of a
        volume's windows."""
        return count_map(starts, self.patch_size, vol_shape,
                         weight=self._window_weight(dtype), dtype=dtype,
                         device=self.device)

    # -----------------------------------------------------------------
    def _stage_volume(self, volume: np.ndarray):
        """Shape-bucket pad and copy to the device in the engine's type.
        Thread-safe (the prefetch thread stages the next volume)."""
        orig_shape = tuple(volume.shape)
        if self.shape_bucket:
            q = int(self.shape_bucket)
            bucketed = tuple(-(-dim // q) * q for dim in orig_shape)
            if bucketed != orig_shape:
                volume = np.pad(volume, [(0, b - d) for d, b in
                                         zip(orig_shape, bucketed)])
        volume_dev = torch.as_tensor(np.asarray(volume)).to(
            device=self.device, dtype=self.dtype)
        return volume_dev, tuple(volume.shape), orig_shape

    def _chunk(self, volume_dev, part: np.ndarray, vol_shape):
        """One chunk of windows: (stitched softmax (*vol, S, C), stitched
        sigma or None, stitched data (*vol))."""
        windows = extract_windows(volume_dev, part, self.patch_size)
        probs, sigma = self.predictor(self.stacked_variables,
                                      windows[..., None], self.generator)
        wmap = self._window_weight(self.dtype)
        if wmap is not None:
            probs = probs * wmap[..., None]
            windows = windows * wmap
            if sigma is not None:
                sigma = sigma * wmap[..., None]

        def stitch_stack(stack):  # (S, N, p, p, p, C) -> (*vol, S, C)
            return stitch_windows(stack.permute(1, 2, 3, 4, 0, 5), part,
                                  vol_shape + stack.shape[:1]
                                  + stack.shape[-1:])

        return (stitch_stack(probs),
                None if sigma is None else stitch_stack(sigma),
                stitch_windows(windows, part, vol_shape))

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def run_volume(self, volume: Optional[np.ndarray],
                   labels: Optional[np.ndarray] = None,
                   starts: Optional[np.ndarray] = None,
                   staged: Optional[tuple] = None):
        """Predict one volume. Returns reference-layout numpy arrays:
        (softmax_sums (S, C, *vol), counts (*vol), data_sums (*vol),
        seg_sums (R, *vol) | None, sigma_sums (S, C, *vol) | None).
        ``staged``: a (volume_dev, vol_shape, orig_shape) from
        :meth:`_stage_volume` (the prefetch path)."""
        with torch.inference_mode():
            return self._run_volume(volume, labels, starts, staged)

    def _run_volume(self, volume, labels, starts, staged):
        volume_dev, vol_shape, orig_shape = (
            staged if staged is not None else self._stage_volume(volume))
        if starts is None:
            starts = enumerate_window_starts(orig_shape, self.patch_size,
                                             self.patch_overlap)
        starts = np.asarray(starts, dtype=np.int32)
        # the ragged last chunk runs unpadded: a repeated window would
        # inflate the raw sums that C2 takes (test_3D.py:486-534)
        chunk = max(1, self.window_batch)
        total = None
        for i in range(0, len(starts), chunk):
            out = self._chunk(volume_dev, starts[i:i + chunk], vol_shape)
            total = list(out) if total is None else [
                None if a is None else a + b for a, b in zip(total, out)]
        stitched, sigma_stitched, data_sums = total
        counts = self._coverage(starts, vol_shape, self.dtype)

        softmax_sums = stitched.permute(3, 4, 0, 1, 2)
        sigma_sums = (None if sigma_stitched is None
                      else sigma_stitched.permute(3, 4, 0, 1, 2))
        if self.weight_mode == "gaussian":
            # hand on weighted averages with a unit count map, so every
            # reference formula downstream takes them as they are
            denom = torch.where(counts == 0, torch.ones_like(counts), counts)
            softmax_sums = softmax_sums / denom
            data_sums = data_sums / denom
            if sigma_sums is not None:
                sigma_sums = sigma_sums / denom
            counts = torch.ones_like(counts)

        seg_sums = None
        if labels is not None:
            seg_sums = self._stitch_labels(labels, starts, vol_shape)
        if vol_shape != orig_shape:  # crop the bucketing pad off
            sl = tuple(slice(0, dim) for dim in orig_shape)
            softmax_sums = softmax_sums[(slice(None), slice(None)) + sl]
            counts, data_sums = counts[sl], data_sums[sl]
            if sigma_sums is not None:
                sigma_sums = sigma_sums[(slice(None), slice(None)) + sl]
            if seg_sums is not None:
                seg_sums = seg_sums[(slice(None),) + sl]
        return (self._host(softmax_sums), self._host(counts),
                self._host(data_sums),
                None if seg_sums is None else self._host(seg_sums),
                None if sigma_sums is None else self._host(sigma_sums))

    def _stitch_labels(self, labels: np.ndarray, starts: np.ndarray,
                       vol_shape) -> torch.Tensor:
        """(R, *vol) rater label sums over all windows at once; with
        Gaussian weights the integer labels, recovered from their
        weighted average."""
        lab = torch.from_numpy(labels.astype(np.float32)).to(
            self.device).permute(1, 2, 3, 0)     # windows lie inside it
        windows = extract_windows(lab, starts, self.patch_size)
        wmap = self._window_weight(torch.float32)
        if wmap is not None:
            windows = windows * wmap[..., None]
        seg = stitch_windows(windows, starts, vol_shape + (labels.shape[0],)
                             ).permute(3, 0, 1, 2)
        if wmap is None:
            return seg
        wsum = self._coverage(starts, vol_shape, torch.float32)
        return torch.round(seg / torch.where(wsum == 0,
                                             torch.ones_like(wsum), wsum))

    # -----------------------------------------------------------------
    def run_samples(self, data_samples: Sequence[Dict],
                    carrier: Optional[VolumeCarrier] = None
                    ) -> VolumeCarrier:
        """Fill a carrier from reference-format window samples (one dict
        per window with image_path / label_paths / crop_idx), grouped per
        image."""
        carrier = carrier or VolumeCarrier(self.device)
        by_image: Dict[str, Dict] = {}
        for sample in data_samples:
            entry = by_image.setdefault(sample["image_path"], {
                "label_paths": sample.get("label_paths"), "crops": []})
            entry["crops"].append(sample["crop_idx"])
        items = list(by_image.items())

        def load_item(idx: int) -> Tuple:
            image_path, entry = items[idx]
            labels = None
            if entry["label_paths"]:
                labels = np.stack([np.load(lp) for lp in
                                   entry["label_paths"]]).astype(np.intc)
            starts = np.asarray([[c[0][0], c[1][0], c[2][0]]
                                 for c in entry["crops"]], dtype=np.int32)
            return (image_path, entry,
                    self._stage_volume(np.load(image_path)), labels, starts)

        def consume(loaded) -> None:
            image_path, entry, staged, labels, starts = loaded
            softmax_sums, counts, data_sums, seg_sums, sigma_sums = (
                self.run_volume(None, labels, starts, staged=staged))
            carrier.add_volume(image_path, entry["label_paths"], data_sums,
                               seg_sums, softmax_sums, counts, sigma_sums)

        if len(items) <= 1:
            for idx in range(len(items)):
                consume(load_item(idx))
            return carrier
        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(load_item, 0)
            for idx in range(len(items)):
                loaded = future.result()
                if idx + 1 < len(items):
                    future = pool.submit(load_item, idx + 1)
                consume(loaded)
        return carrier
