"""Full-resolution 2D sliding-window inference.

Counterpart of ``values_tpu/inference/window2d.py``: windows of an
(C, H, W) image go through the model, their softmaxes are added into the
image at their places, and each pixel is divided by the number of
windows that cover it.

- :func:`enumerate_window_starts_2d` and :func:`predict_sliding_2d`
  (:25-43, :212-231): the flush-to-edge grid, stride = patch x overlap,
  the last window of an axis flushed to the image's edge; an axis shorter
  than the patch is reflect-padded and cropped back.
- :class:`SlidingPredictor2D` (:72-209), which the 2D tester uses, takes
  ANOTHER grid: it snaps each stride down to a divisor of the patch,
  pads the image at the bottom and right so that the grid is regular
  (reflect, or edge where a pad reaches the image's size, :195-202),
  averages over that padded grid and crops. A real HRNet gives different
  maps on the two grids, so the port keeps this one.

The port takes the stitch's result, not the JAX package's TPU layout
(its parity-class quilt): windows are cut by slicing, run
``window_batch`` at a time, and added back by slicing in window order.
A stochastic model (``DROPOUT_FINAL``) draws its masks from the
generator for each batch of windows, so they differ per window and per
pass.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def enumerate_window_starts_2d(shape_hw: Sequence[int],
                               patch_hw: Sequence[int],
                               overlap: float = 0.5) -> np.ndarray:
    """(N, 2) window start corners; stride = patch * overlap, the last
    window flushed to the edge. An axis shorter than the patch yields
    start 0 (callers pad such axes; see :func:`predict_sliding_2d`)."""
    if not 0 < overlap <= 1:
        raise ValueError(f"overlap must be in (0, 1], got {overlap}")
    axes = []
    for dim, p in zip(shape_hw, patch_hw):
        stride = max(1, int(p * overlap))
        starts = list(range(0, max(dim - p, 0) + 1, stride))
        if starts[-1] != max(dim - p, 0):
            starts.append(max(dim - p, 0))
        axes.append(starts)
    return np.array([(a, b) for a in axes[0] for b in axes[1]],
                    dtype=np.int32)


def pad_bottom_right(image: torch.Tensor, hp: int, wp: int,
                     mode: str) -> torch.Tensor:
    """(C, H, W) -> (C, hp, wp), padded at the bottom and the right as
    ``np.pad`` pads (``"reflect"``, repeated for pads longer than the
    image, or ``"edge"``), by one gather per axis."""
    def index(n: int, total: int) -> torch.Tensor:
        i = torch.arange(total, device=image.device)
        if mode == "edge" or n == 1:
            return i.clamp(max=n - 1)
        period = 2 * (n - 1)
        j = i % period
        return torch.where(j >= n, period - j, j)
    h, w = image.shape[1:]
    return image.index_select(1, index(h, hp)).index_select(2, index(w, wp))


def _stitch(probs_of: Callable[[torch.Tensor], torch.Tensor],
            image: torch.Tensor, starts, patch_hw: Tuple[int, int],
            num_classes: int, window_batch: int) -> torch.Tensor:
    """The count-averaged (num_classes, H, W) float32 map of ``image``
    (C, H, W): windows at ``starts`` through ``probs_of`` (N, C, ph, pw)
    -> (N, num_classes, ph, pw), ``window_batch`` at a time, added back
    in window order."""
    ph, pw = patch_hw
    h, w = image.shape[1:]
    acc = torch.zeros((num_classes, h, w), dtype=torch.float32,
                      device=image.device)
    cnt = torch.zeros((h, w), dtype=torch.float32, device=image.device)
    starts = [(int(a), int(b)) for a, b in starts]
    for i in range(0, len(starts), window_batch):
        chunk = starts[i:i + window_batch]
        wins = torch.stack([image[:, a:a + ph, b:b + pw] for a, b in chunk])
        probs = probs_of(wins).to(torch.float32)
        for (a, b), p in zip(chunk, probs):
            acc[:, a:a + ph, b:b + pw] += p
            cnt[a:a + ph, b:b + pw] += 1.0
    return acc / cnt


def predict_sliding_2d(forward: Callable[[torch.Tensor], torch.Tensor],
                       image: torch.Tensor, patch_hw: Sequence[int],
                       num_classes: int, overlap: float = 0.5
                       ) -> torch.Tensor:
    """Count-averaged sliding-window softmax of one (C, H, W) image on
    the flush-to-edge grid, one window at a time. ``forward``: (1, C, ph,
    pw) -> (1, num_classes, ph, pw) softmax. Returns (num_classes, H,
    W)."""
    ph, pw = int(patch_hw[0]), int(patch_hw[1])
    h, w = image.shape[1:]
    pad_h, pad_w = max(0, ph - h), max(0, pw - w)
    if pad_h or pad_w:
        image = pad_bottom_right(image, h + pad_h, w + pad_w, "reflect")
    starts = enumerate_window_starts_2d(image.shape[1:], (ph, pw), overlap)
    out = _stitch(forward, image, starts, (ph, pw), num_classes, 1)
    return out[:, :h, :w]


class SlidingPredictor2D:
    """Per-model sliding-window softmax on the regular padded grid of
    ``values_tpu/inference/window2d.py::SlidingPredictor2D``. Calling it
    on a (C, H, W) image (on the model's device, in its type) returns the
    (num_classes, H, W) float32 softmax map."""

    def __init__(self, model, patch_hw: Sequence[int], num_classes: int,
                 overlap: float = 0.5, window_batch: int = 8):
        self.model = model
        self.patch_hw = (int(patch_hw[0]), int(patch_hw[1]))
        self.num_classes = int(num_classes)
        self.overlap = float(overlap)
        self.window_batch = int(window_batch)

    def strides(self) -> Tuple[int, int]:
        """patch x overlap per axis, snapped down to a divisor of the
        patch (:106-117)."""
        out = []
        for p in self.patch_hw:
            s = max(1, int(p * self.overlap))
            while p % s:
                s -= 1
            out.append(s)
        return out[0], out[1]

    def grid(self, h: int, w: int) -> Tuple[int, int, str, np.ndarray]:
        """(padded H, padded W, pad mode, (N, 2) row-major starts) of an
        h x w image: each padded axis is patch + k strides, the least
        that covers the image (:190-202)."""
        (ph, pw), (sh, sw) = self.patch_hw, self.strides()
        hp = ph + -(-max(h - ph, 0) // sh) * sh
        wp = pw + -(-max(w - pw, 0) // sw) * sw
        mode = "reflect" if (hp - h < h and wp - w < w) else "edge"
        starts = np.array([(a, b) for a in range(0, hp - ph + 1, sh)
                           for b in range(0, wp - pw + 1, sw)], np.int64)
        return hp, wp, mode, starts

    def __call__(self, image: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        h, w = image.shape[1:]
        hp, wp, mode, starts = self.grid(h, w)
        if hp > h or wp > w:
            image = pad_bottom_right(image, hp, wp, mode)

        def probs_of(wins):
            if wins.is_cuda:
                wins = wins.contiguous(memory_format=torch.channels_last)
            logits = self.model(wins, generator=generator)
            return torch.softmax(logits.to(torch.float32), dim=1)

        out = _stitch(probs_of, image, starts, self.patch_hw,
                      self.num_classes, self.window_batch)
        return out[:, :h, :w]
