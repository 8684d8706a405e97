"""GTA's evaluation loaders (reference: evaluation/utils/gta.py).

The port's copy of ``values_tpu/evaluation/gta.py``, without cv2:

- :func:`pred_seg_loading`: the 2D tester's colour PNG predictions back
  to trainIds (read with :func:`values_tpu_torch.core.image_io.read_png`,
  which returns cv2's BGR, then turned to RGB, then the colour table);
- :func:`gt_unc_map`: the analytic GT uncertainty of the stochastic label
  switches, the Bernoulli variance p(1 - p) with p = 1/3 at switchable
  classes, (H, W) as the 2D tester's TIF uncertainty maps are. The JAX
  function transposes it (the reference's maps were (W, H)); beside the
  JAX tester's (H, W) maps that fails on GTA's 256x478 images and pairs
  transposed pixels on square ones (ROADMAP.md reference hazard R13).
"""
from __future__ import annotations

import numpy as np

from ..core.image_io import read_png
from ..data import cityscapes_labels as cs_labels
from ..data.gta_preprocess import color_mask_to_train_ids


def pred_seg_loading(pred_seg_path) -> np.ndarray:
    mask_color = read_png(pred_seg_path)[..., 2::-1]  # BGR -> RGB
    return color_mask_to_train_ids(mask_color)


def gt_unc_map(image_id: str, dataloader) -> np.ndarray:
    idx = dataloader.dataset.image_ids.index(image_id)
    label = np.load(str(dataloader.dataset.masks[idx]))
    unc_map = np.zeros_like(label, dtype=np.single)
    for c, p in cs_labels.LABEL_SWITCHES.items():
        init_id = cs_labels.name2trainId[c]
        variance = (1 - p) * np.square(0 - p) + p * np.square(1 - p)
        unc_map[label == init_id] = variance
    return unc_map
