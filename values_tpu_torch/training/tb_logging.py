"""TensorBoard logging and experiment-version bookkeeping.

The port's copy of ``values_tpu/training/tb_logging.py``: version
directories follow the logger's ``save_dir/name/version_N`` (or explicit
version) convention. The scalars, hyperparameters and validation panels
go through ``torch.utils.tensorboard`` or, failing that, ``tensorboardX``.
Where neither imports, the scalars are appended to
``<log_dir>/scalars.jsonl`` and each panel is saved as
``<log_dir>/images/<tag>_<step>.npy``, and one line on stderr says so.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np


class _JsonlWriter:
    """The writer used when no TensorBoard package imports."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._file = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._file.write(json.dumps({"tag": tag, "value": value,
                                     "step": step}) + "\n")
        self._file.flush()

    def add_hparams(self, hparams: Dict, metrics: Dict) -> None:
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump(hparams, f, indent=1)

    def add_image(self, tag: str, image: np.ndarray, step: int,
                  dataformats: str = "HWC") -> None:
        path = os.path.join(self.log_dir, "images",
                            f"{tag.replace('/', '_')}_{step}.npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, image)

    def close(self) -> None:
        self._file.close()


def _summary_writer(log_dir: str):
    """A TensorBoard SummaryWriter, or the JSONL writer."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            print(f"tb_logging: neither torch.utils.tensorboard nor "
                  f"tensorboardX imports; scalars go to {log_dir}/"
                  "scalars.jsonl", file=sys.stderr)
            return _JsonlWriter(log_dir)
    return SummaryWriter(log_dir)


class TensorBoardLogger:
    def __init__(self, save_dir: str, name: str = "default",
                 version=None, **_ignored):
        self.save_dir = save_dir
        self.name = name
        self._version = version
        self._writer = None

    @property
    def version(self):
        if self._version is None:
            self._version = self._next_version()
        return self._version

    def _next_version(self) -> int:
        root = os.path.join(self.save_dir, self.name)
        if not os.path.isdir(root):
            return 0
        versions = []
        for d in os.listdir(root):
            if d.startswith("version_"):
                try:
                    versions.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return max(versions) + 1 if versions else 0

    @property
    def log_dir(self) -> str:
        version = self.version
        dirname = (f"version_{version}" if isinstance(version, int)
                   else str(version))
        return os.path.join(self.save_dir, self.name, dirname)

    @property
    def writer(self):
        if self._writer is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._writer = _summary_writer(self.log_dir)
        return self._writer

    def log_scalars(self, metrics: Dict[str, float], step: int) -> None:
        for key, value in metrics.items():
            self.writer.add_scalar(key, float(value), step)

    def log_hparams(self, hparams: Dict) -> None:
        flat = _flatten(hparams)
        self.writer.add_hparams(
            {k: v for k, v in flat.items()
             if isinstance(v, (int, float, str, bool))}, {})

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        self.writer.add_image(tag, image, step, dataformats="HWC")

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.close()


class ProgressBar:
    """Interface stub for the reference's TQDMProgressBar config node."""

    def __init__(self, refresh_rate: int = 10, **_ignored):
        self.refresh_rate = refresh_rate


def _flatten(d: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out
