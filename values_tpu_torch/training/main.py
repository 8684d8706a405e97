"""Training CLI.

The port's counterpart of ``values_tpu/training/main.py`` (reference:
uncertainty_modeling/main.py:33-88), with the same arguments and
``--device``:

    python -m values_tpu_torch.training.main --config-name softmax_config \\
        [--config-dir configs] [--device cuda|cpu] [key=value ...]

Environment overrides as in the reference: DATASET_LOCATION,
EXPERIMENT_LOCATION, LSB_JOBID -> version. Without ``--device cpu`` it
needs a CUDA card.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..config import compose
from .loops import fit

DEFAULT_CONFIG_DIR = str(Path(__file__).resolve().parents[2] / "configs")


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", "-cn", default="softmax_config")
    parser.add_argument("--config-dir", "-cd", default=DEFAULT_CONFIG_DIR)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda, or cpu for "
                        "the kernels' plain versions)")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)

    cfg = compose(args.config_dir, args.config_name, args.overrides)
    ckpt = fit(cfg, device=args.device)
    print(f"Training done. Final checkpoint: {ckpt}")
    return ckpt


if __name__ == "__main__":
    main()
