"""Training CLI.

The port's counterpart of ``values_tpu/training/main.py`` (reference:
uncertainty_modeling/main.py:33-88), with the same arguments and
``--device``:

    python -m values_tpu_torch.training.main --config-name softmax_config \\
        [--config-dir configs] [--device cuda|cpu] [key=value ...]

Environment overrides as in the reference: DATASET_LOCATION,
EXPERIMENT_LOCATION, LSB_JOBID -> version. Without ``--device cpu`` it
needs a CUDA card. The 2D configs train the HRNet-W48 on the GTA tree
that ``python -m values_tpu_torch.data.gta_preprocess`` writes:
``--config-name gta_softmax_config`` (SGD, polynomial learning rate),
``gta_ssn_config`` (RMSprop, ``pretrain_epochs`` mean-only epochs first),
and ``gta_softmax_config model=hrnet_config_dropout_final`` (MC dropout
on the final branches). HRNet training starts from the random
initialisation unless ``MODEL.PRETRAINED`` names a local weights file.

Data parallelism: ``devices=N`` (or the reference's ``gpus=N``) trains
over N ranks, one process a card. Under torchrun (``torchrun
--nproc_per_node N -m values_tpu_torch.training.main ... devices=N``) each
rank joins the world it describes; without a launcher this command
spawns the N local ranks itself. On the CPU (``--device cpu``) the ranks
are processes over gloo.

Precision on the card: K1 and K1b's dx (the hand-written kernels) run
float32 as 3xTF32, float32's accuracy. The float32 convolution outside
them, cuDNN's weight gradient of every 3x3x3 conv, runs under cuDNN's
TF32, PyTorch's default (``torch.backends.cudnn.allow_tf32``), as the
reference's PyTorch code did; matrix products (the k2s2 transposed convs,
the 1x1x1 head) stay float32 (``torch.backends.cuda.matmul.allow_tf32``
defaults off). ``torch.backends.cudnn.allow_tf32 = False`` gives full
float32, where cuDNN's weight gradient becomes most of the step's time
(PERF.md, section 5). The HRNet's 2D convolutions are cuDNN's, all of
them under that same TF32 default.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ..config import compose
from ..core import tracing
from ..parallel.launch import launched, spawn
from .loops import data_parallel_ranks, fit

DEFAULT_CONFIG_DIR = str(Path(__file__).resolve().parents[2] / "configs")


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config-name", "-cn", default="softmax_config")
    parser.add_argument("--config-dir", "-cd", default=DEFAULT_CONFIG_DIR)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda, or cpu for "
                        "the kernels' plain versions)")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)

    cfg = compose(args.config_dir, args.config_name, args.overrides)
    ranks = data_parallel_ranks(cfg, args.device)
    if ranks > 1 and not launched():
        return spawn(_train, (args.config_dir, args.config_name,
                              args.overrides, args.device), ranks)
    with tracing.profiled():
        return _train(args.config_dir, args.config_name, args.overrides,
                      args.device, cfg)


def _train(config_dir: str, config_name: str, overrides, device,
           cfg=None) -> str:
    """Train (as one rank of a spawned world, composing the config
    anew); the final checkpoint's path."""
    if cfg is None:
        cfg = compose(config_dir, config_name, overrides)
    ckpt = fit(cfg, device=device)
    print(f"Training done. Final checkpoint: {ckpt}")
    return ckpt


if __name__ == "__main__":
    main()
