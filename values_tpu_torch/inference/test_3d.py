"""3D inference CLI (C1 + C2): checkpoint-driven, reference-compatible.

The port's counterpart of ``values_tpu/inference/test_3d.py`` (:29-240;
reference: test_3D.py:28-120, 625-701). Everything is rebuilt from the
checkpoint's ``hyper_parameters``: model, data directories, splits,
window geometry, save paths. Several ``--checkpoint_paths`` form a deep
ensemble. Native (JAX pickle) and reference ``.ckpt`` files both load.
The volumes run through
:class:`~values_tpu_torch.inference.engine.SlidingWindowEngine` on the
card, and :class:`~values_tpu_torch.inference.carrier.VolumeCarrier`
writes the nii.gz maps and ``metrics.json``:

    python -m values_tpu_torch.inference.test_3d \\
        --checkpoint_paths ckpt1 ckpt2 ... -i <data> --save_dir <out> \\
        --test_split val [--dtype float32|bfloat16] [--device cpu]

The JAX CLI's arguments, plus ``--device`` (default ``cuda``; without a
card only ``--device cpu`` runs). ``--dtype float64`` is the CPU parity
mode. ``-tta``, SSN checkpoints and ``--n_pred > 1`` are ROADMAP.md
Queue 1's "The MC-dropout, TTA and SSN scorers" and raise
NotImplementedError; ``--sliding_window`` belongs to the 2D tester.
``--backend`` and ``--no-grouped-ensemble`` are accepted and choose
nothing: the port has one lowering, the grouped forward on K1.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Tuple

import torch

from ..config import instantiate, make_config
from ..core.device import resolve_device
from ..core.io import load_pickle
from ..core.seed import set_seed
from ..data.samples import get_val_test_data_samples
from ..models.torch_import import unet3d_params_from_torch
from ..training.checkpoint import load_any_checkpoint
from .carrier import VolumeCarrier
from .engine import BACKENDS, SlidingWindowEngine
from .predictors import not_ported

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def test_cli(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_paths", type=str, nargs="+",
                        required=True)
    parser.add_argument("-i", "--data_input_dir", type=str, default=None)
    parser.add_argument("--save_dir", type=str, default=None)
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--test_data_dir", type=str, default=None)
    parser.add_argument("--subject_ids", type=str, nargs="*", default=None)
    parser.add_argument("--n_pred", type=int, default=1,
                        help="stochastic passes; not ported yet beyond 1")
    parser.add_argument("--n_reference_samples", type=int, default=5)
    parser.add_argument("--test_batch_size", type=int, default=12, nargs="?",
                        help="windows per forward (the last chunk is "
                        "ragged)")
    parser.add_argument("--test_split", type=str, default="id")
    parser.add_argument("--test_time_augmentations", "-tta", dest="tta",
                        action="store_true", help="not ported yet")
    parser.add_argument("--no-grouped-ensemble", dest="grouped_ensemble",
                        action="store_false", default=True,
                        help="accepted for the JAX CLI's sake; the port "
                        "always runs the members as channel groups of one "
                        "forward")
    parser.add_argument("--weight_mode", type=str, default="uniform",
                        choices=("uniform", "gaussian"),
                        help="stitching weight for overlapping windows: "
                        "uniform (reference parity) or a Gaussian "
                        "importance map")
    parser.add_argument("--backend", type=str, default="auto",
                        choices=BACKENDS,
                        help="accepted for the JAX CLI's sake; the port has "
                        "one lowering, K1")
    parser.add_argument("--sliding_window", type=int, nargs=2, default=None,
                        metavar=("PH", "PW"), help="2D tester only")
    parser.add_argument("--sliding_overlap", type=float, default=0.5,
                        help="2D tester only")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=sorted(DTYPES),
                        help="engine compute dtype; float64 is the CPU "
                        "parity mode")
    parser.add_argument("--shape_bucket", type=int, default=None,
                        help="pad volume dims up to this multiple (outputs "
                        "are cropped back; numerically identical)")
    parser.add_argument("--seed", type=int, default=None,
                        help="override the sampling seed (default: the "
                        "checkpoint's hparams seed)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, or cpu for the "
                        "kernels' plain versions)")
    return parser.parse_args(argv)



def dir_and_subjects_from_train(hparams: Dict, args
                                ) -> Tuple[str, List[str]]:
    """Toy layout (reference: test_3D.py:123-155): ``splits.pkl`` under
    the dataset, keyed by fold and ``args.test_split``; the data under
    ``<dataset>/preprocessed``."""
    data_input_dir = args.data_input_dir or hparams["data_input_dir"]
    dataset_name = hparams["datamodule"]["dataset_name"]
    splits = load_pickle(os.path.join(data_input_dir, dataset_name,
                                      "splits.pkl"))
    fold = hparams["datamodule"]["data_fold_id"]
    subject_ids = list(splits[fold][args.test_split])
    return (os.path.join(data_input_dir, dataset_name, "preprocessed"),
            subject_ids)


def dir_and_subjects_from_train_lidc(hparams: Dict, args,
                                     test_split: str = "id"
                                     ) -> Tuple[str, List[str]]:
    """LIDC layout (reference: test_3D.py:158-219): shift-feature splits
    with keys ``{id,ood}_test``, ``val``, ``train`` and the unlabeled
    pools; the data under ``<data_input_dir>/preprocessed``."""
    data_input_dir = args.data_input_dir or hparams["data_input_dir"]
    shift_feature = hparams["datamodule"].get("shift_feature")
    splits_path = hparams["datamodule"].get("splits_path")
    if splits_path:
        if args.data_input_dir is not None:
            splits_path = splits_path.replace(hparams["data_input_dir"],
                                              args.data_input_dir)
    else:
        splits_path = os.path.join(
            data_input_dir,
            f"splits_{shift_feature}.pkl" if shift_feature else "all")
    splits = load_pickle(splits_path)
    fold = hparams["datamodule"]["data_fold_id"]
    if test_split == "unlabeled":
        subject_ids = (list(splits[fold]["id_unlabeled_pool"])
                       + list(splits[fold]["ood_unlabeled_pool"]))
    elif test_split in ("val", "train"):
        subject_ids = list(splits[fold][test_split])
    else:
        subject_ids = list(splits[fold][f"{test_split}_test"])
    return os.path.join(data_input_dir, "preprocessed"), subject_ids


def build_engine(hparams: Dict, variables_list: List, args, device=None
                 ) -> SlidingWindowEngine:
    """The engine of the checkpoint's C1 mode (``default``, or
    ``aleatoric`` for an aleatoric-head model); SSN checkpoints raise."""
    target = str(hparams["model"].get("_target_", ""))
    if "ssn" in target.lower():
        raise not_ported("the SSN C1 mode")
    if args.tta:
        raise not_ported("the TTA C1 mode (-tta)")
    extra = {}
    if hparams.get("aleatoric_loss") is not None:
        extra["aleatoric_loss"] = hparams.get("aleatoric_loss")
    with torch.random.fork_rng(devices=[]):
        model = instantiate(make_config(dict(hparams["model"])), **extra)
    mode = "aleatoric" if getattr(model, "aleatoric_loss", False) \
        else "default"
    engine = SlidingWindowEngine(
        model, variables_list, mode=mode, n_pred=args.n_pred,
        n_aleatoric_samples=hparams.get("n_aleatoric_samples", 10),
        patch_size=hparams["datamodule"]["patch_size"],
        patch_overlap=hparams["datamodule"]["patch_overlap"],
        dtype=DTYPES[args.dtype],
        seed=(args.seed if getattr(args, "seed", None) is not None
              else hparams.get("seed", 123)),
        window_batch=getattr(args, "test_batch_size", 12) or 12,
        weight_mode=getattr(args, "weight_mode", "uniform"),
        backend=getattr(args, "backend", "auto"),
        shape_bucket=getattr(args, "shape_bucket", None),
        device=device if device is not None else args.device)
    return engine


def save_results(carrier: VolumeCarrier, hparams: Dict, args) -> None:
    """The result tree and metrics.json (reference: test_3D.py:578-622)."""
    save_dir = args.save_dir or hparams["save_dir"]
    data_input_dir = args.data_input_dir or hparams["data_input_dir"]
    exp_name = args.exp_name or hparams["exp_name"]
    if "shift_feature" in hparams["datamodule"]:
        org_data_path = os.path.join(data_input_dir, "images")
    elif args.test_data_dir is not None:
        org_data_path = None
    else:
        images_dir = ("imagesTr" if args.test_split in ("val", "train")
                      else "imagesTs")
        org_data_path = os.path.join(
            data_input_dir, hparams["datamodule"]["dataset_name"], images_dir)
    carrier.save_data(root_dir=save_dir, exp_name=exp_name,
                      version=hparams["version"], org_data_path=org_data_path,
                      test_split=args.test_split)
    carrier.log_metrics()


def run_test(args) -> VolumeCarrier:
    device = resolve_device(args.device)
    if args.sliding_window is not None:
        raise not_ported("--sliding_window (the 2D tester's)", "2D")
    all_hparams, all_variables = [], []
    for path in args.checkpoint_paths:
        hparams, state_dict = load_any_checkpoint(path)
        all_hparams.append(hparams)
        all_variables.append(unet3d_params_from_torch(state_dict))
    hparams = all_hparams[0]
    set_seed(hparams.get("seed", 123))
    engine = build_engine(hparams, all_variables, args, device=device)

    is_lidc = "shift_feature" in hparams["datamodule"]
    test_data_dir, subject_ids = args.test_data_dir, args.subject_ids
    if test_data_dir is None:
        if is_lidc:
            test_data_dir, subject_ids = dir_and_subjects_from_train_lidc(
                hparams, args, args.test_split)
        else:
            test_data_dir, subject_ids = dir_and_subjects_from_train(hparams,
                                                                     args)
    data_samples = get_val_test_data_samples(
        base_dir=test_data_dir, subject_ids=subject_ids,
        test=args.test_split not in ("val", "train"),
        num_raters=hparams["datamodule"]["num_raters"],
        patch_size=hparams["datamodule"]["patch_size"],
        patch_overlap=hparams["datamodule"]["patch_overlap"],
        label_suffix="_mask" if is_lidc else "", flat_dirs=is_lidc)

    carrier = engine.run_samples(data_samples)
    if len(all_variables) > 1 or engine.total_samples > 1:
        carrier.compute_uncertainty()
    carrier.compute_metrics()
    save_results(carrier, hparams, args)
    return carrier


def main(argv=None) -> None:
    run_test(test_cli(argv))


if __name__ == "__main__":
    main()
