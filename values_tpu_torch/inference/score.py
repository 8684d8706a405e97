"""Scores-only inference CLI: per-volume Dice and C3 scores, no per-voxel
volumes written.

Counterpart of ``values_tpu/inference/score.py:42-220`` (reference:
test_3D.py:399-534 -> aggregate_uncertainties.py:13-96 -> per-image
score JSONs), for the OoD-detection, failure-detection and
active-learning test beds, which consume image-level scores only. It
reads the checkpoints (native or reference ``.ckpt``; several form a
deep ensemble), resolves the split's volumes from the first checkpoint's
``hyper_parameters``, scores them in batches on the card and writes one
JSON of ``{subject: {row: value}}`` in :func:`score_rows` order.

The scorer follows the checkpoint: an ``aleatoric_loss`` ensemble goes to
:func:`~values_tpu_torch.inference.scoring.make_aleatoric_scorer` (K1 +
K3) with the checkpoint's ``n_aleatoric_samples``, any other UNet3D
ensemble to :func:`~values_tpu_torch.inference.scoring.make_scorer` (K1
+ K2). Each batch draws its sampling seed from one ``torch.Generator``
seeded with the checkpoint's ``seed``, so the same command writes the
same JSON. Single-window volumes only; multi-window volumes need the
sliding-window path.

Usage:
    python -m values_tpu_torch.inference.score \\
        --checkpoint_paths ckpt1 ckpt2 ... -i <data> --out scores.json \\
        --test_split id [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.io import load_json, save_json
from ..core.seed import make_generator, set_seed
from ..data.samples import get_val_test_data_samples
from ..models.ensemble_unet3d import cast_weights
from ..models.torch_import import group_member_state_dicts
from ..training.checkpoint import load_any_checkpoint
from . import scoring
from .test_3d import (dir_and_subjects_from_train,
                      dir_and_subjects_from_train_lidc)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the ROADMAP.md item that ports the CLI's other scorers
SCORERS = "The MC-dropout, TTA and SSN scorers"


def score_cli(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_paths", type=str, nargs="+",
                        required=True)
    parser.add_argument("-i", "--data_input_dir", type=str, default=None)
    parser.add_argument("--out", type=str, required=True,
                        help="output JSON path")
    parser.add_argument("--test_split", type=str, default="id")
    parser.add_argument("--n_pred", type=int, default=None,
                        help="stochastic passes (MC dropout) / SSN "
                        "samples; not ported yet beyond 1")
    parser.add_argument("--test_time_augmentations", "-tta", dest="tta",
                        action="store_true", help="not ported yet")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="volumes per scorer call")
    parser.add_argument("--agg_patch", type=int, default=10)
    parser.add_argument("--threshold", type=float, default=0.3,
                        help="scalar threshold for all three "
                        "uncertainty classes (ignored with "
                        "--threshold_path)")
    parser.add_argument("--threshold_path", type=str, default=None,
                        help="threshold_analysis.json: per-class "
                        "thresholds keyed by --pred_model")
    parser.add_argument("--pred_model", type=str, default="Ensemble",
                        help="threshold_analysis.json row to use")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(DTYPES))
    parser.add_argument("--devices", type=str, default=None,
                        help="data-parallel scoring over N cards; not "
                        "ported yet beyond 1")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to score on (cuda, or cpu for "
                        "the kernels' plain versions)")
    return parser.parse_args(argv)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to values_tpu_torch yet (ROADMAP.md, Queue 1: "
        f"{item!r}); use values_tpu.inference.score")


def build_scorer(hparams: Dict, members: int, args, device
                 ) -> Tuple[Callable, List[str]]:
    """Pick the scorer for the checkpoint's uncertainty method, as
    ``values_tpu/inference/score.py::_build_scorer`` (:79-124) does.
    Returns ``(score(weights, volumes, gt, seed), rows)``. ``--n_pred >
    1`` on a model without dropout has no scorer in either package and
    raises ValueError; the scorers not ported yet raise
    NotImplementedError."""
    patch = hparams["datamodule"]["patch_size"]
    threshold = args.threshold
    if args.threshold_path:
        # per-class thresholds, reference scheme: "Mean <class> threshold"
        # with PE->predictive, EE->aleatoric, MI->epistemic
        tj = load_json(args.threshold_path)[args.pred_model]
        threshold = tuple(tj[f"Mean {c} threshold"]
                          for c in ("predictive", "aleatoric", "epistemic"))
    common = dict(agg_patch=args.agg_patch, threshold=threshold,
                  dtype=DTYPES[args.dtype], device=device)
    target = str(hparams["model"].get("_target_", ""))
    aleatoric = bool(hparams.get("aleatoric_loss"))
    if "ssn" in target.lower():
        raise _not_ported("the SSN scorer", SCORERS)
    if args.tta:
        if aleatoric:
            raise ValueError(
                "TTA on an aleatoric-head checkpoint is not a reference "
                "C1 family; drop -tta")
        raise _not_ported("the TTA scorer (-tta)", SCORERS)
    if aleatoric:
        return scoring.make_aleatoric_scorer(
            members, patch,
            n_aleatoric_samples=hparams.get("n_aleatoric_samples", 10),
            **common)
    if args.n_pred and args.n_pred > 1:
        if not hparams["model"].get("do_dropout", False):
            raise ValueError(
                "--n_pred > 1 needs a dropout model (MC dropout); this "
                "checkpoint's model has do_dropout=False")
        raise _not_ported("the MC-dropout scorer (--n_pred > 1)", SCORERS)
    score, rows = scoring.make_scorer(members, patch, **common)
    return (lambda weights, volumes, gt, seed: score(weights, volumes, gt),
            rows)


def _volumes_by_image(hparams: Dict, args) -> Dict[str, List[Dict]]:
    """The split's window samples grouped by image; raises for volumes
    with more than one window."""
    datamodule = hparams["datamodule"]
    is_lidc = "shift_feature" in datamodule
    if is_lidc:
        test_data_dir, subject_ids = dir_and_subjects_from_train_lidc(
            hparams, args, args.test_split)
    else:
        test_data_dir, subject_ids = dir_and_subjects_from_train(hparams,
                                                                 args)
    samples = get_val_test_data_samples(
        base_dir=test_data_dir, subject_ids=subject_ids,
        test=args.test_split not in ("val", "train"),
        num_raters=datamodule["num_raters"],
        patch_size=datamodule["patch_size"],
        patch_overlap=datamodule["patch_overlap"],
        label_suffix="_mask" if is_lidc else "", flat_dirs=is_lidc)
    by_image: Dict[str, List[Dict]] = {}
    for s in samples:
        by_image.setdefault(s["image_path"], []).append(s)
    multi = [p for p, ws in by_image.items() if len(ws) > 1]
    if multi:
        raise ValueError(
            f"{len(multi)} volumes have >1 sliding window (e.g. "
            f"{os.path.basename(multi[0])}); the scores-only path takes "
            "single-window volumes")
    return by_image


def run_score(args) -> Dict[str, Dict[str, float]]:
    if args.devices not in (None, "1"):
        raise _not_ported("data-parallel scoring (--devices)",
                          "torch.distributed")
    device = resolve_device(args.device)
    loaded = [load_any_checkpoint(p) for p in args.checkpoint_paths]
    hparams = loaded[0][0]  # the first member pins the config
    seed = hparams.get("seed", 123)
    set_seed(seed)
    score, rows = build_scorer(hparams, len(loaded), args, device)
    by_image = _volumes_by_image(hparams, args)
    weights = cast_weights(group_member_state_dicts([s for _, s in loaded]),
                           DTYPES[args.dtype], device)
    gen = make_generator(seed)

    paths = sorted(by_image)
    results: Dict[str, Dict[str, float]] = {}
    for i in range(0, len(paths), args.batch_size):
        chunk = paths[i:i + args.batch_size]
        vols = np.stack([np.load(p).astype(np.float32) for p in chunk])
        # all raters: the dice row is the reference's mean over raters
        gt = np.stack([np.stack([np.load(lp) for lp in
                                 by_image[p][0]["label_paths"]])
                       for p in chunk])
        if gt.dtype.kind not in "iu":
            gt = gt.astype(np.int32)
        batch_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        out = score(weights, torch.from_numpy(vols[..., None]).to(device),
                    torch.from_numpy(gt).to(device), batch_seed)
        out = out.cpu().numpy()
        for j, p in enumerate(chunk):
            subject = os.path.basename(p).rsplit(".", 1)[0]
            results[subject] = {r: float(out[k, j])
                                for k, r in enumerate(rows)}
    save_json(results, args.out)
    print(f"wrote {len(results)} volumes x {len(rows)} scores -> {args.out}")
    return results


def main(argv=None) -> None:
    run_score(score_cli(argv))


if __name__ == "__main__":
    main()
