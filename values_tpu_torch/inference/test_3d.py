"""Where a checkpoint's test data lives.

Two functions of ``values_tpu/inference/test_3d.py`` (:83-120): the data
directory and subject ids of a split, resolved from a checkpoint's
``hyper_parameters`` for the toy and the LIDC layouts. The rest of
``test_3d`` (the sliding-window inference CLI) is not ported yet.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..core.io import load_pickle


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
