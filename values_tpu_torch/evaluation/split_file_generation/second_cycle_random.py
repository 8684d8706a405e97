"""Random-acquisition baselines for the second AL cycle.

The port's counterpart of
``values_tpu/evaluation/split_file_generation/second_cycle_random.py``
(:21-88; reference: evaluation/split_file_generation/
split_files_second_cycle_random.py), drawn from numpy's global RNG in the
JAX package's call order (``ExperimentDataloader`` seeds it):

- ``random``: a uniform 50% of the unlabeled pools,
- ``best``: every OoD sample, random ID samples up to 50%,
- ``worst``: ID samples only.
"""
from __future__ import annotations

import os
import pickle as pkl
from pathlib import Path
from typing import List

import numpy as np

from ..experiment_dataloader import ExperimentDataloader
from .second_cycle import get_splits_first_cycle, update_splits


def get_samples_to_query_random(splits, acquisition_size: float):
    all_unlabeled = np.concatenate(
        (splits[0]["id_unlabeled_pool"], splits[0]["ood_unlabeled_pool"]))
    num_to_query = int(len(all_unlabeled) * acquisition_size)
    if all_unlabeled.ndim > 1:
        indices = np.random.choice(all_unlabeled.shape[0], num_to_query,
                                   replace=False)
        return [tuple(row) for row in all_unlabeled[indices].tolist()]
    return np.random.choice(all_unlabeled, num_to_query,
                            replace=False).tolist()


def get_samples_to_query_random_best(splits, acquisition_size: float):
    all_unlabeled = np.concatenate(
        (splits[0]["id_unlabeled_pool"], splits[0]["ood_unlabeled_pool"]))
    all_ood = splits[0]["ood_unlabeled_pool"]
    all_id = splits[0]["id_unlabeled_pool"]
    num_to_query = int(len(all_unlabeled) * acquisition_size)
    selected_id = np.random.choice(all_id, num_to_query - len(all_ood),
                                   replace=False)
    return np.concatenate((all_ood, selected_id)).tolist()


def get_samples_to_query_random_worst(splits, acquisition_size: float):
    all_unlabeled = np.concatenate(
        (splits[0]["id_unlabeled_pool"], splits[0]["ood_unlabeled_pool"]))
    all_id = splits[0]["id_unlabeled_pool"]
    num_to_query = int(len(all_unlabeled) * acquisition_size)
    return np.random.choice(all_id, num_to_query, replace=False).tolist()


def get_samples_to_query(splits, random_type: str, acquisition_size: float):
    if random_type == "random":
        return get_samples_to_query_random(splits, acquisition_size)
    if random_type == "best":
        return get_samples_to_query_random_best(splits, acquisition_size)
    if random_type == "worst":
        return get_samples_to_query_random_worst(splits, acquisition_size)
    raise ValueError(f"Unknown random type {random_type}")


def save_splits(new_splits, base_split_path, shift, random_type, seed):
    base_split_path = Path(base_split_path)
    parts = ([shift] if shift is not None else []) + [
        "secondCycle", random_type, random_type]
    save_dir = base_split_path.joinpath(*parts)
    os.makedirs(save_dir, exist_ok=True)
    with open(save_dir / f"splits_seed{seed}.pkl", "wb") as f:
        pkl.dump(new_splits, f)


def generate_split_file(exp_dataloader: ExperimentDataloader,
                        base_splits_path,
                        random_types: List[str]) -> None:
    base_splits_path = Path(base_splits_path)
    shift = exp_dataloader.exp_version.version_params.get("shift")
    for random_type in random_types:
        splits = get_splits_first_cycle(base_splits_path, shift=shift)
        samples_to_query = get_samples_to_query(splits, random_type, 0.5)
        # reference normalizes .nii.gz -> .npy inside its update_splits
        samples_to_query = [
            s if isinstance(s, tuple) else str(s).replace(".nii.gz", ".npy")
            for s in samples_to_query]
        new_splits = update_splits(splits, samples_to_query,
                                   unc_file_ending=".nii.gz")
        save_splits(new_splits=new_splits, base_split_path=base_splits_path,
                    shift=shift, random_type=random_type,
                    seed=exp_dataloader.exp_version.version_params["seed"])
