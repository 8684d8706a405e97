"""Second-cycle AL split generation: the top 50% most uncertain unlabeled
samples move into the training split.

The port's counterpart of
``values_tpu/evaluation/split_file_generation/second_cycle.py`` (:24-123;
reference: evaluation/split_file_generation/
split_files_second_cycle.py:13-156), on the host in numpy. Saved as
``<base>/[<shift>/]secondCycle/<model>/<unc>/<agg>/splits_seed<seed>.pkl``;
plain filename splits (toy, LIDC) and (filename, "gta"|"cs") tuple splits
both, the pools and the training split left as the numpy arrays that
``np.delete``/``np.append`` make of them.
"""
from __future__ import annotations

import json
import os
import pickle as pkl
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..experiment_dataloader import ExperimentDataloader
from ..sorting import sort_uncertainties


def get_splits_first_cycle(base_split_path, shift: Optional[str] = None):
    base_split_path = Path(base_split_path)
    if shift is not None:
        save_path = base_split_path / shift / "firstCycle" / "splits.pkl"
    else:
        save_path = base_split_path / "firstCycle" / "splits.pkl"
    with open(save_path, "rb") as f:
        return pkl.load(f)


def get_aggregated_uncertainties(aggregated_unc_path):
    with open(aggregated_unc_path) as f:
        return json.load(f)


def get_samples_to_query(sorted_uncertainties: List[str],
                         acquisition_size: float) -> List[str]:
    num_to_query = int(len(sorted_uncertainties) * acquisition_size)
    return sorted_uncertainties[:num_to_query]


def _pool_index(pool, sample, is_tuple: bool):
    if not is_tuple:
        return np.argwhere(np.asarray(pool) == sample)
    split_compare = np.array([s[0] for s in pool])
    return np.argwhere(split_compare == sample[0])


def update_splits(splits, samples_to_query, unc_file_ending: str):
    samples_to_query = [s.replace(unc_file_ending, ".npy")
                        for s in samples_to_query]
    num_unlabeled_before = (len(splits[0]["id_unlabeled_pool"])
                            + len(splits[0]["ood_unlabeled_pool"]))
    num_train_before = len(splits[0]["train"])
    is_tuple = isinstance(splits[0]["train"][0], tuple)
    if is_tuple:
        samples_to_query = [
            (s, "gta") if s[0].isdigit() else (s, "cs")
            for s in samples_to_query]
    for sample in samples_to_query:
        placed = False
        for pool_name in ("id_unlabeled_pool", "ood_unlabeled_pool"):
            pool = splits[0][pool_name]
            contains = (sample in pool) if not is_tuple else (
                sample[0] in [s[0] for s in pool])
            if not contains:
                continue
            sample_index = _pool_index(pool, sample, is_tuple)
            if sample_index.size > 1:
                print(f"Sample {sample} found multiple times")
            else:
                splits[0][pool_name] = np.delete(
                    np.asarray(splits[0][pool_name]),
                    sample_index[0][0], axis=0)
                if not is_tuple:
                    splits[0]["train"] = np.append(splits[0]["train"], sample)
                else:
                    splits[0]["train"] = np.append(
                        np.asarray(splits[0]["train"]), [sample], axis=0)
            placed = True
            break
        if not placed:
            print(f"Could not find sample {sample}!")
    num_unlabeled_after = (len(splits[0]["id_unlabeled_pool"])
                           + len(splits[0]["ood_unlabeled_pool"]))
    assert num_unlabeled_after == num_unlabeled_before - len(samples_to_query)
    assert len(splits[0]["train"]) == num_train_before + len(samples_to_query)
    return splits


def save_splits(new_splits, base_split_path, shift, pred_model, uncertainty,
                aggregation, seed) -> None:
    base_split_path = Path(base_split_path)
    parts = ([shift] if shift is not None else []) + [
        "secondCycle", pred_model, uncertainty, aggregation]
    save_dir = base_split_path.joinpath(*parts)
    os.makedirs(save_dir, exist_ok=True)
    with open(save_dir / f"splits_seed{seed}.pkl", "wb") as f:
        pkl.dump(new_splits, f)


def generate_split_file(exp_dataloader: ExperimentDataloader,
                        base_splits_path) -> None:
    base_splits_path = Path(base_splits_path)
    shift = exp_dataloader.exp_version.version_params.get("shift")
    for unc, aggregated_unc_path in (
            exp_dataloader.get_aggregated_unc_files_dict().items()):
        for aggregation in exp_dataloader.exp_version.aggregations:
            splits = get_splits_first_cycle(base_splits_path, shift=shift)
            uncertainties = get_aggregated_uncertainties(aggregated_unc_path)
            sorted_uncertainties = sort_uncertainties(uncertainties,
                                                      aggregation)
            samples_to_query = get_samples_to_query(sorted_uncertainties, 0.5)
            new_splits = update_splits(
                splits, samples_to_query,
                unc_file_ending=exp_dataloader.exp_version.unc_ending)
            save_splits(new_splits=new_splits,
                        base_split_path=base_splits_path, shift=shift,
                        pred_model=exp_dataloader.exp_version.pred_model,
                        uncertainty=unc, aggregation=aggregation,
                        seed=exp_dataloader.exp_version.version_params["seed"])
