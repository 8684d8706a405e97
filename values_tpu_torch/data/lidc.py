"""LIDC-IDRI dataset construction (L0).

The port's copy of ``values_tpu/data/lidc.py`` (:31-230, with ``main``),
which reads and writes its tables with pandas and splits with
scikit-learn. The port has neither (the card's machine lacks both), so
the tables go through the ``csv`` module with pandas' conventions and the
split is :func:`~values_tpu_torch.data.preprocess3d.kfold_indices`:

1. :func:`save_cropped_nodules` -- extract 64^3 nodule crops with up to 4
   rater masks via pylidc (reference: datasets/lidc-idri/
   save_cropped_nodules.py:26-131). pylidc and the DICOM archive are only
   needed for this offline stage; the function is import-gated.
2. :func:`calculate_rater_agreement` -- majority-vote ID/OoD labeling per
   shift feature -> ``id_ood.csv`` (reference: datasets/lidc-idri/
   id_ood.py:30-86).
3. :func:`create_first_cycle_splits` -- patient-disjoint first-cycle AL
   splits (reference: datasets/lidc-idri/splits_first_cycle.py:51-207):
   OoD patients' OoD nodules split ~50/50 into ood_test and
   ood_unlabeled_pool (by whole patients), id_unlabeled_pool grown to 2x
   the ood pool, 80/20 ID train/test rebalanced by whole patients, a
   5-fold KFold on the rest.

A column read from a CSV takes pandas' ``read_csv`` type (integers,
floats, booleans, else strings; an empty cell is missing), so the same
file gives the same splits in both packages, and the ``id_ood.csv``
written here is pandas' ``to_csv`` of the same table.
"""
from __future__ import annotations

import ast
import csv
import math
import os
import pickle
import random
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from .preprocess3d import kfold_indices


def get_feature_dict() -> Dict[str, Tuple[tuple, tuple]]:
    """(ID rating values, OoD rating values) per shift feature."""
    return {
        "internal Structure": ((1,), (2, 3, 4)),
        "calcification": ((6,), (1, 2, 3, 4, 5)),
        "sphericity": ((3, 4, 5), (1, 2)),
        "lobulation": ((1, 2), (3, 4, 5)),
        "spiculation": ((1, 2), (3, 4, 5)),
        "texture": ((3, 4, 5), (1, 2)),
        "malignancy": ((1, 2, 3), (4, 5)),
    }


# -- tables with pandas' conventions ----------------------------------------------

def _infer_column(cells: Sequence[str]) -> List[Any]:
    """A CSV column's values as ``pandas.read_csv`` types them: all
    present cells integers -> int (float where a cell is missing), all
    floats -> float, all ``True``/``False`` -> bool, else str; an empty
    cell is None."""
    present = [c for c in cells if c != ""]
    if present and all(c in ("True", "False") for c in present):
        return [None if c == "" else c == "True" for c in cells]
    for cast in (int, float):
        try:
            [cast(c) for c in present]
        except ValueError:
            continue
        if cast is int and len(present) < len(cells):
            cast = float
        return [None if c == "" else cast(c) for c in cells]
    return [None if c == "" else c for c in cells]


def read_table(path) -> Tuple[List[str], List[Dict[str, Any]]]:
    """(columns, rows) of a CSV, each column typed by
    :func:`_infer_column`; a leading unnamed column (pandas' index) is
    read like any other."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        body = list(reader)
    columns = [_infer_column([row[i] for row in body])
               for i in range(len(header))]
    rows = [{name: columns[i][r] for i, name in enumerate(header)}
            for r in range(len(body))]
    return header, rows


def _cell(value: Any) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return repr(value) if isinstance(value, float) else str(value)


def write_table(path, columns: Sequence[str], rows: Sequence[Dict],
                index: Sequence[int] = None) -> None:
    """``DataFrame.to_csv``'s text of a table: minimal quoting, ``\\n``
    line ends, with an unnamed index column first when ``index`` is
    given."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(([""] if index is not None else []) + list(columns))
        for i, row in enumerate(rows):
            writer.writerow(([str(index[i])] if index is not None else [])
                            + [_cell(row.get(c)) for c in columns])


# -- the three stages ---------------------------------------------------------------

def save_cropped_nodules(save_path: str) -> None:
    """Extract 64^3 nodule volumes + 4 rater masks + metadata.csv.

    Requires pylidc and a configured LIDC-IDRI DICOM archive; nodules whose
    consensus mask exceeds 64 voxels in any dimension are dropped; all four
    raters share the first annotation's interpolation points; missing
    raters are zero-filled.
    """
    try:
        import pylidc as pl
        import pylidc.utils
    except ImportError as e:
        raise ImportError(
            "save_cropped_nodules needs pylidc (offline extraction stage); "
            "install it alongside the LIDC-IDRI DICOM archive.") from e
    from ..core import nifti

    save_path = Path(save_path)
    images_dir = save_path / "images"
    labels_dir = save_path / "labels"
    images_dir.mkdir(parents=True, exist_ok=True)
    labels_dir.mkdir(parents=True, exist_ok=True)

    features = ["subtlety", "internal Structure", "calcification",
                "sphericity", "margin", "lobulation", "spiculation",
                "texture", "malignancy"]
    columns = ["Patient ID", "Scan ID", "Nodule Index", "Image Save Path",
               "Segmentation Save Paths"] + features
    all_metadata = []
    for scan in pl.query(pl.Scan):
        for nod_idx, nod in enumerate(scan.cluster_annotations()):
            consensus_mask, _, _ = pylidc.utils.consensus(nod, clevel=0.1)
            if max(consensus_mask.shape) > 64:
                continue
            meta = {}
            irp_pts = None
            for ann_idx in range(4):
                if ann_idx == 0:
                    vol, mask, irp_pts = nod[0].uniform_cubic_resample(
                        63, return_irp_pts=True)
                    assert vol.shape == (64, 64, 64)
                    image_path = images_dir / (
                        f"{nod[0].scan.id:04d}_{nod_idx:02d}.nii.gz")
                    nifti.save(vol, image_path)
                    meta.update({
                        "Patient ID": str(nod[0].scan.patient_id),
                        "Scan ID": f"{nod[0].scan.id:04d}",
                        "Nodule Index": f"{nod_idx:02d}",
                        "Image Save Path": str(image_path),
                        "Segmentation Save Paths": [],
                    })
                    for f in features:
                        meta[f] = []
                if ann_idx < len(nod):
                    mask = nod[ann_idx].uniform_cubic_resample(
                        63, resample_vol=False, irp_pts=irp_pts)
                    annotation = nod[ann_idx]
                else:
                    mask = np.zeros([64, 64, 64])
                    annotation = None
                seg_path = labels_dir / (
                    f"{nod[0].scan.id:04d}_{nod_idx:02d}_{ann_idx:02d}"
                    "_mask.nii.gz")
                nifti.save(mask.astype(np.intc), seg_path)
                meta["Segmentation Save Paths"].append(str(seg_path))
                for f in features:
                    meta[f].append(
                        getattr(annotation, f.replace(" ", ""))
                        if annotation is not None else None)
            all_metadata.append(meta)
    write_table(save_path / "metadata.csv", columns, all_metadata)


def calculate_rater_agreement(dataset_path: str, save_df: bool = True
                              ) -> List[Dict[str, Any]]:
    """Majority-vote ID/OoD labeling of ``metadata.csv``: the rows whose
    every feature has all its ratings, each with ``<feature>_id`` in
    {True, False, None} (None: a tie). Written to ``id_ood.csv`` with the
    rows' indices in ``metadata.csv``."""
    dataset_path = Path(dataset_path)
    columns, rows = read_table(dataset_path / "metadata.csv")
    kept = list(enumerate(rows))
    features = get_feature_dict()
    for column, (id_values, _) in features.items():
        for _, row in kept:
            ratings = ast.literal_eval(row[column])
            row[column] = None if "None" in str(ratings) else ratings
        kept = [(i, row) for i, row in kept if row[column] is not None]
        for _, row in kept:
            binarized = [1 if r in id_values else 0 for r in row[column]]
            majority = binarized.count(0) != binarized.count(1)
            is_id = binarized.count(1) > binarized.count(0)
            row[f"{column}_id"] = bool(is_id) if majority else None
    if save_df:
        write_table(dataset_path / "id_ood.csv",
                    columns + [f"{c}_id" for c in features],
                    [row for _, row in kept], index=[i for i, _ in kept])
    return [row for _, row in kept]


def create_first_cycle_splits(output_path: str, shift_feature: str,
                              metadata_csv: str, seed: int = 123,
                              n_splits: int = 5) -> None:
    """Patient-disjoint AL first-cycle splits of ``id_ood.csv``
    (splits_first_cycle.py:51-207), pickled to ``output_path``."""
    np.random.seed(seed)
    random.seed(seed)
    _, rows = read_table(metadata_csv)
    for row in rows:
        row["Image Save Path"] = (
            f"{str(row['Image Save Path']).split('/')[-1].split('.')[0]}"
            ".npy")
    feature_col = f"{' '.join(shift_feature.split('_'))}_id"

    def truthy(v):
        return v in (True, "True")

    def falsy(v):
        return v in (False, "False")

    ood_patients = set(row["Patient ID"] for row in rows
                       if falsy(row[feature_col]))
    id_train_patients = set(
        row["Patient ID"] for row in rows
        if row["Patient ID"] not in ood_patients
        and truthy(row[feature_col]))

    def paths(patients, id_flag):
        flag_fn = truthy if id_flag else falsy
        return [row["Image Save Path"] for row in rows
                if row["Patient ID"] in patients
                and flag_fn(row[feature_col])]

    num_ood_nodules = len(paths(ood_patients, id_flag=False))
    num_unlabeled_pool = num_ood_nodules // 2

    ood_unlabeled_pool, id_unlabeled_pool = [], []
    while len(ood_unlabeled_pool) < num_unlabeled_pool:
        patient = random.choice(sorted(ood_patients))
        ood_patients.remove(patient)
        ood_unlabeled_pool.extend(paths({patient}, id_flag=False))
        id_unlabeled_pool.extend(paths({patient}, id_flag=True))

    ood_test = paths(ood_patients, id_flag=False)
    id_test = paths(ood_patients, id_flag=True)
    id_train = paths(id_train_patients, id_flag=True)

    all_id_cases = len(id_train) + len(id_test)
    num_id_test = all_id_cases - int(0.8 * all_id_cases)
    nodules_to_add_test = []
    while len(nodules_to_add_test) < num_id_test - len(id_test):
        patient = random.choice(sorted(id_train_patients))
        id_train_patients.remove(patient)
        nodules_to_add_test.extend(paths({patient}, id_flag=True))
    id_test = id_test + nodules_to_add_test

    num_to_add = 2 * len(ood_unlabeled_pool) - len(id_unlabeled_pool)
    nodules_to_add_pool = []
    while len(nodules_to_add_pool) < num_to_add:
        patient = random.choice(sorted(id_train_patients))
        id_train_patients.remove(patient)
        nodules_to_add_pool.extend(paths({patient}, id_flag=True))
    id_unlabeled_pool.extend(nodules_to_add_pool)

    id_train = [p for p in id_train
                if p not in nodules_to_add_test
                and p not in nodules_to_add_pool]

    splits = []
    for train_idx, val_idx in kfold_indices(len(id_train), n_splits, seed):
        splits.append({
            "train": np.array(id_train)[train_idx],
            "val": np.array(id_train)[val_idx],
            "id_test": id_test,
            "ood_test": np.array(ood_test),
            "id_unlabeled_pool": np.array(id_unlabeled_pool),
            "ood_unlabeled_pool": np.array(ood_unlabeled_pool),
        })
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "wb") as f:
        pickle.dump(splits, f)


def main(argv=None) -> None:
    """CLI: LIDC extraction / ID-OoD labeling / first-cycle splits."""
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    ext = sub.add_parser("extract")
    ext.add_argument("--save_path", "-s", required=True)
    lab = sub.add_parser("id_ood")
    lab.add_argument("--dataset_path", "-d", required=True)
    spl = sub.add_parser("splits")
    spl.add_argument("--dataset_path", "-d", default=None)
    spl.add_argument("--id_ood_csv", default=None)
    spl.add_argument("--splits_path", default=None)
    spl.add_argument("--feature", default="texture")
    spl.add_argument("--seed", type=int, default=123)
    args = parser.parse_args(argv)
    if args.command == "extract":
        save_cropped_nodules(args.save_path)
    elif args.command == "id_ood":
        calculate_rater_agreement(args.dataset_path, save_df=True)
    else:
        id_ood_csv = args.id_ood_csv or str(
            Path(args.dataset_path) / "id_ood.csv")
        splits_path = args.splits_path or str(
            Path(args.dataset_path) / "splits" / args.feature /
            "firstCycle" / "splits.pkl")
        create_first_cycle_splits(splits_path, args.feature, id_ood_csv,
                                  seed=args.seed)


if __name__ == "__main__":
    main()
