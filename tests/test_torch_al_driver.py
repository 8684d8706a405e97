"""The port's AL second-cycle driver (values_tpu_torch.evaluation.al_driver)
against the JAX package's: discovery, version names, the composed training
runs with a stand-in fit, the whole loop, the CLI, and one real port fit
at a tiny width (16^3, initial filter size 2, one epoch, on the CPU) on
splits queried from a first LIDC cycle."""
import json
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import values_tpu.evaluation.al_driver as J_DRV
import values_tpu.evaluation.experiment_dataloader as J_DL
import values_tpu.evaluation.experiment_version as J_EV
import values_tpu.evaluation.split_file_generation.second_cycle as J_SC
import values_tpu_torch.evaluation.al_driver as P_DRV
import values_tpu_torch.evaluation.experiment_dataloader as P_DL
import values_tpu_torch.evaluation.experiment_version as P_EV
import values_tpu_torch.evaluation.split_file_generation.second_cycle as P_SC
from values_tpu_torch.core import nifti
from values_tpu_torch.data import lidc
from values_tpu_torch.data.lidc_datamodule import LidcIdriDataModule3D

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = str(ROOT / "configs")


def _fake_second_cycle_tree(base: Path):
    """The JAX package's tests/test_al_driver.py tree: two uncertainty
    queries and one random baseline."""
    trees = [
        ("texture", "secondCycle", "Softmax", "pred_entropy",
         "patch_level"),
        ("texture", "secondCycle", "Softmax", "mutual_information",
         "image_level"),
        ("texture", "secondCycle", "random", "random"),
    ]
    files = []
    for parts in trees:
        d = base.joinpath(*parts)
        d.mkdir(parents=True, exist_ok=True)
        f = d / "splits_seed123.pkl"
        with open(f, "wb") as fh:
            pickle.dump([{"train": ["a.npy"], "val": ["b.npy"],
                          "unlabeled_pool": []}], fh)
        files.append(f)
    return files


def test_discovery_and_version_names_match_jax(tmp_path):
    _fake_second_cycle_tree(tmp_path)
    found = P_DRV.discover_second_cycle_splits(tmp_path)
    assert found == J_DRV.discover_second_cycle_splits(tmp_path)
    assert len(found) == 3
    names = sorted(P_DRV.version_name_for_splits(f) for f in found)
    assert names == sorted(J_DRV.version_name_for_splits(f) for f in found)
    assert names == [
        "secondCycle-Softmax-mutual_information-image_level-seed123",
        "secondCycle-Softmax-pred_entropy-patch_level-seed123",
        "secondCycle-random-random-seed123",
    ]


def test_run_second_cycle_composes_the_jax_training_runs(tmp_path):
    """Every discovered splits file becomes one fit call whose config
    carries datamodule.splits_path and the provenance version, the same
    configs as the JAX driver composes."""
    _fake_second_cycle_tree(tmp_path)
    calls = {"jax": [], "port": []}

    def fake_fit(name):
        def fit(cfg):
            calls[name].append(cfg.to_container())
            return f"/ckpt/{cfg['version']}/last.ckpt"
        return fit

    overrides = ["data_input_dir=/tmp/x", "max_epochs=1"]
    results = P_DRV.run_second_cycle(tmp_path, "softmax_config_lidc",
                                     overrides=overrides,
                                     config_dir=CONFIGS,
                                     fit_fn=fake_fit("port"))
    want = J_DRV.run_second_cycle(tmp_path, "softmax_config_lidc",
                                  overrides=overrides, config_dir=CONFIGS,
                                  fit_fn=fake_fit("jax"))
    assert results == want and len(results) == 3
    assert [(c["datamodule"]["splits_path"], c["version"], c["max_epochs"])
            for c in calls["port"]] == [
        (c["datamodule"]["splits_path"], c["version"], c["max_epochs"])
        for c in calls["jax"]]
    for version, ckpt in results.items():
        assert ckpt == f"/ckpt/{version}/last.ckpt"
    dry = P_DRV.run_second_cycle(tmp_path, "softmax_config_lidc",
                                 config_dir=CONFIGS, dry_run=True)
    assert dry == J_DRV.run_second_cycle(tmp_path, "softmax_config_lidc",
                                         config_dir=CONFIGS, dry_run=True)
    assert set(dry.values()) == {"(dry-run)"}


def test_generate_and_run_full_loop(tmp_path, monkeypatch):
    """generate_and_run drives the query-split generation (uncertainty
    and random baselines) and then trains on everything produced."""
    from values_tpu_torch.evaluation.split_file_generation import (
        second_cycle, second_cycle_random)
    calls = {"unc": 0, "rand": 0, "fits": []}

    def fake_unc(exp_dl, base):
        calls["unc"] += 1
        _fake_second_cycle_tree(Path(base))

    def fake_rand(exp_dl, base, random_types):
        calls["rand"] += 1
        assert random_types == ["random", "best", "worst"]

    monkeypatch.setattr(second_cycle, "generate_split_file", fake_unc)
    monkeypatch.setattr(second_cycle_random, "generate_split_file",
                        fake_rand)

    class FakeDL(P_DL.ExperimentDataloader):  # bypass the heavy __init__
        def __init__(self):
            pass

    def fake_fit(cfg):
        calls["fits"].append(cfg["version"])
        return "ck"

    results = P_DRV.generate_and_run(
        FakeDL(), tmp_path, "softmax_config_lidc",
        overrides=["data_input_dir=/tmp/x"], config_dir=CONFIGS,
        fit_fn=fake_fit)
    assert calls["unc"] == 1 and calls["rand"] == 1
    assert len(results) == 3 and sorted(calls["fits"]) == sorted(results)


def test_cli_lists_runs_and_trains_on_the_card_by_default(tmp_path, capsys):
    """--dry-run prints every run; without --device the CLI trains on
    CUDA, and raises before it reads data where there is no card."""
    _fake_second_cycle_tree(tmp_path)
    args = ["--splits", str(tmp_path), "--config", "softmax_config_lidc",
            "--config-dir", CONFIGS]
    results = P_DRV.main(args + ["--dry-run"])
    out = capsys.readouterr().out
    assert len(results) == 3
    for version in results:
        assert f"{version}: (dry-run)" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P_DRV.main(args + ["--train-override", "data_input_dir=/none"])
    P_DRV.main(["--splits", str(tmp_path / "empty"), "--config",
                "softmax_config_lidc", "--config-dir", CONFIGS])
    assert "no secondCycle splits found" in capsys.readouterr().out


# ---------------------------------------------------------------------
# one real second-cycle fit on the CPU
# ---------------------------------------------------------------------
P, PATIENTS, NODULES, ID_PATIENTS = 16, 20, 2, 15


def _write_lidc(root: Path) -> None:
    """PATIENTS x NODULES 16^3 crops with 4 rater masks, metadata.csv and
    id_ood.csv (the first ID_PATIENTS patients' textures read ID)."""
    rs = np.random.RandomState(8)
    grid = np.indices((P,) * 3).astype(np.float32)
    features = ["subtlety", "internal Structure", "calcification",
                "sphericity", "margin", "lobulation", "spiculation",
                "texture", "malignancy"]
    rows = []
    for p in range(PATIENTS):
        for n in range(NODULES):
            image_id = f"{p:04d}_{n:02d}"
            center = rs.uniform(6, 10, 3)[:, None, None, None]
            dist = np.sqrt(((grid - center) ** 2).sum(0))
            radius = rs.uniform(2, 4)
            nifti.save((-800 + 900 * (dist < radius)
                        + 60 * rs.randn(*dist.shape)).astype(np.float32),
                       root / "images" / f"{image_id}.nii.gz")
            segs = []
            for r in range(4):
                path = root / "labels" / f"{image_id}_{r:02d}_mask.nii.gz"
                nifti.save((dist < radius + r - 1.5).astype(np.intc), path)
                segs.append(str(path))
            row = {"Patient ID": f"LIDC-IDRI-{p:04d}", "Scan ID": f"{p:04d}",
                   "Nodule Index": f"{n:02d}",
                   "Image Save Path": str(root / "images"
                                          / f"{image_id}.nii.gz"),
                   "Segmentation Save Paths": str(segs)}
            row.update({f: str([3, 3, 3, 3]) for f in features})
            row["texture"] = str([int(v) for v in (
                rs.randint(3, 6, 4) if p < ID_PATIENTS
                else rs.randint(1, 3, 4))])
            rows.append(row)
    lidc.write_table(str(root / "metadata.csv"), list(rows[0]), rows)
    lidc.calculate_rater_agreement(str(root))


def test_second_cycle_trains_on_queried_splits_on_the_cpu(tmp_path):
    """A first LIDC cycle's splits, a patch-level query of its unlabeled
    pools (the port's split file equal to the JAX package's), and
    run_second_cycle on the CPU: one tiny fit whose datamodule trains on
    the queried training split."""
    data = tmp_path / "LIDC"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    _write_lidc(data)
    splits_base = tmp_path / "splits"
    first = splits_base / "texture" / "firstCycle" / "splits.pkl"
    first.parent.mkdir(parents=True)
    lidc.create_first_cycle_splits(str(first), "texture",
                                   str(data / "id_ood.csv"))
    with open(first, "rb") as f:
        fold = pickle.load(f)[0]
    unlabeled = [s.split(".")[0] for s in
                 list(fold["id_unlabeled_pool"])
                 + list(fold["ood_unlabeled_pool"])]
    assert len(unlabeled) >= 4

    # the first cycle's unlabeled results: ids and patch-level scores
    rng = np.random.RandomState(1)
    results = tmp_path / "FirstCycle"
    split_dir = (results / "Ensemble" / "test_results"
                 / "texture_fold0_seed123" / "unlabeled")
    (split_dir / "pred_seg").mkdir(parents=True)
    scores = {}
    for image_id in unlabeled:
        (split_dir / "pred_seg" / f"{image_id}_mean.nii.gz").write_bytes(b"")
        scores[f"{image_id}.nii.gz"] = {
            "patch_level": {"max_score": float(rng.rand())}}
    (split_dir / "aggregated_predictive_uncertainty.json").write_text(
        json.dumps(scores))

    query = "texture/secondCycle/Ensemble/predictive_uncertainty/" \
        "patch_level/splits_seed123.pkl"
    got = {}
    for name, ev, dl, sc in (("jax", J_EV, J_DL, J_SC),
                             ("port", P_EV, P_DL, P_SC)):
        version = ev.ExperimentVersion(
            base_path=results, naming_scheme_version="{shift}_fold{fold}_"
            "seed{seed}", pred_model="Ensemble", image_ending=".nii.gz",
            unc_ending=".nii.gz", unc_types=["predictive_uncertainty"],
            aggregations=["patch_level"], n_reference_segs=4,
            shift="texture", fold=0, seed="123")
        sc.generate_split_file(dl.ExperimentDataloader(version, "unlabeled"),
                               splits_base)
        with open(splits_base / query, "rb") as f:
            got[name] = pickle.load(f)
    for key in got["jax"][0]:
        assert np.array_equal(got["port"][0][key], got["jax"][0][key]), key
    queried = got["port"][0]["train"]
    assert len(queried) == len(fold["train"]) + len(unlabeled) // 2

    runs = P_DRV.run_second_cycle(
        splits_base, "softmax_config_lidc", config_dir=CONFIGS,
        device="cpu", overrides=[
            f"data_input_dir={data}", f"save_dir={tmp_path / 'exp'}",
            "max_epochs=1", "batch_size=4", "datamodule.patch_size=16",
            "datamodule.batch_size=4", "datamodule.num_workers=0",
            "model.initial_filter_size=2"])
    version = "secondCycle-Ensemble-predictive_uncertainty-patch_level-" \
        "seed123"
    assert list(runs) == [version]
    with open(runs[version], "rb") as f:
        payload = pickle.load(f)
    hparams = payload["hyper_parameters"]
    assert hparams["version"] == version
    assert hparams["datamodule"]["splits_path"] == str(splits_base / query)
    leaves = payload["state_dict"]["params"]["final"]
    assert all(np.isfinite(v).all() for v in leaves.values())
    dm = LidcIdriDataModule3D(data_input_dir=str(data), patch_size=16,
                              splits_path=str(splits_base / query))
    dm.setup()
    assert dm.tr_keys == list(queried)
    assert os.path.isdir(data / "preprocessed")
