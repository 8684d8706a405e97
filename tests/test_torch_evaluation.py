"""The port's evaluation test beds (values_tpu_torch.evaluation) against the
JAX package's (values_tpu.evaluation) on the same inputs, made with numpy
from a seed: the port's own roc_curve/auc and Platt fit against
scikit-learn 1.9.0, the metrics against the JAX ones, the task chain
(threshold, aggregation on the host and through the box filter, OoD
detection, failure detection, calibration, ambiguity modeling, both split
generators) on two copies of one reference-layout results tree, every JSON
and split pickle compared, the eval_experiments driver on
eval_config_toy, and the targets the port refuses."""
import copy
import json
import math
import pickle
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
from sklearn.calibration import _sigmoid_calibration as sk_sigmoid
from sklearn.metrics import auc as sk_auc
from sklearn.metrics import roc_curve as sk_roc_curve

from torch_parallel_cases import one_torch_thread  # noqa: F401
import values_tpu.evaluation.aggregate_uncertainties as J_AGG
import values_tpu.evaluation.eval_experiments as J_EVAL
import values_tpu.evaluation.experiment_dataloader as J_DL
import values_tpu.evaluation.experiment_version as J_EV
import values_tpu.evaluation.find_threshold as J_FT
import values_tpu.evaluation.metrics.ace as J_ACE
import values_tpu.evaluation.metrics.al_improvement as J_AL
import values_tpu.evaluation.metrics.auroc as J_AUROC
import values_tpu.evaluation.metrics.aurc as J_AURC
import values_tpu.evaluation.metrics.ncc as J_NCC
import values_tpu.evaluation.sorting as J_SORT
import values_tpu.evaluation.split_file_generation.second_cycle as J_SC
import values_tpu.evaluation.split_file_generation.second_cycle_random as \
    J_SCR
import values_tpu_torch.evaluation.aggregate_uncertainties as P_AGG
import values_tpu_torch.evaluation.eval_experiments as P_EVAL
import values_tpu_torch.evaluation.experiment_dataloader as P_DL
import values_tpu_torch.evaluation.experiment_version as P_EV
import values_tpu_torch.evaluation.find_threshold as P_FT
import values_tpu_torch.evaluation.metrics.ace as P_ACE
import values_tpu_torch.evaluation.metrics.al_improvement as P_AL
import values_tpu_torch.evaluation.metrics.auroc as P_AUROC
import values_tpu_torch.evaluation.metrics.aurc as P_AURC
import values_tpu_torch.evaluation.metrics.ncc as P_NCC
import values_tpu_torch.evaluation.sorting as P_SORT
import values_tpu_torch.evaluation.split_file_generation.second_cycle as P_SC
import values_tpu_torch.evaluation.split_file_generation.second_cycle_random \
    as P_SCR
from values_tpu.config import compose as jax_compose
from values_tpu.core import nifti
from values_tpu_torch.config import compose, locate

ROOT = Path(__file__).resolve().parents[1]
V, RATERS, PATCH = 12, 3, 4  # eval_config_toy: 3 reference segs
JAX = dict(AGG=J_AGG, EVAL=J_EVAL, DL=J_DL, EV=J_EV, FT=J_FT, ACE=J_ACE,
           AL=J_AL, AUROC=J_AUROC, AURC=J_AURC, NCC=J_NCC, SORT=J_SORT,
           SC=J_SC, SCR=J_SCR)
PORT = dict(AGG=P_AGG, EVAL=P_EVAL, DL=P_DL, EV=P_EV, FT=P_FT, ACE=P_ACE,
            AL=P_AL, AUROC=P_AUROC, AURC=P_AURC, NCC=P_NCC, SORT=P_SORT,
            SC=P_SC, SCR=P_SCR)
# image ids by split: the toy OoD rule calls ids <= 20 OoD, so "id" is all
# OoD (one class: NaN AUROC) and "ood" has both classes
SPLITS = {"val": range(0, 4), "id": range(4, 8), "ood": range(18, 24),
          "unlabeled": range(10, 16)}
# the toy layout of configs/evaluation/datasets/toy.yaml at epochs 2
VERSIONS = {"Ensemble": "epochs2_fold0_seed123", "Softmax": "epochs2_seed123"}
UNC_TYPES = {"Ensemble": ["predictive_uncertainty", "aleatoric_uncertainty",
                          "epistemic_uncertainty"],
             "Softmax": ["predictive_uncertainty"]}
FIRST_CYCLE = [{
    "train": np.array(["a.npy", "b.npy"]), "val": np.array(["v.npy"]),
    "id_test": np.array(["t.npy"]), "ood_test": np.array(["o.npy"]),
    "id_unlabeled_pool": np.array([f"{i:04d}.npy" for i in (10, 11, 12, 13)]),
    "ood_unlabeled_pool": np.array([f"{i:04d}.npy" for i in (14, 15)])}]


def _equal(a, b) -> bool:
    """JSON equality with NaN equal to NaN."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return type(a) is type(b) and a == b


def _close(a, b, rtol=0.0, atol=0.0) -> bool:
    """JSON closeness of floats (NaN equal to NaN), other values equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol, atol)
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y, rtol, atol)
                                        for x, y in zip(a, b))
    if isinstance(a, float):
        return bool(np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True))
    return a == b


# ---------------------------------------------------------------------
# the port's roc_curve / auc and Platt fit against scikit-learn
# ---------------------------------------------------------------------
def _roc_case(case):
    rng = np.random.RandomState(5)
    if case == "distinct":
        return rng.randint(0, 2, 40), rng.rand(40)
    if case == "ties":
        return rng.randint(0, 2, 60), np.round(rng.rand(60), 1)
    if case == "all_tied":
        return np.array([0, 1, 1, 0, 1]), np.full(5, 0.3)
    if case == "one_class_ood":
        return np.ones(7, int), rng.rand(7)
    return np.zeros(7, int), rng.rand(7)   # one class, no OoD


@pytest.mark.parametrize("case", ["distinct", "ties", "all_tied",
                                  "one_class_ood", "one_class_id"])
def test_roc_curve_and_auc_match_sklearn(case):
    """The same curve points (one per distinct threshold, collinear ones
    dropped, a leading (0, 0)) and the same area; a split with one class
    gives NaN where scikit-learn does, without raising."""
    y_true, y_score = _roc_case(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = sk_roc_curve(y_true, y_score)
        want_auc = sk_auc(want[0], want[1])
    got = P_AUROC.roc_curve(list(y_true), list(y_score))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got_auc = P_AUROC.auc(got[0], got[1])
    assert _equal(got_auc, want_auc)
    assert math.isnan(got_auc) == case.startswith("one_class")


def _platt_case(case):
    rng = np.random.RandomState(7)
    n = 3000
    unc = rng.rand(n) * 0.7
    correct = (rng.rand(n) > unc).astype(int)
    if case == "float32":
        return -unc.astype(np.float32), correct
    if case == "float64":
        return -unc, correct
    if case == "large":   # max |F| >= 30: the scaled branch
        return -unc * 100.0, correct
    return -unc.astype(np.float32), np.ones(n, int)   # all correct


@pytest.mark.parametrize("case", ["float32", "float64", "large",
                                  "all_correct"])
def test_sigmoid_calibration_matches_sklearn(case):
    """The port's copy of scikit-learn 1.9.0's Platt fit: a and b within
    rtol 1e-5, and the ACE of the calibrated confidences within 1e-5."""
    confid, correct = _platt_case(case)
    a, b = P_ACE._sigmoid_calibration(confid, correct)
    wa, wb = sk_sigmoid(confid, correct)
    np.testing.assert_allclose([a, b], [wa, wb], rtol=1e-5)
    ace = P_ACE.calc_ace(correct, 1 / (1 + np.exp(confid * a + b)))
    want = J_ACE.calc_ace(correct, 1 / (1 + np.exp(confid * wa + wb)))
    assert abs(ace - want) <= 1e-5


def test_half_binomial_loss_is_stable_at_large_raw_predictions():
    """The loss and gradient at |r| up to 1e4 stay finite (no exp
    overflow) and match log1p(exp(r)) - y r where that is finite."""
    r = np.array([-1e4, -40.0, -5.0, 0.0, 5.0, 20.0, 1e4])
    y = np.full(r.shape, 0.75)
    loss, grad = P_ACE._half_binomial_loss_gradient(y, r)
    assert np.isfinite(loss).all() and np.isfinite(grad).all()
    mid = np.abs(r) < 100
    np.testing.assert_allclose(loss[mid], np.logaddexp(0, r[mid]) - y[mid]
                               * r[mid], rtol=1e-12)
    with np.errstate(over="ignore"):
        expit = 1 / (1 + np.exp(-r))
    np.testing.assert_allclose(grad, expit - y, atol=1e-12)


# ---------------------------------------------------------------------
# metrics against the JAX package
# ---------------------------------------------------------------------
@pytest.mark.parametrize("trial", range(6))
def test_rc_curve_aurc_eaurc_match_jax(trial):
    rng = np.random.RandomState(trial)
    n = [1, 2, 5, 17, 30, 40][trial]
    risks = rng.rand(n)
    confids = np.round(rng.rand(n), 1 if trial % 2 else 8)
    assert P_AURC.rc_curve_stats(risks, confids) == J_AURC.rc_curve_stats(
        risks, confids)
    if n > 1:
        assert P_AURC.aurc(risks, confids) == J_AURC.aurc(risks, confids)
        assert P_AURC.eaurc(risks, confids) == J_AURC.eaurc(risks, confids)


@pytest.mark.parametrize("labels", [(0, 1), (0,), (1,)])
def test_calib_stats_bins_match_jax(labels):
    rng = np.random.RandomState(len(labels) + labels[0])
    correct = rng.choice(labels, 500)
    confids = rng.rand(500)
    got, want = P_ACE.calib_stats(correct, confids), J_ACE.calib_stats(
        correct, confids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert P_ACE.calc_ace(correct, confids) == J_ACE.calc_ace(correct,
                                                               confids)


def test_compute_ncc_matches_jax_and_keeps_r3_nan():
    rng = np.random.RandomState(2)
    gt, pred = rng.rand(8, 8, 8), rng.rand(8, 8, 8)
    assert P_NCC.compute_ncc(gt, pred) == J_NCC.compute_ncc(gt, pred)
    zero = np.zeros((8, 8, 8))
    with np.errstate(all="ignore"):
        got = P_NCC.compute_ncc(zero, pred)
        want = J_NCC.compute_ncc(zero, pred)
    assert math.isnan(got) and math.isnan(want)


def test_update_splits_tuple_splits_match_jax():
    """GTA's (name, "gta"|"cs") tuple splits: the pools and the training
    split as np.delete/np.append leave them."""
    def splits():
        return [{"train": [("0001.npy", "gta"), ("aachen_1.npy", "cs")],
                 "id_unlabeled_pool": [("0002.npy", "gta"),
                                       ("0003.npy", "gta")],
                 "ood_unlabeled_pool": [("bonn_4.npy", "cs"),
                                        ("bonn_5.npy", "cs")]}]
    query = ["0003.nii.gz", "bonn_4.nii.gz"]
    got = P_SC.update_splits(splits(), list(query), ".nii.gz")
    want = J_SC.update_splits(splits(), list(query), ".nii.gz")
    for key in want[0]:
        assert type(got[0][key]) is type(want[0][key])
        np.testing.assert_array_equal(got[0][key], want[0][key])


# ---------------------------------------------------------------------
# the task chain on two copies of one results tree
# ---------------------------------------------------------------------
def _write_tree(base: Path) -> None:
    """Reference layout for Ensemble and Softmax over val/id/ood/unlabeled
    (12^3 maps, 3 raters; image 0005's raters agree: a zero GT variance,
    R3's NaN NCC), the first-cycle splits under ``base/splits``."""
    rng = np.random.RandomState(3)
    for pred_model, version in VERSIONS.items():
        for split, ids in SPLITS.items():
            root = (base / f"{pred_model}-Case-1" / "test_results" / version
                    / split)
            metrics = {}
            for idx in ids:
                image_id = f"{idx:04d}"
                gt = (rng.rand(V, V, V) > 0.6).astype(np.uint8)
                for r in range(RATERS):
                    if r and idx != 5:
                        gt = gt ^ (rng.rand(V, V, V) > 0.9).astype(np.uint8)
                    nifti.save(gt, root / "gt_seg"
                               / f"{image_id}_{r:02d}.nii.gz")
                pred = (rng.rand(V, V, V) > 0.6).astype(np.uint8)
                nifti.save(pred, root / "pred_seg" / f"{image_id}_mean.nii.gz")
                nifti.save(pred, root / "pred_seg" / f"{image_id}_01.nii.gz")
                prob1 = (rng.rand(V, V, V) * 0.5).astype(np.float32)
                nifti.save(1 - prob1, root / "pred_prob"
                           / f"{image_id}_01_01.nii.gz")
                nifti.save(prob1, root / "pred_prob"
                           / f"{image_id}_01_02.nii.gz")
                if pred_model != "Softmax":
                    for unc_dir in ("pred_entropy", "aleatoric_uncertainty",
                                    "epistemic_uncertainty"):
                        nifti.save((rng.rand(V, V, V) * 0.7).astype(
                            np.float32), root / unc_dir / f"{image_id}.nii.gz")
                metrics[f"/fake/{image_id}.npy"] = {
                    "dice": float(rng.uniform(0.3, 0.9)), "loss": 1.0}
            metrics["mean"] = {"dice": float(np.mean(
                [m["dice"] for m in metrics.values()])), "loss": 1.0}
            (root / "metrics.json").write_text(json.dumps(metrics))
    (base / "splits" / "firstCycle").mkdir(parents=True)
    with open(base / "splits" / "firstCycle" / "splits.pkl", "wb") as f:
        pickle.dump(FIRST_CYCLE, f)


def _versions(pkg, base: Path):
    return {model: pkg["EV"].ExperimentVersion(
        base_path=base, naming_scheme_version="{version}",
        naming_scheme_pred_model="{pred_model}-Case-1", pred_model=model,
        image_ending=".nii.gz", unc_ending=".nii.gz",
        unc_types=UNC_TYPES[model],
        aggregations=["patch_level", "image_level", "threshold"],
        n_reference_segs=RATERS, version=version, seed="123")
        for model, version in VERSIONS.items()}


def _aggregations(base: Path, use_device: bool = False) -> dict:
    mod = "values_tpu.evaluation.aggregate_uncertainties."
    patch = {"_target_": mod + "patch_level_aggregation",
             "patch_size": PATCH}
    if use_device:   # the JAX function takes and ignores the device
        patch.update(use_device=True, device="cpu")
    return {"patch_level": patch,
            "image_level": {"_target_": mod + "image_level_aggregation"},
            "threshold": {"_target_": mod + "threshold_aggregation",
                          "threshold_path": str(base
                                                / "threshold_analysis.json")}}


def _outputs(base: Path, names) -> dict:
    out = {}
    for name in names:
        path = base / name
        if path.suffix == ".json":
            out[name] = json.loads(path.read_text())
        else:
            with open(path, "rb") as f:
                out[name] = pickle.load(f)
    return out


def _task_files(base: Path):
    return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                  if p.suffix in (".json", ".pkl")
                  and p.name not in ("metrics.json", "splits.pkl"))


def _run_chain(pkg, base: Path) -> dict:
    """threshold -> aggregation -> OoD detection (the toy rule on id and
    ood, the split rule on unlabeled) -> failure detection -> calibration
    -> ambiguity modeling -> both split generators; then the aggregation
    once more through the box filter. Returns every task file, read
    back, by its path under ``base`` (the OoD JSON of each run under its
    own name)."""
    versions = _versions(pkg, base)
    dl = lambda model, split: pkg["DL"].ExperimentDataloader(  # noqa: E731
        versions[model], split)
    quantiles, paths = {}, {}
    for model in VERSIONS:
        quantiles = pkg["EVAL"].deep_update(
            quantiles, pkg["FT"].get_foreground_quantile(dl(model, "val")))
        paths = pkg["EVAL"].deep_update(
            paths, pkg["FT"].threshold_images_paths(dl(model, "val")))
    pkg["FT"].save_foreground_quantiles(quantiles, base)
    pkg["FT"].find_threshold(paths, base, base)
    for model in VERSIONS:
        for split in SPLITS:
            pkg["AGG"].aggregate_uncertainties(dl(model, split),
                                               _aggregations(base))
    outputs = {}
    for model in VERSIONS:
        ood_json = versions[model].exp_path / "ood_detection.json"
        for split, splits_path in (("id", None), ("ood", None),
                                   ("unlabeled", base / "splits")):
            pkg["AUROC"].ood_detection(dl(model, split), splits_path)
            outputs[f"{ood_json.relative_to(base)}:{split}"] = json.loads(
                ood_json.read_text())
        for split in ("id", "ood"):
            pkg["AURC"].main(dl(model, split))
            pkg["ACE"].main(dl(model, split))
            pkg["NCC"].main(dl(model, split))
        pkg["SC"].generate_split_file(dl(model, "unlabeled"), base / "splits")
        pkg["SCR"].generate_split_file(dl(model, "unlabeled"),
                                       base / "splits",
                                       ["random", "best", "worst"])
    outputs.update(_outputs(base, [n for n in _task_files(base)
                                   if not n.endswith("ood_detection.json")]))
    for model in VERSIONS:
        pkg["AGG"].aggregate_uncertainties(dl(model, "id"),
                                           _aggregations(base, True))
    device_files = [n for n in _task_files(base)
                    if "/id/aggregated_" in n]
    outputs.update({f"{n}:device": v
                    for n, v in _outputs(base, device_files).items()})
    return outputs


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Each package's task outputs on its own copy of the tree."""
    tree = tmp_path_factory.mktemp("tree")
    _write_tree(tree)
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        base = tmp_path_factory.mktemp(name)
        shutil.copytree(tree, base, dirs_exist_ok=True)
        with warnings.catch_warnings(), np.errstate(all="ignore"):
            warnings.simplefilter("ignore")
            out[name] = _run_chain(pkg, base)
        out[f"{name}_base"] = base
    return out


def _chain_names():
    """The names the chain produces (its files, the OoD JSON of each run,
    the box filter's aggregations), in a fixed order."""
    names = ["quantile_analysis.json", "threshold_analysis.json"]
    for model, version in VERSIONS.items():
        exp = f"{model}-Case-1/test_results/{version}"
        names += [f"{exp}/ood_detection.json:{s}"
                  for s in ("id", "ood", "unlabeled")]
        names += [f"{exp}/platt_scale_params.json"]
        for split in SPLITS:
            names += [f"{exp}/{split}/aggregated_{u}.json"
                      for u in UNC_TYPES[model]]
        for split in ("id", "ood"):
            names += [f"{exp}/{split}/{f}.json" for f in (
                "failure_detection", "calibration", "ambiguity_modeling")]
        names += [f"{exp}/id/aggregated_{u}.json:device"
                  for u in UNC_TYPES[model]]
        names += [f"splits/secondCycle/{model}/{u}/{a}/splits_seed123.pkl"
                  for u in UNC_TYPES[model]
                  for a in ("patch_level", "image_level", "threshold")]
    names += [f"splits/secondCycle/{t}/{t}/splits_seed123.pkl"
              for t in ("random", "best", "worst")]
    return names


def test_chain_writes_every_task_file(chain):
    for name in ("jax", "port"):
        assert sorted(chain[name]) == sorted(_chain_names())


@pytest.mark.parametrize("name", _chain_names())
def test_chain_output_matches_jax(chain, name):
    """Exact for the numpy paths; the Platt parameters at rtol 1e-5, ACE
    at 1e-5 absolute, the float32 box filter at rtol 1e-5; the split
    pickles np.array_equal per key."""
    got, want = chain["port"][name], chain["jax"][name]
    if name.endswith(".pkl"):
        assert len(got) == len(want) == 1
        assert got[0].keys() == want[0].keys()
        for key in want[0]:
            assert type(got[0][key]) is type(want[0][key]), key
            assert np.array_equal(got[0][key], want[0][key]), key
    elif "platt_scale_params" in name:
        assert _close(got, want, rtol=1e-5)
    elif name.endswith("calibration.json"):
        assert _close(got, want, atol=1e-5)
    elif name.endswith(":device"):
        assert _close(got, want, rtol=1e-5)
    else:
        assert _equal(got, want)


def test_chain_results_in_range_and_r3(chain):
    """AUROC, the detection rate and ACE lie in [0, 1] (AUROC NaN on the
    one-class "id" split), NCC in [-1, 1], NaN only for image 0005 (its
    raters agree: R3) and the means over it."""
    out = chain["port"]
    for model, version in VERSIONS.items():
        exp = f"{model}-Case-1/test_results/{version}"
        for split in ("id", "ood", "unlabeled"):
            for aggs in out[f"{exp}/ood_detection.json:{split}"][
                    "mean"].values():
                for m in aggs.values():
                    rate, auroc = (m["metrics"]["ood_detection_rate"],
                                   m["metrics"]["auroc"])
                    assert 0 <= rate <= 1
                    assert (math.isnan(auroc) if split == "id"
                            else 0 <= auroc <= 1)
        for split in ("id", "ood"):
            for key, uncs in out[f"{exp}/{split}/calibration.json"].items():
                assert all(0 <= u["metrics"]["ace"] <= 1
                           for u in uncs.values())
            for key, uncs in out[
                    f"{exp}/{split}/ambiguity_modeling.json"].items():
                for u in uncs.values():
                    ncc = u["metrics"]["ncc"]
                    nan_expected = split == "id" and key in ("0005", "mean")
                    assert math.isnan(ncc) == nan_expected, (key, ncc)
                    assert nan_expected or -1 <= ncc <= 1


def test_softmax_lazy_entropy_matches_jax(chain):
    for split in SPLITS:
        rel = (f"Softmax-Case-1/test_results/{VERSIONS['Softmax']}/{split}"
               "/pred_entropy")
        for path in sorted((chain["jax_base"] / rel).iterdir()):
            want, _ = nifti.load(path)
            got, _ = nifti.load(chain["port_base"] / rel / path.name)
            np.testing.assert_array_equal(got, want)


def test_box_filter_on_the_card_path_matches_jax(chain):
    """use_device on every unc map of the tree: the port's float64
    cumulative-sum box filter (device="cpu") against the JAX package's
    float32 reduce_window at rtol 1e-5, and against the float64 host
    path within the card check's 1e-4 relative."""
    base = chain["port_base"]
    maps = sorted(base.rglob("*_uncertainty/*.nii.gz")) + sorted(
        base.rglob("pred_entropy/*.nii.gz"))
    assert len(maps) > 50
    for path in maps:
        image, _ = nifti.load(path)
        got = P_AGG.patch_level_aggregation(image, PATCH, use_device=True,
                                            device="cpu")
        want = J_AGG.patch_level_aggregation(image, PATCH, use_device=True)
        host = P_AGG.patch_level_aggregation(image, PATCH)
        assert got["max_score"] == pytest.approx(want["max_score"],
                                                 rel=1e-5)
        assert got["bounding_box"] == want["bounding_box"]
        assert got["max_score"] == pytest.approx(host["max_score"],
                                                 rel=1e-4)
        assert host == J_AGG.patch_level_aggregation(image, PATCH)


def test_sorting_matches_jax(chain):
    agg = chain["port"][f"Ensemble-Case-1/test_results/"
                        f"{VERSIONS['Ensemble']}/ood/"
                        "aggregated_predictive_uncertainty.json"]
    for level in ("patch_level", "image_level", "threshold"):
        assert P_SORT.sort_uncertainties(agg, level) == \
            J_SORT.sort_uncertainties(agg, level)
    with pytest.raises(Exception, match="level not known"):
        P_SORT.sort_uncertainties(agg, "voxel")


def test_al_improvement_matches_jax(chain, tmp_path):
    """al_improvement on the first cycle's "ood" split against second-
    cycle metrics placed in the layout it reads."""
    rng = np.random.RandomState(4)
    second = tmp_path / "SecondCycle"
    for unc, agg in [(u, a) for u in UNC_TYPES["Ensemble"]
                     for a in ("patch_level", "image_level", "threshold")] \
            + [("random", "random")]:
        d = (second / "Ensemble" / "test_results" / unc / agg
             / VERSIONS["Ensemble"] / "ood")
        d.mkdir(parents=True)
        (d / "metrics.json").write_text(json.dumps(
            {"mean": {"metrics": {"dice": float(rng.rand())}}}))
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        version = _versions(pkg, chain[f"{name}_base"])["Ensemble"]
        version.second_cycle_path = second
        dl = pkg["DL"].ExperimentDataloader(version, "ood")
        pkg["AL"].main(dl)
        out[name] = json.loads((dl.dataset_path
                                / "al_improvement.json").read_text())
    assert _equal(out["port"], out["jax"])
    assert set(out["port"]["mean"]) == {"predictive_uncertainty",
                                        "epistemic_uncertainty"}


# ---------------------------------------------------------------------
# the driver on eval_config_toy
# ---------------------------------------------------------------------
def _toy_overrides(base: Path):
    return [f"base_path={base}", "TOY.epochs=2",
            "TOY.iter_params.pred_model=[Ensemble, Softmax]",
            "TOY.iter_params.seed=['123']"]


def test_eval_experiments_on_eval_config_toy_matches_jax(tmp_path):
    """The port's CLI on eval_config_toy (base_path overridden, two
    models, one seed) against the JAX driver on a copy of the tree:
    every task file the same."""
    tree = tmp_path / "tree"
    _write_tree(tree)
    bases = {}
    for name in ("jax", "port"):
        bases[name] = tmp_path / name
        shutil.copytree(tree, bases[name])
    config_dir = str(ROOT / "configs" / "evaluation")
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        J_EVAL.EvalExperiments(jax_compose(
            config_dir, "eval_config_toy",
            _toy_overrides(bases["jax"]))).analyse()
        P_EVAL.main(["--config-dir", config_dir, "--config-name",
                     "eval_config_toy"] + _toy_overrides(bases["port"]))
    names = _task_files(bases["jax"])
    assert names == _task_files(bases["port"])
    assert len(names) == 34
    got, want = _outputs(bases["port"], names), _outputs(bases["jax"], names)
    for name in names:
        if "platt_scale_params" in name:
            assert _close(got[name], want[name], rtol=1e-5), name
        elif name.endswith("calibration.json"):
            assert _close(got[name], want[name], atol=1e-5), name
        else:
            assert _equal(got[name], want[name]), name


@pytest.mark.parametrize("config", ["eval_config_toy", "eval_config_lidc"])
def test_every_evaluation_target_resolves_to_the_port(config):
    """Every _target_ of the composed config (its tasks included, and the
    LIDC config's second-cycle and AL tasks) is a values_tpu_torch
    function."""
    cfg = compose(ROOT / "configs" / "evaluation", config)
    targets = []

    def walk(node):
        if isinstance(node, dict):
            if "_target_" in node:
                targets.append(node["_target_"])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(cfg.to_container())
    assert len(targets) >= (13 if config == "eval_config_lidc" else 10)
    for target in targets:
        fn = locate(target)
        assert fn.__module__.startswith("values_tpu_torch.evaluation."), (
            target, fn.__module__)


# ---------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------
def test_gta_targets_raise_naming_2d(tmp_path):
    """GTA's targets resolve to the port: a GTA datamodule_config builds
    the 2D datamodule's test loader, whose n_reference_segs reference
    segs equal the JAX loader's given as many (R13),
    ``values_tpu.evaluation.gta`` and ``evaluation.utils.gta`` name the
    port's loaders, whose predictions (read from a PNG the port writes)
    equal the JAX ones and whose GT uncertainty is the JAX one in (H, W)
    (R13); the visualization targets, the JAX package's and the
    reference's, resolve to the port's reporting layer."""
    import values_tpu.evaluation.gta as J_GTA
    from tests.test_2d_path import make_gta_tree
    from values_tpu_torch.core.image_io import write_png_rgb
    from values_tpu_torch.data.gta_preprocess import train_ids_to_color
    gta = make_gta_tree(tmp_path / "data")
    dm_config = {
        "_target_": "values_tpu.data.base_datamodule.BaseDataModule",
        "num_classes": 24, "ignore_index": 255, "num_workers": 0,
        "batch_size": 2, "val_batch_size": 2, "data_fold_id": 0,
        "data_input_dir": str(gta),
        "augmentations": compose(ROOT / "configs" / "evaluation",
                                 "eval_config_gta").to_container()[
            "GTA_EVAL_AUGMENTATIONS"],
        "dataset": {
            "_target_": "values_tpu.data.cityscapes_dataset."
                        "CityscapesDataset",
            "splits_path": str(gta / "splits" / "firstCycle"
                               / "splits.pkl")}}
    split = tmp_path / "GTA" / "test_results" / "fold0_seed123" / "id"
    (split / "pred_seg").mkdir(parents=True)
    labels = np.random.RandomState(4).randint(0, 24, (32, 48))
    write_png_rgb(str(split / "pred_seg" / "00003_mean.png"),
                  train_ids_to_color(labels))
    # the JAX loader draws the TEST pipeline's one mask; the port draws
    # n_reference_segs (R13): the JAX side is given them explicitly
    jax_config = copy.deepcopy(dm_config)
    jax_config["augmentations"]["TEST"][0]["Compose"]["transforms"][1][
        "StochasticLabelSwitches"]["n_reference_samples"] = 5
    loaders = {}
    for pkg, ev, dl in (("jax", J_EV, J_DL), ("port", P_EV, P_DL)):
        version = ev.ExperimentVersion(
            base_path=tmp_path, naming_scheme_version="fold{fold}_seed{seed}",
            pred_model="GTA", image_ending=".png",
            unc_ending=".tif", unc_types=["predictive_uncertainty"],
            aggregations=["patch_level"], n_reference_segs=5, n_classes=24,
            fold=0, seed="123",
            datamodule_config=jax_config if pkg == "jax" else dm_config,
            pred_seg_loading={
                "_target_": "values_tpu.evaluation.gta.pred_seg_loading"},
            gt_unc_map_loading={
                "_target_": "values_tpu.evaluation.gta.gt_unc_map"})
        loader = dl.ExperimentDataloader(version, "id")  # seeds the host
        loaders[pkg] = (loader.image_ids,
                        loader.get_reference_segs("00003"),
                        loader.get_gt_unc_map("00003"),
                        loader.get_mean_pred_seg("00003"))
    ids, refs, gt_unc, pred = loaders["port"]
    assert ids == loaders["jax"][0] == ["00003"]
    assert refs.shape == (5, 32, 48)
    np.testing.assert_array_equal(refs, loaders["jax"][1])
    # the port's GT uncertainty is (H, W), as its TIFs; the JAX one (W, H)
    np.testing.assert_array_equal(gt_unc, loaders["jax"][2].T)
    np.testing.assert_array_equal(pred, loaders["jax"][3])
    np.testing.assert_array_equal(loaders["port"][3], labels)
    path = split / "pred_seg" / "00003_mean.png"
    np.testing.assert_array_equal(locate(
        "values_tpu.evaluation.gta.pred_seg_loading")(path),
        J_GTA.pred_seg_loading(path))
    for target in ("values_tpu.evaluation.gta.gt_unc_map",
                   "values_tpu.evaluation.gta.pred_seg_loading",
                   "evaluation.utils.gta.pred_seg_loading"):
        assert locate(target).__module__ == "values_tpu_torch.evaluation.gta"
    from values_tpu_torch.evaluation.visualization import (
        ds_task_barplots, ds_task_table)
    for target, want in (
            ("values_tpu.evaluation.visualization.ds_task_table.main",
             ds_task_table.main),
            ("values_tpu.evaluation.visualization.ds_task_barplots.main",
             ds_task_barplots.main),
            ("evaluation.visualization.ds_task_table.DsTaskTable",
             ds_task_table.DsTaskTable)):
        assert locate(target) is want


@pytest.mark.parametrize("target", [
    "values_tpu.evaluation.no_such_module.main",
    "values_tpu.evaluation.metrics.auroc.no_such_function",
    "evaluation.metrics.no_such_metric.main"])
def test_unknown_evaluation_target_raises_not_implemented(target):
    """A target under an aliased evaluation prefix that the port does not
    hold raises NotImplementedError, not an import error."""
    with pytest.raises(NotImplementedError, match="no counterpart"):
        locate(target)


def test_box_filter_without_device_needs_cuda():
    """The use_device aggregation takes the card unless asked otherwise."""
    import torch
    image = np.random.RandomState(0).rand(8, 8, 8)
    if torch.cuda.is_available():
        P_AGG.patch_level_aggregation(image, 4, use_device=True)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P_AGG.patch_level_aggregation(image, 4, use_device=True)
