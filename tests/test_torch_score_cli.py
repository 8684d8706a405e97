"""The port's scores-only CLI (values_tpu_torch.inference.score) against
the JAX package's (values_tpu.inference.score) on the same native
checkpoints and toy volumes, and the port's checkpoint reading against
the JAX package's load_any_checkpoint."""
import json
import os
import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.config import compose
from values_tpu.data.toy_datamodule import ToyDataModule3D
from values_tpu.data.toy_generation import ToyGenConfig, generate_samples
from values_tpu.inference.score import run_score as jax_run_score
from values_tpu.inference.score import score_cli as jax_score_cli
from values_tpu.models.torch_import import \
    unet3d_params_to_torch as jax_params_to_torch
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.training.checkpoint import \
    load_any_checkpoint as jax_load_any_checkpoint
from values_tpu.training.checkpoint import save_checkpoint
from values_tpu_torch.inference.score import run_score, score_cli
from values_tpu_torch.inference.scoring import score_rows
from values_tpu_torch.models.unet3d import UNet3D
from values_tpu_torch.training.checkpoint import load_any_checkpoint

P, F = 16, 2


def _toy_data(root):
    """Toy Case_1 at 16^3 as tests/test_score_cli.py makes it (6 train,
    2 test volumes, 3 raters), preprocessed and split into 3 folds
    without training."""
    case = root / "Case_1"
    for split, n in (("Tr", 6), ("Ts", 2)):
        cfg = ToyGenConfig(
            input_files=["ballSphere.stl"],
            save_path=str(case / f"images{split}"),
            n_samples=n, image_size=(P, P, P), min_object_ratio=5,
            max_object_ratio=2, gauss_sigma=2, blur=True,
            segmentation=True, n_raters=3, seed=1 if split == "Tr" else 2)
        random.seed(cfg.seed)
        np.random.seed(cfg.seed)
        generate_samples(cfg)
        seg = case / f"images{split}" / "segmentation"
        (case / f"labels{split}").mkdir(exist_ok=True)
        for f in seg.iterdir():
            f.rename(case / f"labels{split}" / f.name)
        seg.rmdir()
    ToyDataModule3D(dataset_name="Case_1", num_raters=3,
                    data_input_dir=str(root), data_num_folds=3,
                    patch_size=P, seed=123).prepare_data()


def _hparams(root, aleatoric=False):
    hp = compose("configs", "softmax_config", overrides=[
        f"data_input_dir={root}", f"save_dir={root}/exp",
        "datamodule.patch_size=16", "datamodule.data_num_folds=3",
        f"model.initial_filter_size={F}", "version=0"]).to_container()
    if aleatoric:
        hp["aleatoric_loss"] = True
        hp["n_aleatoric_samples"] = 2
    return hp


def _native_checkpoints(root, name, aleatoric, n=2):
    """n native checkpoints of UNet3D variables (f=2, ``flax_init``)."""
    model = JaxUNet3D(num_classes=2, initial_filter_size=F,
                      aleatoric_loss=aleatoric)
    paths = []
    for i in range(n):
        path = str(root / f"{name}_{i}.ckpt")
        save_checkpoint(path, flax_init(model, 70 + i,
                                        jnp.zeros((1, P, P, P, 1))),
                        _hparams(root, aleatoric))
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """Data, checkpoints and the JAX CLI's scores for the deterministic
    ensemble, computed once. VALUES_TPU_AGG_LINEAR=0 is set before the
    JAX scorer is traced (fault R1)."""
    root = tmp_path_factory.mktemp("PortScoreToy")
    _toy_data(root)
    det = _native_checkpoints(root, "det", False)
    ale = _native_checkpoints(root, "ale", True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        want = jax_run_score(jax_score_cli([
            "--checkpoint_paths", *det, "-i", str(root),
            "--out", str(root / "jax.json"), "--test_split", "val",
            "--dtype", "float32"]))
    return root, det, ale, want


def _port_args(root, ckpts, out, *extra):
    return score_cli(["--checkpoint_paths", *ckpts, "-i", str(root),
                      "--out", str(out), "--test_split", "val",
                      "--dtype", "float32", "--device", "cpu", *extra])


def test_deterministic_cli_matches_jax_cli(toy, tmp_path):
    """Same subjects and rows; values within atol = rtol = 5e-3, as
    tests/test_torch_scoring.py (largest difference seen: 2.4e-4, on an
    image-level sum)."""
    root, det, _, want = toy
    out = tmp_path / "port.json"
    got = run_score(_port_args(root, det, out))
    assert json.loads(out.read_text()) == got
    assert got.keys() == want.keys() and len(got) == 2
    for subject, scores in got.items():
        assert list(scores) == score_rows()
        np.testing.assert_allclose(
            [scores[r] for r in score_rows()],
            [want[subject][r] for r in score_rows()], atol=5e-3, rtol=5e-3,
            err_msg=subject)


def test_aleatoric_cli_is_finite_and_reproducible(toy, tmp_path):
    root, _, ale, _ = toy
    first, second = tmp_path / "a.json", tmp_path / "b.json"
    got = run_score(_port_args(root, ale, first))
    assert len(got) == 2
    for scores in got.values():
        assert list(scores) == score_rows()
        assert all(np.isfinite(v) for v in scores.values())
        assert 0.0 <= scores["dice"] <= 1.0
    run_score(_port_args(root, ale, second))
    assert first.read_bytes() == second.read_bytes()


def _reference_ckpt(path, hparams, legacy=False):
    torch.manual_seed(0)
    state = UNet3D(2, initial_filter_size=F).state_dict()
    torch.save({"state_dict": {"model." + k: v for k, v in state.items()},
                "hyper_parameters": hparams}, path,
               _use_new_zipfile_serialization=not legacy)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], torch.as_tensor(want[key])), key


@pytest.mark.parametrize("kind", ["native", "reference", "legacy"])
def test_checkpoint_reading_matches_jax(toy, tmp_path, kind):
    """The port's state_dict equals unet3d_params_to_torch of the JAX
    reader's variables, exactly, for each format."""
    root, det, _, _ = toy
    hp = _hparams(root)
    path = det[0] if kind == "native" else str(tmp_path / "ref.ckpt")
    if kind != "native":
        _reference_ckpt(path, hp, legacy=kind == "legacy")
    got_hp, got = load_any_checkpoint(path)
    want_hp, variables = jax_load_any_checkpoint(path)
    assert got_hp == want_hp == hp
    _assert_same_state(got, jax_params_to_torch(variables))


def test_checkpoint_reading_refusals(toy, tmp_path):
    """An HRNet checkpoint reads (the 2D path is ported), and the score
    CLI, which builds UNet3D scorers only, refuses it with a ValueError
    naming test_2d before any forward; orbax stays refused."""
    root, _, _, _ = toy
    hp = _hparams(root)
    hp["model"]["_target_"] = "values_tpu.models.hrnet.HRNet"
    _reference_ckpt(str(tmp_path / "hrnet.ckpt"), hp)
    got_hp, _ = load_any_checkpoint(str(tmp_path / "hrnet.ckpt"))
    assert got_hp == hp
    args = score_cli(["--checkpoint_paths", str(tmp_path / "hrnet.ckpt"),
                      "-i", str(root), "--out", str(tmp_path / "s.json"),
                      "--device", "cpu"])
    with pytest.raises(ValueError, match="test_2d"):
        run_score(args)
    orbax = tmp_path / "orbax.ckpt"
    orbax.mkdir()
    (orbax / "values_tpu_meta.pkl").write_bytes(pickle.dumps({}))
    with pytest.raises(NotImplementedError, match="orbax"):
        load_any_checkpoint(str(orbax))


def test_cli_rejects_multiwindow(toy, tmp_path):
    """A volume larger than the patch (several windows) is refused."""
    root, det, _, _ = toy
    hp = _hparams(root)
    big = np.zeros((P * 2, P * 2, P * 2), np.float32)
    pre = root / "Case_1" / "preprocessed"
    np.save(str(pre / "imagesTr" / "zz_big.npy"), big)
    for rater in range(3):
        np.save(str(pre / "labelsTr" / f"zz_big_{rater:02d}.npy"),
                big.astype(np.int16))
    splits_path = root / "Case_1" / "splits.pkl"
    orig = splits_path.read_bytes()
    try:
        splits = pickle.loads(orig)
        fold = hp["datamodule"]["data_fold_id"]
        splits[fold]["val"] = list(splits[fold]["val"]) + ["zz_big.npy"]
        splits_path.write_bytes(pickle.dumps(splits))
        with pytest.raises(ValueError, match="sliding window"):
            run_score(_port_args(root, det[:1], tmp_path / "s.json"))
    finally:
        splits_path.write_bytes(orig)
        os.remove(str(pre / "imagesTr" / "zz_big.npy"))
        for rater in range(3):
            os.remove(str(pre / "labelsTr" / f"zz_big_{rater:02d}.npy"))


def _with_model_hparams(root, src, dst, **model):
    """A copy of the native checkpoint ``src`` whose model hparams are
    updated with ``model``."""
    hp = _hparams(root)
    hp["model"].update(model)
    with open(src, "rb") as f:
        payload = pickle.load(f)
    payload["hyper_parameters"] = hp
    with open(dst, "wb") as f:
        pickle.dump(payload, f)
    return str(dst)


@pytest.mark.parametrize("case", ["devices"])
def test_cli_refuses_what_is_not_ported(toy, tmp_path, case):
    """Data-parallel scoring runs (tests/test_torch_parallel_fit.py):
    ``run_score`` asked for 2 devices in a process that belongs to no
    torch.distributed world refuses, naming the launchers (the CLI's
    ``main`` spawns the ranks itself)."""
    root, det, _, _ = toy
    with pytest.raises(RuntimeError, match="torchrun"):
        run_score(_port_args(root, det, tmp_path / "s.json", "--devices",
                             "2"))


# -- the MC-dropout, TTA and SSN branches ----------------------------------------

SSN_MODEL = {"_target_": "values_tpu.models.ssn_unet3d.SsnUNet3D",
             "num_classes": 2, "in_channels": 1, "initial_filter_size": F,
             "kernel_size": 3, "do_instancenorm": True, "rank": 3,
             "epsilon": 1e-5}

# JAX package factory -> the port's
FACTORIES = {"make_packed_scorer": "make_scorer",
             "make_packed_aleatoric_scorer": "make_aleatoric_scorer",
             "make_packed_tta_scorer": "make_tta_scorer",
             "make_packed_dropout_scorer": "make_dropout_scorer",
             "make_packed_ssn_scorer": "make_ssn_scorer"}
# the arguments that pick what a scorer computes
PICKS = ("n_pred", "n_aleatoric_samples", "do_dropout", "rank", "epsilon")

BRANCHES = {
    "default": ({}, {}, []),
    "aleatoric": ({}, {"aleatoric_loss": True, "n_aleatoric_samples": 3},
                  []),
    "dropout_one_pass": ({"do_dropout": True}, {}, []),
    "n_pred_dropout": ({"do_dropout": True}, {}, ["--n_pred", "3"]),
    "n_pred_plain": ({}, {}, ["--n_pred", "3"]),
    "tta": ({}, {}, ["-tta"]),
    "tta_dropout": ({"do_dropout": True}, {}, ["-tta"]),
    "tta_aleatoric": ({}, {"aleatoric_loss": True}, ["-tta"]),
    "ssn": (SSN_MODEL, {"n_aleatoric_samples": 4}, []),
    "ssn_n_pred": (SSN_MODEL, {"n_aleatoric_samples": 4},
                   ["--n_pred", "2", "-tta"]),
}


def _picked(module, names, monkeypatch):
    """Replace each scorer factory of ``module`` by a recorder of its
    name and the arguments in PICKS."""
    calls = []
    for name in names:
        def factory(*args, _name=name, **kw):
            calls.append((_name, args, {k: kw[k] for k in PICKS
                                        if k in kw}))
            return None, None
        monkeypatch.setattr(module, name, factory)
    return calls


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_cli_picks_the_scorer_the_jax_cli_picks(toy, branch, monkeypatch):
    """The port's ``build_scorer`` against the JAX CLI's
    ``_build_scorer`` (score.py:79-124) on the same hparams and flags:
    the same scorer with the same members, classes, samples, rank and
    epsilon, or the same ValueError (-tta on an aleatoric head,
    --n_pred > 1 without dropout)."""
    from values_tpu.config import instantiate as jax_instantiate
    from values_tpu.config import make_config as jax_make_config
    from values_tpu.inference import score as jax_score
    from values_tpu.inference import scoring as jax_scoring
    from values_tpu_torch.inference import scoring as port_scoring
    from values_tpu_torch.inference.score import build_scorer
    root = toy[0]
    model, extra_hp, flags = BRANCHES[branch]
    hp = _hparams(root)
    hp["model"].update(model)
    hp.update(extra_hp)
    argv = ["--checkpoint_paths", "x", "--out", "y"] + flags
    jax_args, port_args = jax_score_cli(argv), score_cli(argv)
    want = _picked(jax_scoring, FACTORIES, monkeypatch)
    got = _picked(port_scoring, FACTORIES.values(), monkeypatch)
    kw = ({"aleatoric_loss": hp["aleatoric_loss"]}
          if hp.get("aleatoric_loss") is not None else {})
    jax_model = jax_instantiate(jax_make_config(dict(hp["model"])), **kw)
    try:
        jax_score._build_scorer(hp, jax_model, 2, jax_args, True)
    except ValueError as err:
        with pytest.raises(ValueError) as port_err:
            build_scorer(hp, 2, port_args, "cpu")
        assert str(port_err.value).split(";")[0] == str(err).split(";")[0]
        return
    build_scorer(hp, 2, port_args, "cpu")
    assert len(want) == len(got) == 1
    (jname, jargs, jkw), (pname, pargs, pkw) = want[0], got[0]
    assert FACTORIES[jname] == pname and jargs == pargs and jkw == pkw


def _ssn_checkpoints(root, n=2):
    """n native checkpoints of SsnUNet3D variables (f 2, rank 3,
    ``flax_init``)."""
    from values_tpu.models.ssn_unet3d import SsnUNet3D as JaxSsnUNet3D
    model = JaxSsnUNet3D(num_classes=2, initial_filter_size=F, rank=3)
    hp = _hparams(root)
    hp["model"] = dict(SSN_MODEL)
    hp["n_aleatoric_samples"] = 2
    paths = []
    for i in range(n):
        path = str(root / f"ssn_{i}.ckpt")
        save_checkpoint(path, flax_init(model, 80 + i,
                                        jnp.zeros((1, P, P, P, 1))), hp)
        paths.append(path)
    return paths


@pytest.mark.parametrize("branch", ["ssn", "tta", "n_pred", "tta_dropout"])
def test_cli_runs_each_stochastic_branch(toy, tmp_path, branch):
    """The SSN set (n_pred from the hparams' n_aleatoric_samples), -tta
    on the softmax set and on a dropout set, --n_pred 2 on the dropout
    set: the CLI writes what the picked scorer gives for the CLI's batch
    seed, and the same command writes the same file."""
    from values_tpu_torch.core.seed import make_generator
    from values_tpu_torch.inference import scoring as port_scoring
    from values_tpu_torch.models.torch_import import \
        group_member_state_dicts
    root, det, _, _ = toy
    if branch == "ssn":
        ckpts, flags = _ssn_checkpoints(tmp_path), []
    elif branch == "tta":
        ckpts, flags = det, ["-tta"]
    else:
        ckpts = [_with_model_hparams(root, d, tmp_path / f"mcd_{i}.ckpt",
                                     do_dropout=True)
                 for i, d in enumerate(det)]
        flags = ["-tta"] if branch == "tta_dropout" else ["--n_pred", "2"]
    first, second = tmp_path / "a.json", tmp_path / "b.json"
    got = run_score(_port_args(root, ckpts, first, *flags))
    run_score(_port_args(root, ckpts, second, *flags))
    assert first.read_bytes() == second.read_bytes()
    assert len(got) == 2
    loaded = [load_any_checkpoint(p) for p in ckpts]
    weights = group_member_state_dicts([s for _, s in loaded])
    common = dict(agg_patch=10, dtype=torch.float32, device="cpu")
    score = {
        "ssn": lambda: port_scoring.make_ssn_scorer(2, 2, P, n_pred=2,
                                                    rank=3, **common),
        "tta": lambda: port_scoring.make_tta_scorer(2, P, **common),
        "tta_dropout": lambda: port_scoring.make_tta_scorer(
            2, P, do_dropout=True, **common),
        "n_pred": lambda: port_scoring.make_dropout_scorer(2, P, n_pred=2,
                                                           **common),
    }[branch]()[0]
    subjects = sorted(got)
    pre = root / "Case_1" / "preprocessed"
    vols = np.stack([np.load(pre / "imagesTr" / f"{s}.npy") for s in
                     subjects]).astype(np.float32)
    gt = np.stack([np.stack([np.load(pre / "labelsTr" / f"{s}_{r:02d}.npy")
                             for r in range(3)]) for s in subjects])
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=make_generator(
        loaded[0][0]["seed"])))
    want = score(weights, torch.from_numpy(vols),
                 torch.from_numpy(gt.astype(np.int32)), seed).numpy()
    for j, subject in enumerate(subjects):
        assert list(got[subject]) == score_rows()
        assert all(np.isfinite(v) for v in got[subject].values())
        np.testing.assert_array_equal(
            [got[subject][r] for r in score_rows()], want[:, j],
            err_msg=subject)


def test_cli_n_pred_needs_a_dropout_model(toy, tmp_path):
    """``--n_pred 2`` on a model without dropout has no scorer: both CLIs
    raise ValueError."""
    root, det, _, _ = toy
    with pytest.raises(ValueError, match="do_dropout=False"):
        run_score(_port_args(root, det, tmp_path / "s.json", "--n_pred",
                             "2"))
    with pytest.raises(ValueError, match="do_dropout=False"):
        jax_run_score(jax_score_cli([
            "--checkpoint_paths", *det, "-i", str(root),
            "--out", str(tmp_path / "j.json"), "--test_split", "val",
            "--dtype", "float32", "--n_pred", "2"]))
