"""Data-parallel training and scoring end to end on the CPU, mirroring
tests/test_multihost.py: one spawned gloo world of 2 ranks
(tests/torch_parallel_cases.py::run_fit_group) runs the training CLI on
``softmax_config`` with ``devices=2``, ``fit`` on the 2D HRNet with
``gpus=2`` and the score CLI with ``--devices 2``. The checkpoints are the
JAX package's native format, which its ``load_any_checkpoint`` reads;
the 3D one and the scores equal a single-rank run's (every rank iterates
the same seeded loader and keeps its rows, so the global batches are the
single-rank ones), and the scores equal the JAX score CLI's with
``--devices 2`` on the same checkpoint."""
import json
import pickle

import numpy as np
import pytest

import torch_parallel_cases as C
from torch_parallel_cases import one_torch_thread  # noqa: F401
from test_torch_fit_2d import _config as gta_config
from test_torch_score_cli import _toy_data
from tests.test_2d_path import make_gta_tree
from values_tpu.inference.score import run_score as jax_run_score
from values_tpu.inference.score import score_cli as jax_score_cli
from values_tpu.training.checkpoint import load_any_checkpoint
from values_tpu.training.checkpoint import load_checkpoint as jax_load
from values_tpu_torch.inference.score import run_score, score_cli
from values_tpu_torch.training.main import main as train_main


def _train_argv(toy, save_dir, version, *extra):
    return ["--config-name", "softmax_config", "--device", "cpu",
            f"data_input_dir={toy}", f"save_dir={save_dir}",
            "max_epochs=1", "batch_size=2", "datamodule.patch_size=16",
            "datamodule.batch_size=2", "datamodule.data_num_folds=3",
            f"model.initial_filter_size={C.F}", f"version={version}",
            *extra]


def _score_argv(toy, out):
    return ["-i", str(toy), "--out", str(out), "--test_split", "val",
            "--dtype", "float32", "--device", "cpu", "--batch_size", "3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_fit")
    toy = work / "toy"
    toy.mkdir()
    _toy_data(toy)
    gta = make_gta_tree(work / "GTA")
    config_2d = gta_config(gta, work / "exp2d", 123).to_container()
    config_2d.update(gpus=2, batch_size=2, max_epochs=1)
    C.spawn_within(C.run_fit_group, (
        str(work), _train_argv(toy, work / "exp", "dp", "devices=2"),
        config_2d, _score_argv(toy, work / "dp.json") + ["--devices", "2"]),
        2)
    with open(work / "rank0.pkl", "rb") as f:
        paths = pickle.load(f)
    single = train_main(_train_argv(toy, work / "exp", "single"))
    run_score(score_cli(_score_argv(toy, work / "single.json")
                        + ["--checkpoint_paths", single]))
    return work, paths, single


def test_fit_devices_2_writes_a_checkpoint_jax_reads(runs):
    """The 3D checkpoint of ``devices=2``: the JAX package's reader takes
    it (hyper-parameters with devices 2, the flax tree, the step count of
    the single-rank run: 2 steps of the global batch of 2), and its
    weights equal the single-rank run's within 1e-5 (Adam's steps of
    float32 gradients averaged over the ranks)."""
    work, paths, single = runs
    hparams, variables = load_any_checkpoint(paths["3d"])
    assert int(hparams["devices"]) == 2
    got, want = jax_load(paths["3d"]), jax_load(single)
    assert got["global_step"] == want["global_step"] == 2

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, np.asarray(v)
    flat = dict(leaves(want["state_dict"]["params"]))
    for name, value in leaves(variables["params"]):
        if name.startswith("contr_") and name.endswith("bias"):
            continue   # true gradient 0: Adam steps on roundoff
        np.testing.assert_allclose(value, flat.pop(name), atol=1e-5,
                                   err_msg=name)
    assert all(k.startswith("contr_") for k in flat)


def test_fit_2d_gpus_2_writes_a_checkpoint_jax_reads(runs):
    """The HRNet trained over 2 ranks (synced BatchNorm, masked CE):
    {params, batch_stats}, the running statistics moved, readable by the
    JAX package."""
    _, paths, _ = runs
    hparams, variables = load_any_checkpoint(paths["2d"])
    assert set(variables) == {"params", "batch_stats"}
    assert int(hparams["gpus"]) == 2
    assert jax_load(paths["2d"])["global_step"] >= 1
    assert not np.allclose(variables["batch_stats"]["bn1"]["var"], 1)


def test_score_devices_2_matches_one_rank(runs):
    """``--devices 2``: rank 0 writes the JSON; the deterministic scores
    of the 3D checkpoint equal the single-rank CLI's on the single-rank
    checkpoint within tests/test_torch_score_cli.py's atol = rtol = 5e-3
    (the two checkpoints agree within 1e-5)."""
    work, _, _ = runs
    got = json.loads((work / "dp.json").read_text())
    want = json.loads((work / "single.json").read_text())
    assert sorted(got) == sorted(want)
    for subject, rows in want.items():
        assert sorted(got[subject]) == sorted(rows)
        for row, value in rows.items():
            assert got[subject][row] == pytest.approx(value, abs=5e-3,
                                                      rel=5e-3)


def test_score_devices_2_matches_jax_cli(runs):
    """``--devices 2`` against the JAX score CLI's ``--devices 2`` (its
    ``make_sharded_scorer`` over 2 virtual CPU devices) on the same 3D
    checkpoint and volumes (VALUES_TPU_AGG_LINEAR=0 set before the JAX
    scorer is traced, fault R1): the same subjects and rows, values within
    tests/test_torch_score_cli.py's atol = rtol = 5e-3 between the two
    packages' single-device CLIs."""
    work, paths, _ = runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        want = jax_run_score(jax_score_cli([
            "--checkpoint_paths", paths["3d"], "-i", str(work / "toy"),
            "--out", str(work / "jax_dp.json"), "--test_split", "val",
            "--dtype", "float32", "--batch_size", "3", "--devices", "2"]))
    got = json.loads((work / "dp.json").read_text())
    assert sorted(got) == sorted(want) and len(got) == 2
    for subject, rows in want.items():
        assert list(got[subject]) == list(rows)
        np.testing.assert_allclose(
            [got[subject][r] for r in rows], [rows[r] for r in rows],
            atol=5e-3, rtol=5e-3, err_msg=subject)
