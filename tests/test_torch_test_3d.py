"""The port's sliding-window test_3d path (values_tpu_torch.ops.window,
ops.metrics, inference.predictors, engine, carrier and the test_3d CLI)
against the JAX package's, at 16^3 windows and initial filter size 2, on
the CPU. The JAX engine runs its CPU path (backend "auto" picks XLA)."""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from values_tpu.config import compose
from values_tpu.core import nifti as jax_nifti
from values_tpu.data.toy_datamodule import ToyDataModule3D
from values_tpu.data.toy_generation import ToyGenConfig, generate_samples
from values_tpu.inference import predictors as JP
from values_tpu.inference import test_3d as jax_test_3d
from values_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.ops import metrics as JM
from values_tpu.ops import window as JW
from values_tpu_torch.config import make_config
from values_tpu_torch.inference import predictors as P
from values_tpu_torch.inference import test_3d
from values_tpu_torch.inference.engine import SlidingWindowEngine
from values_tpu_torch.models.ensemble_unet3d import (cast_weights,
                                                     eval_forward,
                                                     group_member_variables)
from values_tpu_torch.models.unet3d import UNet3D
from values_tpu_torch.ops import metrics as M
from values_tpu_torch.ops import window as W
from values_tpu_torch.ops.uncertainty import aleatoric_softmax_samples
from values_tpu_torch.training.checkpoint import to_torch_tree
from values_tpu_torch.training.ensemble import EnsembleTrainer
from values_tpu_torch.training.experiment import Experiment

PATCH, F, S = 16, 2, 3


def _members(aleatoric=False, n=2):
    """n flax-layout member trees (numpy) of the port's torch init."""
    cfg = {"model": {"_target_": "values_tpu.models.unet3d.UNet3D",
                     "num_classes": 2, "initial_filter_size": F},
           "datamodule": {"ignore_index": 0}, "aleatoric_loss": aleatoric}
    exp = Experiment(make_config(cfg), "cpu")
    return [{"params": exp.initial_params(seed)} for seed in range(1, n + 1)]


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               atol=atol, rtol=0)


# -- windows -----------------------------------------------------------------

def test_extract_and_stitch_overlapping_windows_match_jax(rng):
    """Overlapping windows (stride 8 of 16) with a channel axis, stitched
    in window order: equal to the JAX scan within float32 rounding of
    the same sums in the same order (seen: exact)."""
    vol = rng.rand(32, 24, 16, 2).astype(np.float32)
    starts = JW.enumerate_window_starts(vol.shape, PATCH, 0.5)
    got = W.extract_windows(torch.tensor(vol), starts, PATCH)
    want = JW.extract_windows(jnp.asarray(vol), jnp.asarray(starts), PATCH)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    windows = rng.rand(*got.shape).astype(np.float32)
    got = W.stitch_windows(torch.tensor(windows), starts, vol.shape)
    want = JW.stitch_windows(jnp.asarray(windows), jnp.asarray(starts),
                             vol.shape)
    _close(got, want, atol=1e-6)


def test_count_and_gaussian_maps_match_jax():
    starts = JW.enumerate_window_starts((32, 32, 16), PATCH, 0.5)
    np.testing.assert_array_equal(
        W.count_map(starts, PATCH, (32, 32, 16)).numpy(),
        np.asarray(JW.count_map(starts, PATCH, (32, 32, 16))))
    np.testing.assert_array_equal(W.gaussian_weight_map(PATCH).numpy(),
                                  np.asarray(JW.gaussian_weight_map(PATCH)))


# -- metrics -----------------------------------------------------------------

@pytest.mark.parametrize("ignore_index", [0, 255])
def test_metrics_match_jax(rng, ignore_index):
    """pairwise_dice_matrix, generalized_energy_distance (3 predictions, 4
    raters) and per_rater_test_metrics, f32 against the JAX functions at
    1e-5 (the JAX package divides in float32, the port in float64)."""
    probs = rng.dirichlet([1.0, 1.0], size=(3, 8, 8, 8)).astype(np.float32)
    probs = np.moveaxis(probs, -1, 1)                    # (3, C, 8, 8, 8)
    gt = (rng.rand(4, 8, 8, 8) > 0.5).astype(np.int32)
    a, b = probs.argmax(1).reshape(3, -1), gt.reshape(4, -1)
    _close(M.pairwise_dice_matrix(torch.tensor(a), torch.tensor(b),
                                  ignore_index),
           JM.pairwise_dice_matrix(jnp.asarray(a), jnp.asarray(b),
                                   ignore_index))
    got = M.generalized_energy_distance(torch.tensor(probs), torch.tensor(gt),
                                        ignore_index)
    want = JM.generalized_energy_distance(jnp.asarray(probs),
                                          jnp.asarray(gt), ignore_index)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    got = M.per_rater_test_metrics(torch.tensor(probs[:1]), torch.tensor(gt))
    want = JM.per_rater_test_metrics(jnp.asarray(probs[:1]), jnp.asarray(gt))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


# -- predictors --------------------------------------------------------------

def _grouped(members):
    """The members' grouped weights, as the engine holds them."""
    return cast_weights(to_torch_tree(group_member_variables(members)
                                      ["params"]), torch.float32, "cpu")


@pytest.mark.parametrize("members_n", [2, 1])
def test_default_predictor_matches_jax(rng, members_n):
    """Members outer: the port's grouped fused forward (M = 1 included)
    against the JAX package's vmapped flax apply, f32 at 1e-5."""
    members = _members()[:members_n]
    x = rng.rand(2, PATCH, PATCH, PATCH, 1).astype(np.float32)
    want, _ = jax.jit(JP.make_default_predictor(
        JaxUNet3D(num_classes=2, initial_filter_size=F), members_n, 1,
        False))(JP.stack_params(members), jnp.asarray(x),
                jax.random.PRNGKey(0))
    got, sigma = P.make_predictor("default", members_n)(_grouped(members),
                                                        torch.tensor(x))
    assert sigma is None and got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("members_n", [2, 1])
def test_aleatoric_transform_matches_jax_given_its_normals(rng, members_n):
    """The JAX aleatoric predictor's stacks, and the port's transform of
    the port's (mu, s) with the JAX predictor's own normals: f32 at 1e-5.
    The grouped predictor's stacks are that transform of the normals it
    draws from its generator, member-major."""
    members = _members(aleatoric=True)[:members_n]
    x = rng.rand(1, PATCH, PATCH, PATCH, 1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    model = JaxUNet3D(num_classes=2, initial_filter_size=F,
                      aleatoric_loss=True)
    want, want_sigma = jax.jit(JP.make_aleatoric_predictor(
        model, members_n, S))(JP.stack_params(members), jnp.asarray(x), key)
    mu, s = (torch.stack(t) for t in zip(*(
        eval_forward(to_torch_tree(m["params"]), torch.tensor(x))
        for m in members)))
    eps = np.stack([np.asarray(jax.random.normal(
        k, (S,) + tuple(mu.shape[1:]), dtype=jnp.float32))
        for k in jax.random.split(key, members_n)])
    got, sigma = aleatoric_softmax_samples(mu, s, torch.tensor(eps))
    _close(got, want)
    _close(sigma, want_sigma)

    grouped = P.make_predictor("aleatoric", members_n, n_aleatoric_samples=S)(
        _grouped(members), torch.tensor(x), torch.Generator().manual_seed(3))
    drawn = torch.randn((members_n, S) + tuple(mu.shape[1:]),
                        generator=torch.Generator().manual_seed(3))
    for g, w in zip(grouped, aleatoric_softmax_samples(mu, s, drawn)):
        _close(g, w)


# -- the engine --------------------------------------------------------------

ENGINE_CASES = {
    "uniform": dict(shape=(16, 32, 16)),
    "gaussian_overlap": dict(shape=(32, 24, 16), weight_mode="gaussian",
                             patch_overlap=0.5),
    "ragged_with_labels": dict(shape=(32, 32, 16), window_batch=3,
                               labels=True),
    "shape_bucket": dict(shape=(20, 32, 16), shape_bucket=16, labels=True),
}


@pytest.fixture(scope="module")
def engine_runs():
    """Each case's volume, labels and the JAX engine's outputs, computed
    once, at two members (JAX: the grouped lowering) and at one (JAX:
    vmapped flax); the port runs its grouped fused forward at both."""
    members = _members()
    rs = np.random.RandomState(11)
    runs = {}
    for name, case in ENGINE_CASES.items():
        kw = {k: v for k, v in case.items() if k not in ("shape", "labels")}
        vol = rs.rand(*case["shape"]).astype(np.float32)
        labels = ((rs.rand(2, *case["shape"]) > 0.5).astype(np.intc)
                  if case.get("labels") else None)
        for n in (2, 1):
            engine = JaxEngine(JaxUNet3D(num_classes=2, initial_filter_size=F),
                               members[:n], patch_size=PATCH,
                               use_grouped_ensemble=True, **kw)
            runs[name, n] = (vol, labels, kw, engine.run_volume(vol, labels))
    return members, runs


@pytest.mark.parametrize("members_n", [2, 1])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_run_volume_matches_jax(engine_runs, case, members_n):
    """softmax sums, counts, data sums and rater sums of one volume, f32 at
    1e-5 (seen: 2.4e-7)."""
    members, runs = engine_runs
    vol, labels, kw, want = runs[case, members_n]
    engine = SlidingWindowEngine(UNet3D(2, initial_filter_size=F),
                                 members[:members_n], patch_size=PATCH,
                                 device="cpu", **kw)
    got = engine.run_volume(vol, labels)
    for name, g, w in zip(("softmax", "counts", "data", "seg", "sigma"),
                          got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.shape == np.asarray(w).shape, name
        _close(g, w)


def test_engine_refusals():
    members = _members()
    model = UNet3D(2, initial_filter_size=F)
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        SlidingWindowEngine(model, members, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        SlidingWindowEngine(model, members, backend="tpu", device="cpu")
    with pytest.raises(NotImplementedError, match="TTA and SSN"):
        SlidingWindowEngine(model, members, mode="tta", device="cpu")
    with pytest.raises(NotImplementedError, match="TTA and SSN"):
        SlidingWindowEngine(model, members, n_pred=2, device="cpu")
    with pytest.raises(ValueError, match="aleatoric head"):
        SlidingWindowEngine(model, members, mode="aleatoric", device="cpu")
    with pytest.raises(TypeError, match="UNet3D"):
        SlidingWindowEngine(object(), members, device="cpu")


# -- the CLI end to end ------------------------------------------------------

def _toy_data_32(root):
    """Toy Case_1 at 32^3 (6 train, 2 test volumes, 3 raters), split into
    3 folds: 8 windows of 16^3 per volume."""
    case = root / "Case_1"
    for split, n in (("Tr", 6), ("Ts", 2)):
        cfg = ToyGenConfig(
            input_files=["ballSphere.stl"],
            save_path=str(case / f"images{split}"),
            n_samples=n, image_size=(32, 32, 32), min_object_ratio=5,
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
                    patch_size=PATCH, seed=123).prepare_data()


def _tree(root):
    """{relative path: array or metrics dict} of a result tree."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".json"):
                with open(path) as fh:
                    out[rel] = json.load(fh)
            else:
                out[rel] = jax_nifti.load(path)[0]
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two members trained jointly for one step by the port's
    EnsembleTrainer on the toy set, written as native checkpoints, then
    the JAX CLI over the val split (f32, chunks of 3, 3 and 2 windows)."""
    root = tmp_path_factory.mktemp("PortTest3d")
    _toy_data_32(root)
    cfg = make_config(compose("configs", "softmax_config", overrides=[
        f"data_input_dir={root}", f"save_dir={root}/exp",
        "datamodule.patch_size=16", "datamodule.data_num_folds=3",
        f"model.initial_filter_size={F}", "version=0"]).to_container())
    trainer = EnsembleTrainer(cfg, 2, "cpu")
    state = trainer.init_state(cfg.seed, PATCH)
    rs = np.random.RandomState(0)
    trainer.train_step(state, {
        "data": torch.tensor(rs.randn(2, 1, PATCH, PATCH, PATCH, 1),
                             dtype=torch.float32),
        "seg": torch.tensor(rs.rand(2, 1, PATCH, PATCH, PATCH) > 0.7)})
    ckpts = trainer.save_member_checkpoints(state, str(root / "ckpts"))
    common = ["--checkpoint_paths", *ckpts, "-i", str(root), "--test_split",
              "val", "--test_batch_size", "3"]
    # process-wide: the JAX engine stages volumes on a prefetch thread,
    # where the thread-local jax.enable_x64 context would not hold
    jax.config.update("jax_enable_x64", True)
    try:
        jax_test_3d.run_test(jax_test_3d.test_cli(
            common + ["--save_dir", str(root / "jax"), "--dtype",
                      "float64"]))
    finally:
        jax.config.update("jax_enable_x64", False)
    return root, common, _tree(root / "jax")


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("float64", 1e-10)])
def test_cli_writes_what_the_jax_cli_writes(cli_runs, dtype, atol):
    """The same output tree file for file, held against the JAX CLI in
    its float64 parity mode: every nii.gz map and every metrics.json
    value within 1e-5 at float32 (seen: 4.7e-7, the input map's float32
    rounding) and within 1e-10 at float64 (seen: 1.5e-14). The float64
    reference, because the JAX CLI's own float32 run is further off than
    1e-5 in one metric: its "loss", a float32 mean over 32^3 voxels, lies
    1.8e-5 from the same function in float64 on the same maps, where the
    port's float32 value lies 3.3e-8 from it."""
    root, common, want = cli_runs
    test_3d.run_test(test_3d.test_cli(
        common + ["--save_dir", str(root / f"port_{dtype}"), "--device",
                  "cpu", "--dtype", dtype]))
    got = _tree(root / f"port_{dtype}")
    assert sorted(got) == sorted(want)
    assert len(got) == 2 * 16 + 1   # 16 maps per volume and metrics.json
    for rel, w in want.items():
        if rel.endswith(".json"):
            assert sorted(got[rel]) == sorted(w)
            for image, metrics in w.items():
                assert sorted(got[rel][image]) == sorted(metrics), image
                for k, v in metrics.items():
                    assert got[rel][image][k] == pytest.approx(
                        v, abs=atol), (image, k)
        else:
            assert got[rel].shape == w.shape, rel
            _close(got[rel], w, atol)


@pytest.mark.parametrize("extra", [["-tta"], ["--n_pred", "2"],
                                   ["--sliding_window", "16", "16"]])
def test_cli_refuses_what_is_not_ported(cli_runs, extra):
    root, common, _ = cli_runs
    args = test_3d.test_cli(common + ["--save_dir", str(root / "x"),
                                      "--device", "cpu"] + extra)
    item = "'2D'" if "--sliding_window" in extra else "TTA and SSN"
    with pytest.raises(NotImplementedError, match=item):
        test_3d.run_test(args)
