"""The cases of tests/test_torch_parallel.py, run twice: in every rank of
a spawned gloo world (``run_group``, through the port's own
``values_tpu_torch.parallel.launch.spawn``, bounded by ``spawn_within``)
and, for the single-rank references, in the test process. The module
imports no JAX, so a rank starts with torch and the port alone; each rank
runs one intra-op thread, and so does every port test module that imports
``one_torch_thread``."""
from __future__ import annotations

import contextlib
import multiprocessing
import os
import pickle
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from values_tpu_torch.config import compose, make_config
from values_tpu_torch.inference.engine import SlidingWindowEngine
from values_tpu_torch.inference.scoring import (make_dropout_scorer,
                                                make_scorer)
from values_tpu_torch.models import ensemble_unet3d as E
from values_tpu_torch.models.ensemble_unet3d import (cast_weights,
                                                     group_member_variables)
from values_tpu_torch.models.unet3d import UNet3D
from values_tpu_torch.parallel import launch
from values_tpu_torch.parallel.mesh import (initialize_distributed,
                                            make_mesh,
                                            make_parallel_pass_predict,
                                            make_parallel_train_step,
                                            shard_rows)
from values_tpu_torch.training.checkpoint import to_torch_tree
from values_tpu_torch.training.experiment import Experiment, tree_leaves

CONFIGS = str(Path(__file__).resolve().parents[1] / "configs")
P, F = 16, 2
B3 = 4                       # the 3D steps' global batch
B2, H2, W2, C2 = 4, 64, 64, 5  # the 2D step's global batch, 5 classes
SCORE_SEED = 21
WORLD_DEADLINE_S = 300    # a spawned world's limit; its cases take ~30-60 s


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a port test module's CPU work, imported by
    every ``tests/test_torch_*.py``. Tier-1 runs six xdist workers on the
    host's cores; at torch's default of a thread per core, each op's
    OpenMP barrier waits on threads the other workers have descheduled,
    and a test of many small ops runs tens of times slower (a small
    HRNet's sliding-window passes in a six-worker run: 916 s, against
    13 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spawn_within(fn, args, nprocs: int, seconds: float = WORLD_DEADLINE_S):
    """``launch.spawn(fn, args, nprocs)`` with a deadline: past
    ``seconds``, every rank it started that still runs is killed, so
    ``spawn`` raises for the rank a signal ended, and this raises
    TimeoutError. A stuck rendezvous fails its test instead of holding
    the tier-1 run to its clock."""
    before = set(multiprocessing.active_children())
    fired = threading.Event()

    def end_ranks():
        fired.set()
        for proc in set(multiprocessing.active_children()) - before:
            proc.kill()

    timer = threading.Timer(seconds, end_ranks)
    timer.daemon = True
    timer.start()
    try:
        return launch.spawn(fn, args, nprocs)
    except torch.multiprocessing.ProcessExitedException as err:
        if fired.is_set():
            raise TimeoutError(f"a world of {nprocs} ranks ran past its "
                               f"{seconds} s deadline") from err
        raise
    finally:
        timer.cancel()


# -- data-parallel training steps ---------------------------------------------

STEP_CASES = {               # name: (config, overrides, dtype)
    "softmax_f32": ("softmax_config", [], torch.float32),
    "dropout_f32": ("dropout_config", [], torch.float32),
    "aleatoric_f32": ("softmax_config", ["+aleatoric_loss=true",
                                         "n_aleatoric_samples=3"],
                      torch.float32),
}


def step_config(name: str):
    config, extra, _ = STEP_CASES[name]
    return compose(CONFIGS, config, [
        f"model.initial_filter_size={F}", f"datamodule.patch_size={P}",
        "learning_rate=0.001"] + extra)


def batch3d(seed: int = 0):
    rs = np.random.RandomState(seed)
    return {"data": rs.rand(B3, P, P, P, 1).astype(np.float32),
            "seg": rs.randint(0, 2, size=(B3, P, P, P))}


def initial_params(name: str):
    """The step's initial flax tree (numpy float32)."""
    exp = Experiment(step_config(name), "cpu")
    return exp.initial_params(0)


def step3d(name: str, mesh=None):
    """One Experiment step of ``name`` from :func:`initial_params` on
    :func:`batch3d`, on the global batch or over ``mesh``'s data axis;
    its loss and every leaf after the step (numpy)."""
    dtype = STEP_CASES[name][2]
    exp = Experiment(step_config(name), "cpu")
    state = exp.state_from_variables({"params": initial_params(name)})
    for leaf in tree_leaves(state.params):
        leaf.data = leaf.data.to(dtype)
    batch = {k: torch.from_numpy(v) for k, v in batch3d().items()}
    batch["data"] = batch["data"].to(dtype)
    generator = torch.Generator().manual_seed(1)
    if mesh is None:
        state, loss = exp.train_step(state, batch, generator)
    else:
        step = make_parallel_train_step(exp, mesh)
        state, loss = step(state, shard_rows(batch, mesh), generator)
    return {"loss": float(loss), "params": _flat(state.params)}


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value.detach().numpy().copy()
    return out


def small_hrnet_cfg(num_classes: int = C2):
    """tests/test_hrnet.py::small_cfg (2 + 3 + 4 branches, narrow)."""
    basic = {"BLOCK": "BASIC", "FUSE_METHOD": "SUM"}
    return {"DATASET": {"NUM_CLASSES": num_classes}, "MODEL": {
        "NAME": "hrnet", "PRETRAINED": False, "ALIGN_CORNERS": False,
        "INPUT_CHANNELS": 3,
        "EXTRA": {
            "FINAL_CONV_KERNEL": 1,
            "STAGE1": {"NUM_MODULES": 1, "NUM_BRANCHES": 1,
                       "BLOCK": "BOTTLENECK", "NUM_BLOCKS": [2],
                       "NUM_CHANNELS": [8], "FUSE_METHOD": "SUM"},
            "STAGE2": dict(basic, NUM_MODULES=1, NUM_BRANCHES=2,
                           NUM_BLOCKS=[2, 2], NUM_CHANNELS=[4, 8]),
            "STAGE3": dict(basic, NUM_MODULES=2, NUM_BRANCHES=3,
                           NUM_BLOCKS=[2, 2, 2], NUM_CHANNELS=[4, 8, 16],
                           DROPOUT=[False] * 3),
            "STAGE4": dict(basic, NUM_MODULES=1, NUM_BRANCHES=4,
                           NUM_BLOCKS=[2, 2, 2, 2],
                           NUM_CHANNELS=[4, 8, 16, 32],
                           DROPOUT=[False] * 4)}}}


def config2d():
    return make_config({
        "seed": 1, "learning_rate": 0.01, "weight_decay": 0.0005,
        "datamodule": {"ignore_index": 255, "num_classes": C2},
        "model": {"_target_": "values_tpu.models.hrnet.get_seg_model",
                  "cfg": small_hrnet_cfg()},
        "optimizer": {"_target_": "torch.optim.SGD", "lr": 0.01,
                      "momentum": 0.9, "weight_decay": 0.0005}})


def batch2d():
    """(B2, H2, W2, 3) images and labels whose ignored (255) pixels fall
    unevenly: the first half of the batch (rank 0's rows over 2 ranks)
    ignores 60% of its pixels, the second half 10%."""
    rs = np.random.RandomState(4)
    seg = rs.randint(0, C2, size=(B2, H2, W2))
    ignored = rs.rand(B2, H2, W2) < np.where(
        np.arange(B2) < B2 // 2, 0.6, 0.1)[:, None, None]
    seg[ignored] = 255
    return {"data": rs.rand(B2, H2, W2, 3), "seg": seg}


def step2d(mesh=None):
    """One float64 HRNet step (masked CE, BatchNorm in training mode)
    on :func:`batch2d`; its loss, parameters and BatchNorm running
    statistics after it (float64, the module's own names)."""
    exp = Experiment(config2d(), "cpu")
    state = exp.init_state_2d(0, H2, W2, 3)
    state.params.to(torch.float64)
    batch = {"data": torch.from_numpy(batch2d()["data"]),
             "seg": torch.from_numpy(batch2d()["seg"])}
    if mesh is None:
        state, loss = exp.train_step(state, batch)
    else:
        step = make_parallel_train_step(exp, mesh)
        state, loss = step(state, shard_rows(batch, mesh))
    model = state.params
    return {"loss": float(loss),
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.named_parameters()},
            "batch_stats": {k: v.numpy().copy()
                            for k, v in model.named_buffers()
                            if k.endswith(("running_mean", "running_var"))}}


# -- inference ----------------------------------------------------------------

def member_trees(config: str, n: int, extra=()):
    """n flax trees of ``config``'s UNet3D (f 2) from seeds 0..n-1."""
    exp = Experiment(compose(CONFIGS, config, [
        f"model.initial_filter_size={F}", f"datamodule.patch_size={P}",
        *extra]), "cpu")
    return [{"params": exp.initial_params(seed)} for seed in range(n)]


def grouped(trees):
    return cast_weights(to_torch_tree(group_member_variables(trees)
                                      ["params"]), torch.float32,
                        torch.device("cpu"))


@contextlib.contextmanager
def replayed_tta_noise(draw):
    """TTA's noise given rather than drawn: ``draw`` is (variance, noise)
    in numpy (the JAX package's draw, so both packages see one noisy
    input), or None to draw from the generator as usual."""
    if draw is None:
        yield
        return
    variance, noise = draw

    def replay(generator, shape, dtype, device):
        assert tuple(shape) == noise.shape
        return (torch.tensor(variance, dtype=dtype, device=device),
                torch.from_numpy(noise).to(device, dtype))
    saved, E.draw_tta_noise = E.draw_tta_noise, replay
    try:
        yield
    finally:
        E.draw_tta_noise = saved


def score_arrays(b: int):
    """The scorer's b volumes (b, P, P, P, 1) and masks (numpy)."""
    rs = np.random.RandomState(b)
    vols = rs.rand(b, P, P, P, 1).astype(np.float32)
    return vols, (rs.rand(b, P, P, P) > 0.7).astype(np.int32)


def score_inputs(b: int, dropout: bool = False):
    trees = member_trees("dropout_config" if dropout else "softmax_config",
                         2)
    vols, gt = score_arrays(b)
    return grouped(trees), torch.from_numpy(vols), torch.from_numpy(gt)


def scorer(dropout: bool):
    """The deterministic scorer with the seed argument the sharded scorer
    passes, or the MC-dropout scorer (2 passes)."""
    kw = dict(agg_patch=4, dtype=torch.float32, device="cpu")
    if dropout:
        return make_dropout_scorer(2, P, n_pred=2, **kw)[0]
    score, _ = make_scorer(2, P, **kw)
    return lambda weights, volumes, gt, seed: score(weights, volumes, gt)


PASS_MODES = {   # mode: (config, extra overrides, members, predictor kw)
    "default": ("dropout_config", (), 2, {"n_pred": 4, "do_dropout": True}),
    "tta": ("softmax_config", (), 2, {}),
    "aleatoric": ("softmax_config", ("+aleatoric_loss=true",), 2,
                  {"n_aleatoric_samples": 4}),
    "ssn": ("ssn_config", ("model.rank=3",), 2,
            {"n_pred": 4, "num_classes": 2, "rank": 3}),
}


def pass_inputs(mode: str):
    config, extra, members, kw = PASS_MODES[mode]
    x = torch.from_numpy(np.random.RandomState(3).rand(2, P, P, P, 1)
                         .astype(np.float32))
    return grouped(member_trees(config, members, extra)), x, members, kw


def engine_models():
    return UNet3D(2, initial_filter_size=F), member_trees("softmax_config",
                                                          2)


def engine_volume():
    rs = np.random.RandomState(5)
    vol = rs.rand(P, 5 * P, P).astype(np.float32)          # 5 windows
    labels = (rs.rand(2, P, 5 * P, P) > 0.5).astype(np.intc)
    return vol, labels


ENGINE_CASES = {   # name: (engine kwargs, strategy)
    "window": (dict(window_batch=2), "window"),
    "sample": (dict(window_batch=2), "sample"),
    "tta_sample": (dict(mode="tta", window_batch=2, seed=5), "sample"),
}


def engine_inputs(name: str):
    """The members' flax trees, the volume and the labels (or None) of
    engine case ``name``."""
    _, trees = engine_models()
    if name == "tta_sample":   # 2 windows: one chunk, one noise draw
        vol = np.random.RandomState(6).rand(2 * P, P, P).astype(np.float32)
        return trees[:1], vol, None
    return (trees,) + engine_volume()


def run_engine(name: str, mesh=None, draw=None):
    """Engine case ``name`` on the global batch or over ``mesh``; TTA's
    noise replayed from ``draw`` (:func:`replayed_tta_noise`)."""
    kw, strategy = ENGINE_CASES[name]
    trees, vol, labels = engine_inputs(name)
    engine = SlidingWindowEngine(engine_models()[0], trees, patch_size=P,
                                 device="cpu", mesh=mesh,
                                 mesh_strategy=strategy, **kw)
    with replayed_tta_noise(draw):
        return engine.run_volume(vol, labels)


def run_sample_predict(mesh):
    """``make_parallel_sample_predict``: 2 deterministic members, one a
    sample rank, gathered member-major."""
    from values_tpu_torch.parallel.mesh import make_parallel_sample_predict
    weights, x, _, _ = pass_inputs("tta")
    return make_parallel_sample_predict(2, mesh)(weights, x)


def spatial_inputs():
    """One member's weights, a volume of 3 windows and its window list
    padded to 2 data ranks by repeating the last window."""
    from values_tpu_torch.ops.window import enumerate_window_starts
    from values_tpu_torch.parallel.spatial import pad_starts_to_shards
    vol = np.random.RandomState(7).rand(P, 3 * P, P).astype(np.float32)
    starts = enumerate_window_starts(vol.shape, P, 1.0)
    return (grouped(member_trees("softmax_config", 1)),
            torch.from_numpy(vol), pad_starts_to_shards(starts, 2))


def run_spatial(mesh):
    """``make_sharded_volume_predictor`` over the data axis."""
    from values_tpu_torch.inference.predictors import make_predictor
    from values_tpu_torch.parallel.spatial import \
        make_sharded_volume_predictor
    weights, vol, starts = spatial_inputs()
    fn = make_sharded_volume_predictor(make_predictor("default", 1), mesh,
                                       P, tuple(vol.shape), num_classes=2)
    return fn(weights, vol, starts)


# -- the spawned group --------------------------------------------------------

def run_group(out_dir: str, world: int, draws) -> None:
    """Every case of this world size, in this rank; rank r's results go
    to ``out_dir/rank{r}.pkl``. ``draws``: the TTA noise to replay for
    ``"pass/tta"`` and ``"engine/tta_sample"``."""
    torch.set_num_threads(1)
    assert initialize_distributed("gloo") == world
    rank = torch.distributed.get_rank()
    results = {}
    by_sample = make_mesh(n_data=1, n_sample=world)
    for mode, (_, _, members, kw) in PASS_MODES.items():
        weights, x, _, _ = pass_inputs(mode)
        predict = make_parallel_pass_predict(mode, members, by_sample, **kw)
        with replayed_tta_noise(draws.get(f"pass/{mode}")):
            results[f"pass/{mode}"] = predict(
                weights, x, torch.Generator().manual_seed(9))
    if world == 2:
        by_data = make_mesh(n_data=world, n_sample=1)
        for name in STEP_CASES:
            results[f"step/{name}"] = step3d(name, by_data)
        results["step2d"] = step2d(by_data)
        from values_tpu_torch.parallel.mesh import make_sharded_scorer
        for name, b, dropout in (("deterministic", 8, False),
                                 ("ragged", 5, False),
                                 ("dropout", 8, True)):
            score = make_sharded_scorer(scorer(dropout), by_data)
            results[f"score/{name}"] = [
                score(*score_inputs(b, dropout), SCORE_SEED)
                for _ in range(2 if dropout else 1)]
        for name, (_, strategy) in ENGINE_CASES.items():
            mesh = by_data if strategy == "window" else by_sample
            results[f"engine/{name}"] = run_engine(
                name, mesh, draws.get(f"engine/{name}"))
        results["sample_predict"] = run_sample_predict(by_sample)
        results["spatial"] = run_spatial(by_data)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_fit_group(out_dir: str, train_argv, config_2d, score_argv) -> None:
    """tests/test_torch_parallel_fit.py's world: the training CLI on a 3D
    config with ``devices=2``, ``fit`` on a 2D one with ``gpus=2``, and
    the score CLI with ``--devices 2`` on the 3D checkpoint, each in every
    rank; the checkpoints' paths go to ``out_dir/rank{r}.pkl``."""
    from values_tpu_torch.inference.score import run_score, score_cli
    from values_tpu_torch.training.loops import fit
    from values_tpu_torch.training.main import main
    torch.set_num_threads(1)
    ckpt_3d = main(train_argv)
    ckpt_2d = fit(make_config(config_2d), device="cpu")
    run_score(score_cli(score_argv + ["--checkpoint_paths", ckpt_3d]))
    rank = torch.distributed.get_rank()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"3d": ckpt_3d, "2d": ckpt_2d}, f)
