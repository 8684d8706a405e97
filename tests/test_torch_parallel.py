"""The port's parallel layer (values_tpu_torch.parallel) on the CPU over
gloo, mirroring tests/test_parallel.py: one spawned world of 2 ranks runs
every case (the data-parallel steps, the sharded scorer, the engine's
window and sample strategies, the pass-range predictor), one of 4 ranks
the pass-range predictor again; each rank pickles its results and the
asserts below read them. The single-rank references run in this process
from the same functions (tests/torch_parallel_cases.py). The JAX package
holds the same cases on the same weights and inputs: its single-device
Experiment step, its engine over a mesh of virtual CPU devices, its
``make_sharded_scorer`` and its pass-range predictor (TTA's noise is the
JAX package's draw, replayed in the port)."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as C
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.config import compose as jax_compose
from values_tpu.inference import predictors as jpredictors
from values_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from values_tpu.inference.scoring import make_packed_scorer
from values_tpu.models.ensemble_unet3d import \
    group_member_variables as jax_group_members
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.parallel import mesh as jmesh
from values_tpu.training.experiment import Experiment as JaxExperiment
from values_tpu_torch.core.seed import fold_seed
from values_tpu_torch.inference.predictors import (make_pass_range_predictor,
                                                   make_predictor)
from values_tpu_torch.ops import losses as L
from values_tpu_torch.parallel.mesh import (hybrid_grid,
                                            initialize_distributed,
                                            make_hybrid_mesh, make_mesh,
                                            resolve_device_count)
from values_tpu_torch.training.experiment import Experiment


PASS_KEY = 9      # the JAX key of the pass-range predictors' TTA case


def _jax_tta_draw(key, shape):
    """The TTA noise the JAX pass-range predictor draws from ``key``
    (``values_tpu/inference/predictors.py:218-224``), in numpy."""
    var_key, noise_key, _ = jax.random.split(key, 3)
    variance = jax.random.uniform(var_key, (), minval=0.0, maxval=0.1)
    return (float(variance),
            np.array(jax.random.normal(noise_key, shape, jnp.float32)))


@pytest.fixture(scope="module")
def tta_draws():
    """The JAX package's TTA draws that the port replays: the pass-range
    predictor's from ``PRNGKey(PASS_KEY)``, and the engine's first window
    chunk's (its key is the second half of ``split(PRNGKey(seed))``)."""
    engine_key = jax.random.split(jax.random.PRNGKey(
        C.ENGINE_CASES["tta_sample"][0]["seed"]))[1]
    return {"pass/tta": _jax_tta_draw(jax.random.PRNGKey(PASS_KEY),
                                      (2, C.P, C.P, C.P, 1)),
            "engine/tta_sample": _jax_tta_draw(engine_key,
                                               (2, C.P, C.P, C.P, 1))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, tta_draws):
    """{world size: [rank 0's results, rank 1's, ...]}."""
    out = {}
    for world in (2, 4):
        path = tmp_path_factory.mktemp(f"world{world}")
        C.spawn_within(C.run_group, (str(path), world, tta_draws), world)
        out[world] = []
        for rank in range(world):
            with open(path / f"rank{rank}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def single_steps():
    return {name: C.step3d(name) for name in C.STEP_CASES}


# -- the data-parallel step ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(C.STEP_CASES))
def test_dp_step_matches_single_rank(worlds, single_steps, name):
    """Two ranks of 2 rows each against one step on the 4 rows: loss and
    final/kernel within 1e-5 in float32 (Adam's first step moves each
    weight by about the learning rate times the sign of its gradient;
    the loss sums in another order). The dropout masks and aleatoric
    normals are the global batch's rows (drawn at its shape), so they too
    equal the single-rank step's. Both ranks hold the same parameters
    after the step. (The 3D objective reduces in float32 whatever the
    forward's type, as the JAX one does: the float64 case is the HRNet
    step below.)"""
    got, want = worlds[2][0][f"step/{name}"], single_steps[name]
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)
    head = "final_aleatoric/kernel" if "aleatoric" in name else \
        "final/kernel"
    np.testing.assert_allclose(got["params"][head], want["params"][head],
                               atol=1e-5, rtol=0)
    other = worlds[2][1][f"step/{name}"]
    assert other["loss"] == got["loss"]
    for leaf, value in got["params"].items():
        assert np.array_equal(other["params"][leaf], value), leaf


def test_dp_step_matches_jax_single_device(worlds):
    """The same weights and batch through the JAX package's single-device
    Experiment step, float32: final/kernel within 1e-5; the loss within
    rtol 2e-4, the bound tests/test_torch_training.py holds the port's
    single-device step to (the two packages' float32 losses differ by
    2.4e-5 here with or without data parallelism)."""
    cfg = jax_compose("configs", "softmax_config", overrides=[
        f"model.initial_filter_size={C.F}", f"datamodule.patch_size={C.P}",
        "learning_rate=0.001"])
    exp = JaxExperiment(cfg)
    state = exp.state_from_variables({"params": jax.tree_util.tree_map(
        jnp.asarray, C.initial_params("softmax_f32"))})
    batch = {k: jnp.asarray(v) for k, v in C.batch3d().items()}
    state, loss = exp.train_step(state, batch, jax.random.PRNGKey(1))
    got = worlds[2][0]["step/softmax_f32"]
    assert got["loss"] == pytest.approx(float(loss), rel=2e-4)
    np.testing.assert_allclose(got["params"]["final/kernel"],
                               np.asarray(state.params["final"]["kernel"]),
                               atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def single_2d():
    return C.step2d()


def test_masked_ce_step_matches_single_rank(worlds, single_2d):
    """The HRNet step with ignore_index 255 split unevenly over the ranks
    (60% of rank 0's pixels ignored, 10% of rank 1's), float64: the loss
    within 1e-10 and every parameter within 1e-8 of the single-rank step
    (the synced BatchNorm's two-pass statistics and torch's own round
    apart by ~1e-16, which the backward grows to ~1e-10): each rank
    divides its sum by the global batch's kept pixels (times the ranks).
    Plain per-rank means, averaged, would miss the global mean by more
    than 1e-3 on these labels (5.7e-3): the test shows the fault it
    guards."""
    got = worlds[2][0]["step2d"]
    assert got["loss"] == pytest.approx(single_2d["loss"], abs=1e-10)
    for leaf, w in single_2d["params"].items():
        np.testing.assert_allclose(got["params"][leaf], w, atol=1e-8,
                                   rtol=0, err_msg=leaf)
    exp = Experiment(C.config2d(), "cpu")
    model = exp.init_state_2d(0, C.H2, C.W2, 3).params.to(torch.float64)
    batch = C.batch2d()
    with torch.no_grad():
        logits = exp.forward_2d(model, torch.from_numpy(batch["data"]))
    seg = torch.from_numpy(batch["seg"])
    whole = float(L.cross_entropy(logits, seg, ignore_index=255))
    halves = [float(L.cross_entropy(logits[i:i + 2], seg[i:i + 2],
                                    ignore_index=255)) for i in (0, 2)]
    assert abs(np.mean(halves) - whole) > 1e-3


def test_batchnorm_statistics_are_the_global_batch(worlds, single_2d):
    """BatchNorm over the data axis: the running statistics after the step
    (flax's update of the global batch's mean and biased variance) equal
    the single-rank step's within 1e-10 (float64) on both ranks, and
    moved from their initial values."""
    for rank in (0, 1):
        got = worlds[2][rank]["step2d"]["batch_stats"]
        for leaf, w in single_2d["batch_stats"].items():
            np.testing.assert_allclose(got[leaf], w, atol=1e-10, rtol=0,
                                       err_msg=leaf)
    assert np.abs(single_2d["batch_stats"]["bn1.running_mean"]).max() > 1e-3


# -- the mesh -----------------------------------------------------------------

def test_resolve_device_count():
    assert resolve_device_count(None) == 1
    assert resolve_device_count("1") == 1
    assert resolve_device_count(4) == 4
    assert resolve_device_count("all", available=8) == 8
    assert resolve_device_count(-1, available=8) == 8


def test_hybrid_grid_is_granule_major_and_refuses_a_ragged_world():
    """Each data half is one granule's ranks (contiguous blocks where the
    nodes are not known, the given nodes where they are), and a world
    that does not divide into granules x sample raises the JAX error."""
    grid = hybrid_grid(8, n_sample=2, dcn_data=2)
    assert grid.shape == (4, 2)
    first, second = set(grid[:2].ravel()), set(grid[2:].ravel())
    assert first.isdisjoint(second) and first | second == set(range(8))
    grid = hybrid_grid(4, n_sample=1, dcn_data=2, granules=[1, 1, 0, 0])
    assert grid.ravel().tolist() == [2, 3, 0, 1]
    with pytest.raises(ValueError, match="not divisible into 2 DCN"):
        hybrid_grid(6, n_sample=2, dcn_data=2)


def test_a_world_past_its_deadline_is_ended():
    """``spawn_within``: a rank that would run for an hour is killed at
    the deadline, and the test that spawned it fails at once with
    TimeoutError, leaving no rank behind."""
    import multiprocessing
    import time
    before = set(multiprocessing.active_children())
    start = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline"):
        C.spawn_within(time.sleep, (3600,), 1, seconds=5)
    assert time.monotonic() - start < 60
    assert set(multiprocessing.active_children()) <= before


def test_initialize_distributed_is_a_noop_without_a_launcher(monkeypatch):
    """No launcher variables: nothing joined, a world of 1, and a
    single-granule hybrid mesh falls back to the plain one."""
    for key in ("COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() == 1
    assert not torch.distributed.is_initialized()
    assert make_hybrid_mesh().shape == {"data": 1, "sample": 1}
    assert make_mesh().data_group is None
    with pytest.raises(ValueError, match="mesh 2x1"):
        make_mesh(n_data=2)


# -- the sharded scorer -------------------------------------------------------

def _score(b, dropout, seed=C.SCORE_SEED, rows=slice(None)):
    weights, vols, gt = C.score_inputs(b, dropout)
    return C.scorer(dropout)(weights, vols[rows], gt[rows], seed).numpy()


def test_sharded_scorer_deterministic_matches_unsharded(worlds):
    """Each rank scores 4 of the 8 volumes; the gathered (10, 8) matrix
    equals the unsharded scorer's within 1e-5 (the batch's grouping moves
    no per-volume sum)."""
    (got,) = worlds[2][0]["score/deterministic"]
    np.testing.assert_allclose(got.numpy(), _score(8, False), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(worlds[2][1]["score/deterministic"][0], got)


def test_sharded_scorer_pads_ragged_batch(worlds):
    """5 volumes over 2 ranks: zero-padded to 6, the pad's column cut."""
    (got,) = worlds[2][0]["score/ragged"]
    want = _score(5, False)
    assert got.shape == want.shape == (10, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_sharded_scorer_per_rank_streams(worlds):
    """MC dropout over 2 ranks: rank i scores its half with the seed
    folded with i (fold_in's counterpart), so the result is the local
    scorer on each half with that seed; the two ranks' streams differ,
    and a second run repeats the first exactly."""
    first, second = worlds[2][0]["score/dropout"]
    assert torch.equal(first, second)
    seeds = [fold_seed(C.SCORE_SEED, i) for i in range(2)]
    assert seeds[0] != seeds[1]
    want = np.concatenate([_score(8, True, s, slice(4 * i, 4 * i + 4))
                           for i, s in enumerate(seeds)], axis=1)
    np.testing.assert_allclose(first.numpy(), want, atol=1e-6, rtol=1e-6)
    same_seed = _score(8, True, seeds[1], slice(0, 4))
    assert not np.allclose(same_seed, want[:, :4])


# -- the sample axis: the pass-range predictor --------------------------------

@pytest.mark.parametrize("mode", sorted(C.PASS_MODES))
def test_pass_sharding_shard_count_invariant(worlds, tta_draws, mode):
    """The same passes on 1, 2 and 4 sample ranks: every draw comes from
    its global pass's generator. atol 1e-6: a rank's members run as a
    smaller group, whose convolutions add in another order (the JAX
    test's bound for its 1/2/4-shard programs)."""
    weights, x, members, kw = C.pass_inputs(mode)
    with C.replayed_tta_noise(tta_draws.get(f"pass/{mode}")):
        one = make_pass_range_predictor(mode, members, **kw)(
            weights, x, torch.Generator().manual_seed(9))
    s_total = {"tta": 16 * members}.get(mode, members * 4)
    assert one[0].shape[0] == s_total
    for world in (2, 4):
        for rank in range(world):
            stack, sigma = worlds[world][rank][f"pass/{mode}"]
            np.testing.assert_allclose(stack.numpy(), one[0].numpy(),
                                       atol=1e-6, err_msg=f"{world}/{rank}")
            if one[1] is not None:
                np.testing.assert_allclose(sigma.numpy(), one[1].numpy(),
                                           atol=1e-6)


def test_pass_range_deterministic_matches_unsharded_default():
    """Without draws (no dropout, one pass a member) the pass ranges equal
    the grouped ensemble predictor exactly, whatever range is asked."""
    weights = C.grouped(C.member_trees("softmax_config", 4))
    x = C.pass_inputs("tta")[1]
    want, _ = make_predictor("default", 4)(weights, x)
    predict = make_pass_range_predictor("default", 4)
    assert torch.equal(predict(weights, x, None)[0], want)
    np.testing.assert_allclose(predict(weights, x, None, 1, 2)[0].numpy(),
                               want[1:3].numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="range"):
        predict(weights, x, None, 3, 2)


# -- the engine over a mesh ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(C.ENGINE_CASES))
def test_engine_sharded_matches_single_rank(worlds, tta_draws, name):
    """``SlidingWindowEngine(mesh=...)`` against the engine without one:
    "window" over 2 data ranks (5 windows padded to 6 with a zero-weight
    window), "sample" and TTA's 16 variants over 2 sample ranks; every
    rank returns the whole volume. Counts exactly; softmax and data sums
    within 2e-5 (test_parallel.py's bound), seg sums exactly."""
    want = C.run_engine(name, draw=tta_draws.get(f"engine/{name}"))
    for rank in (0, 1):
        got = worlds[2][rank][f"engine/{name}"]
        for key, g, w in zip(("softmax", "counts", "data", "seg", "sigma"),
                             got, want):
            if w is None:
                assert g is None, key
                continue
            assert g.shape == w.shape, key
            if key in ("counts", "seg"):
                assert np.array_equal(g, w), key
            else:
                np.testing.assert_allclose(g, w, atol=2e-5, err_msg=key)


def test_sample_predict_shards_members(worlds):
    """``make_parallel_sample_predict``: each of 2 sample ranks runs one
    of 2 members; the gathered stack equals the grouped ensemble
    predictor's (atol 1e-6: a member alone is a group of one)."""
    weights, x, _, _ = C.pass_inputs("tta")
    want, _ = make_predictor("default", 2)(weights, x)
    for rank in (0, 1):
        got = worlds[2][rank]["sample_predict"]
        assert got.shape == want.shape == (2, 2, C.P, C.P, C.P, 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_spatially_sharded_volume_matches_single_device(worlds):
    """``make_sharded_volume_predictor``: 3 windows padded to 4 by
    repeating the last, 2 a rank, one all-reduce. The sums and counts
    equal one device stitching the same padded list (the repeated window
    counted twice, normalized away), as tests/test_parallel.py holds the
    JAX one."""
    from values_tpu_torch.ops.window import extract_windows, stitch_windows
    weights, vol, starts = C.spatial_inputs()
    assert len(starts) == 4
    wins = extract_windows(vol, starts, C.P)
    stack, _ = make_predictor("default", 1)(weights, wins[..., None])
    want_sums = stitch_windows(stack[0], starts, tuple(vol.shape) + (2,))
    want_counts = stitch_windows(torch.ones(wins.shape), starts,
                                 tuple(vol.shape))
    for rank in (0, 1):
        sums, counts = worlds[2][rank]["spatial"]
        assert torch.equal(counts, want_counts)
        assert float(counts.max()) == 2.0 and float(counts.min()) == 1.0
        np.testing.assert_allclose(sums[0].numpy(), want_sums.numpy(),
                                   atol=1e-6)


# -- the JAX package's sharded paths on the same inputs -----------------------

def _jax_trees(trees):
    return [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]


def _jax_mesh(n_data, n_sample):
    return jmesh.make_mesh(n_data=n_data, n_sample=n_sample,
                           devices=jax.devices()[:n_data * n_sample])


@pytest.mark.parametrize("name,b", [("deterministic", 8), ("ragged", 5)])
def test_sharded_scorer_matches_jax_sharded_scorer(worlds, name, b):
    """The port's sharded deterministic scorer over 2 ranks against the
    JAX package's ``make_sharded_scorer`` over 2 devices on the same
    members and volumes (its packed scorer in interpret mode;
    VALUES_TPU_AGG_LINEAR=0 set before it is traced, fault R1): atol =
    rtol = 5e-3, tests/test_torch_scoring.py's bound between the two
    packages' single-device scorers."""
    trees = C.member_trees("softmax_config", 2)
    vols, gt = C.score_arrays(b)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        score, _ = make_packed_scorer(2, C.P, agg_patch=4,
                                      dtype=jnp.float32, interpret=True)
        want = np.asarray(jmesh.make_sharded_scorer(score, _jax_mesh(2, 1))(
            jax_group_members(_jax_trees(trees)), jnp.asarray(vols),
            jnp.asarray(gt), jax.random.PRNGKey(C.SCORE_SEED)))
    (got,) = worlds[2][0][f"score/{name}"]
    assert got.shape == want.shape == (10, b)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("name", sorted(C.ENGINE_CASES))
def test_engine_sharded_matches_jax_engine(worlds, name):
    """The port's engine over 2 ranks against the JAX package's engine
    over a mesh of 2 devices with the same strategy, members, volume and
    labels ("window": 2 data devices; "sample" and TTA: 2 sample
    devices, TTA's noise the JAX engine's draw replayed): counts and seg
    sums exactly, softmax and data sums within 2e-5 (test_parallel.py's
    bound between the JAX package's sharded and single-device
    engines)."""
    kw, strategy = C.ENGINE_CASES[name]
    trees, vol, labels = C.engine_inputs(name)
    mesh = _jax_mesh(2, 1) if strategy == "window" else _jax_mesh(1, 2)
    want = JaxEngine(JaxUNet3D(num_classes=2, initial_filter_size=C.F),
                     _jax_trees(trees), patch_size=C.P, mesh=mesh,
                     mesh_strategy=strategy, **kw).run_volume(vol, labels)
    got = worlds[2][0][f"engine/{name}"]
    for key, g, w in zip(("softmax", "counts", "data", "seg", "sigma"),
                         got, want):
        if w is None:
            assert g is None, key
            continue
        w = np.asarray(w)
        assert g.shape == w.shape, key
        if key in ("counts", "seg"):
            assert np.array_equal(g, w), key
        else:
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=key)


def test_pass_range_tta_matches_jax(worlds, tta_draws):
    """TTA's 32 passes (2 members x 16 variants) of the JAX package's
    pass-range predictor (``values_tpu/inference/predictors.py:181``)
    against the port's, given the JAX draw of the noise: the ranges of 2
    and 4 sample ranks, gathered, and one range, [12, 20), that cuts
    both members' variants; within 1e-5 (tests/test_torch_test_3d.py's
    float32 bound between the two packages' engines)."""
    weights, x, _, _ = C.pass_inputs("tta")
    trees = C.member_trees("softmax_config", 2)
    local = jpredictors.make_pass_range_predictor(
        JaxUNet3D(num_classes=2, initial_filter_size=C.F), "tta", 2)
    want = np.asarray(jax.jit(lambda v, xx, k: local(v, xx, k, 0, 32)[0])(
        jpredictors.stack_params(_jax_trees(trees)), jnp.asarray(x.numpy()),
        jax.random.PRNGKey(PASS_KEY)))
    assert want.shape == (32, 2, C.P, C.P, C.P, 2)
    for world in (2, 4):
        for rank in range(world):
            np.testing.assert_allclose(
                worlds[world][rank]["pass/tta"][0].numpy(), want, atol=1e-5,
                rtol=0, err_msg=f"{world}/{rank}")
    with C.replayed_tta_noise(tta_draws["pass/tta"]):
        part, _ = make_pass_range_predictor("tta", 2)(weights, x, None, 12, 8)
    np.testing.assert_allclose(part.numpy(), want[12:20], atol=1e-5, rtol=0)
