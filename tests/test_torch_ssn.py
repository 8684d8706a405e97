"""The port's SSN (values_tpu_torch.models.ssn_unet3d, the SSN scorer and
the engine's ``ssn`` mode) against the JAX package's, given the same
normals, and the port's own draws checked statistically.

The JAX side's normals are replayed through the port's one draw
function, ``values_tpu_torch.models.ssn_unet3d.draw_ssn_normals``:
``LowRankMVN.rsample`` draws ``normal(k1, (n, B, R))`` and ``normal(k2,
(n, B, C*V))`` with ``k1, k2 = split(key)`` (``ssn_unet3d.py:63-75``);
the packed scorer's sample (m, s) keys on ``fold_in(rng, m*n_pred + s)``
over the padded batch (``scoring.py:527-533``); the engine keys each
window chunk on ``split(engine.rng)`` (``engine.py:386-388``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.inference import scoring as jscoring
from values_tpu.inference.engine import SlidingWindowEngine as JaxEngine
from values_tpu.models.ensemble_unet3d import group_member_variables
from values_tpu.models.ssn_unet3d import SsnUNet3D as JaxSsnUNet3D
from values_tpu.models.torch_import import \
    unet3d_params_from_torch as jax_params_from_torch
from values_tpu_torch.config import instantiate, make_config
from values_tpu_torch.inference.engine import SlidingWindowEngine
from values_tpu_torch.inference.scoring import make_ssn_scorer
from values_tpu_torch.models import ssn_unet3d as S
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_from_torch,
                                                  unet3d_params_to_torch)
from values_tpu_torch.models.unet3d import UNet3D

M, P, B, BP, AGG, N_PRED, RANK, C = 2, 16, 4, 8, 4, 2, 3, 2


def _jax_members(f, n=M):
    model = JaxSsnUNet3D(num_classes=C, initial_filter_size=f, rank=RANK)
    return [flax_init(model, 40 + m, jnp.zeros((1, P, P, P, 1)))
            for m in range(n)]


def _normals(key, n, b, dim, dtype, pad=None):
    """What ``LowRankMVN.rsample`` draws from ``key`` (over ``pad`` items
    when the JAX side padded the batch), the first ``b`` items."""
    k1, k2 = jax.random.split(key)
    rows = pad or b
    eps_r = jax.random.normal(k1, (n, rows, RANK), dtype)[:, :b]
    eps_d = jax.random.normal(k2, (n, rows, dim), dtype)[:, :b]
    return torch.from_numpy(np.array(eps_r)), torch.from_numpy(np.array(eps_d))


class _Normals:
    """A stand-in for ``draw_ssn_normals``: call i gets ``draws[i]``,
    checked against the shapes asked for."""

    def __init__(self, draws):
        self.draws, self.calls = draws, 0

    def __call__(self, generator, n, batch, rank, dim, dtype, device):
        eps_r, eps_d = self.draws[self.calls]
        self.calls += 1
        assert eps_r.shape == (n, batch, rank) and eps_d.shape == (n, batch,
                                                                   dim)
        return eps_r.to(dtype), eps_d.to(dtype)


def _port_ssn(variables, dtype=torch.float64, f=2):
    net = S.SsnUNet3D(C, initial_filter_size=f, rank=RANK).to(dtype)
    net.load_state_dict({k[len("model."):]: v for k, v in
                         unet3d_params_to_torch(variables).items()})
    return net


# -- the module and the weight bridge -------------------------------------------

def test_ssn_unet3d_and_lowrank_mvn_match_flax_f64():
    """mean, cov_diag, cov_factor and 3 samples given the same normals:
    float64 at atol 1e-10."""
    variables = _jax_members(2, 1)[0]
    x = np.random.RandomState(0).rand(2, P, P, P, 1)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        model = JaxSsnUNet3D(num_classes=C, initial_filter_size=2, rank=RANK,
                             dtype=jnp.float64, param_dtype=jnp.float64)

        def apply(v, xx, k):
            dist = model.apply(v, xx)
            return (dist.mean, dist.cov_diag, dist.cov_factor,
                    dist.rsample(k, (3,)))
        want = [np.asarray(t) for t in jax.jit(apply)(
            jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                   variables), jnp.asarray(x), key)]
        normals = _normals(key, 3, 2, C * P ** 3, jnp.float64)
    got = _port_ssn(variables)(torch.from_numpy(x))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "draw_ssn_normals", _Normals([normals]))
        samples = got.rsample(None, 3)
    for g, w in zip((got.mean, got.cov_diag, got.cov_factor, samples), want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-10, rtol=0)


def test_ssn_weight_round_trip():
    """JAX variables -> a reference state_dict with the synthesized unused
    ``final`` head (C*2 + C*R) -> a strict load into the plain module ->
    back to variables equal to the JAX importer's; the grouped weights
    carry the three heads."""
    variables = _jax_members(2, 1)[0]
    state = unet3d_params_to_torch(variables)
    assert tuple(state["model.final.weight"].shape) == (C * 2 + C * RANK, 2,
                                                        1, 1, 1)
    net = S.SsnUNet3D(C, initial_filter_size=2, rank=RANK)
    net.load_state_dict({k[len("model."):]: v for k, v in state.items()},
                        strict=True)
    got = unet3d_params_from_torch(net.state_dict())
    want = jax_params_from_torch(state)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w)
    grouped = group_member_state_dicts([state, state])
    for name in S.SSN_HEADS:
        assert grouped[name]["kernel"].shape[-1] == 2 * (
            C * RANK if name == "cov_factor_conv" else C)
    assert isinstance(instantiate(make_config({
        "_target_": "values_tpu.models.ssn_unet3d.SsnUNet3D",
        "num_classes": C, "initial_filter_size": 2, "rank": RANK})),
        S.SsnUNet3D)


# -- the port's own draws --------------------------------------------------------

def test_lowrank_mvn_moments():
    """Sample moments match the analytic low-rank covariance
    (tests/test_ssn.py's check, on the port's generator)."""
    rs = np.random.RandomState(0)
    b, n, r = 1, 6, 2
    mean = torch.from_numpy(rs.randn(b, n))
    factor = torch.from_numpy(rs.randn(b, n, r) * 0.5)
    diag = torch.from_numpy(rs.rand(b, n) + 0.3)
    dist = S.LowRankMVN(mean, diag, factor)
    samples = dist.rsample(torch.Generator().manual_seed(0), 20000).numpy()
    np.testing.assert_allclose(samples.mean(0)[0], mean[0].numpy(),
                               atol=0.05)
    want = factor[0].numpy() @ factor[0].numpy().T + np.diag(diag[0].numpy())
    np.testing.assert_allclose(np.cov(samples[:, 0].T), want, atol=0.1)


def test_lowrank_mvn_degenerate_fallback():
    """A capacitance whose Cholesky fails zeroes the factor of that item
    alone: it samples like independent normals (tiny here); the other
    item keeps its factor."""
    mean = torch.zeros(2, 4)
    diag = torch.tensor([[1e-30] * 4, [1.0] * 4])
    factor = torch.full((2, 4, 2), 1e18)
    factor[1] = 0.5
    dist = S.LowRankMVN(mean, diag, factor)
    assert dist.degenerate().tolist() == [True, False]
    samples = dist.rsample(torch.Generator().manual_seed(0), 100)
    assert bool(torch.isfinite(samples).all())
    assert float(samples[:, 0].abs().max()) < 1.0
    assert float(samples[:, 1].std()) > 0.5


# -- the scorer -----------------------------------------------------------------

@pytest.fixture(scope="module")
def scorer_case():
    """SSN members (f 8), inputs and the JAX packed SSN scorer's scores,
    computed once (interpret mode; VALUES_TPU_AGG_LINEAR=0 set before it
    is traced, fault R1)."""
    variables = _jax_members(8)
    rs = np.random.RandomState(1)
    vols = rs.rand(B, P, P, P, 1).astype(np.float32)
    gt = (rs.rand(B, 3, P, P, P) > 0.7).astype(np.int32)
    rng = jax.random.PRNGKey(6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        score, _ = jscoring.make_packed_ssn_scorer(
            C, M, P, n_pred=N_PRED, rank=RANK, agg_patch=AGG,
            dtype=jnp.float32, interpret=True)
        want = np.asarray(jax.jit(score)(group_member_variables(variables),
                                         jnp.asarray(vols), jnp.asarray(gt),
                                         rng))
    weights = group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables])
    return weights, vols, gt, rng, want


def _port_scorer():
    return make_ssn_scorer(C, M, P, n_pred=N_PRED, rank=RANK, agg_patch=AGG,
                           dtype=torch.float32, device="cpu")[0]


def test_ssn_scorer_matches_packed_ssn_scorer(scorer_case, monkeypatch):
    """Members streamed one at a time, sample (m, s) given the JAX
    scorer's normals: atol = rtol = 5e-3, as the other scorer tests."""
    weights, vols, gt, rng, want = scorer_case
    draws = [_normals(jax.random.fold_in(rng, k), 1, B, C * P ** 3,
                      jnp.float32, pad=BP) for k in range(M * N_PRED)]
    normals = _Normals(draws)
    monkeypatch.setattr(S, "draw_ssn_normals", normals)
    got = _port_scorer()(weights, torch.from_numpy(vols),
                         torch.from_numpy(gt), 0)
    assert normals.calls == M * N_PRED and got.shape == (10, B)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


def test_ssn_scorer_seed_and_degenerate_heads(scorer_case):
    """The same seed gives the same scores, another seed others; a
    member whose cov_diag is ~0 with a huge factor (every capacitance
    Cholesky fails) still scores finite values."""
    weights, vols, gt, _, _ = scorer_case
    score = _port_scorer()
    args = (weights, torch.from_numpy(vols[:2]), torch.from_numpy(gt[:2]))
    first = score(*args, 3)
    assert torch.equal(score(*args, 3), first)
    assert not torch.equal(score(*args, 4), first)
    bad = {k: dict(v) for k, v in weights.items()}
    bad["log_cov_diag_conv"]["kernel"] = torch.zeros_like(
        weights["log_cov_diag_conv"]["kernel"])
    bad["log_cov_diag_conv"]["bias"] = torch.full_like(
        weights["log_cov_diag_conv"]["bias"], -80.0)
    bad["cov_factor_conv"]["bias"] = torch.full_like(
        weights["cov_factor_conv"]["bias"], 1e15)
    got = score(bad, *args[1:], 3)
    assert bool(torch.isfinite(got).all())


# -- the engine -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_case():
    """A (16, 32, 16) volume (two windows, one chunk) through the JAX
    engine's ``ssn`` mode at float64, for one member (the single-model
    predictor) and two (the grouped one), computed once."""
    variables = _jax_members(2)
    vol = np.random.RandomState(2).rand(16, 32, 16)
    runs = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for n in (1, 2):
            model = JaxSsnUNet3D(num_classes=C, initial_filter_size=2,
                                 rank=RANK, dtype=jnp.float64)
            engine = JaxEngine(model, variables[:n], mode="ssn",
                               n_pred=N_PRED, patch_size=P, seed=5,
                               dtype=jnp.float64, use_grouped_ensemble=True)
            runs[n] = engine.run_volume(vol)
        sub = jax.random.split(jax.random.PRNGKey(5))[1]
        draws = {n: [_normals(sub, N_PRED, 2 * n, C * P ** 3, jnp.float64)]
                 for n in (1, 2)}
    finally:
        jax.config.update("jax_enable_x64", False)
    return variables, vol, runs, draws


@pytest.mark.parametrize("members_n", [1, 2])
def test_engine_ssn_mode_matches_jax(engine_case, monkeypatch, members_n):
    """Softmax sums (S = M * n_pred, member-major), counts and data sums
    of one volume given the JAX engine's normals: float64 at 1e-10."""
    variables, vol, runs, draws = engine_case
    normals = _Normals(draws[members_n])
    monkeypatch.setattr(S, "draw_ssn_normals", normals)
    engine = SlidingWindowEngine(
        S.SsnUNet3D(C, initial_filter_size=2, rank=RANK),
        variables[:members_n], mode="ssn", n_pred=N_PRED, patch_size=P,
        dtype=torch.float64, device="cpu")
    assert engine.total_samples == members_n * N_PRED
    got = engine.run_volume(vol)
    assert normals.calls == 1
    for name, g, w in zip(("softmax", "counts", "data"), got,
                          runs[members_n]):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-10, rtol=0,
                                   err_msg=name)


def test_engine_ssn_mode_refusals(engine_case):
    """The SSN runs in the ``ssn`` mode and only there."""
    variables = engine_case[0]
    with pytest.raises(ValueError, match="'ssn' mode"):
        SlidingWindowEngine(S.SsnUNet3D(C, initial_filter_size=2),
                            variables[:1], device="cpu")
    with pytest.raises(ValueError, match="'ssn' mode"):
        SlidingWindowEngine(UNet3D(C, initial_filter_size=2), variables[:1],
                            mode="ssn", device="cpu")
