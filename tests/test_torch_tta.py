"""The port's test-time augmentation (the TTA scorer and the engine's
``tta`` mode) against the JAX package's, given the same draws, and the
port's own noise draw checked statistically.

The JAX side's draws are replayed through the port's draw functions
(``values_tpu_torch.models.ensemble_unet3d.draw_tta_noise``): the packed
scorer splits its rng in three (variance ``uniform(k0, (), 0, 0.1)``,
noise ``normal(k1, padded_shape)``, variant v's dropout masks from
``fold_in(k2, v)``; ``scoring.py:349-363``); the engine's grouped TTA
predictor splits each window chunk's key in two
(``ensemble_unet3d.py:409-413``)."""
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
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu_torch.inference.engine import SlidingWindowEngine
from values_tpu_torch.inference.scoring import make_tta_scorer
from values_tpu_torch.models import ensemble_unet3d as E
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_to_torch)
from values_tpu_torch.models.unet3d import UNet3D

M, P, B, BP, AGG = 2, 16, 4, 8, 4


def _members(f, n=M, seed=8):
    model = JaxUNet3D(num_classes=2, initial_filter_size=f)
    return [flax_init(model, 10 * seed + m, jnp.zeros((1, P, P, P, 1)))
            for m in range(n)]


class _Noise:
    """A stand-in for ``draw_tta_noise``: call i gets ``draws[i]``."""

    def __init__(self, draws):
        self.draws, self.calls = draws, 0

    def __call__(self, generator, shape, dtype, device):
        variance, noise = self.draws[self.calls]
        self.calls += 1
        assert tuple(noise.shape) == tuple(shape)
        return variance.to(dtype), noise.to(dtype)


def _noise(var_key, noise_key, shape, dtype, b=None):
    variance = jax.random.uniform(var_key, (), dtype, 0.0, 0.1)
    noise = np.array(jax.random.normal(noise_key, shape, dtype))
    return (torch.tensor(float(variance), dtype=torch.float64),
            torch.from_numpy(noise[:b] if b else noise))


# -- the scorer -----------------------------------------------------------------

@pytest.fixture(scope="module")
def scorer_case():
    """Members (f 4), inputs, and the JAX packed TTA scorer's scores,
    computed once (interpret mode; VALUES_TPU_AGG_LINEAR=0 set before
    tracing, fault R1). Live dropout is held in
    tests/test_torch_tta_dropout.py."""
    variables = _members(4)
    rs = np.random.RandomState(3)
    vols = rs.rand(B, P, P, P, 1).astype(np.float32)
    gt = (rs.rand(B, 3, P, P, P) > 0.7).astype(np.int32)
    rng = jax.random.PRNGKey(21)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        # the 16 variants share one trace of the grouped forward
        mp.setattr(jscoring, "grouped_forward_packed",
                   jax.jit(jscoring.grouped_forward_packed,
                           static_argnums=(2, 3),
                           static_argnames=("do_dropout", "apply_final",
                                            "interpret", "trainable")))
        score, _ = jscoring.make_packed_tta_scorer(
            M, P, agg_patch=AGG, dtype=jnp.float32, interpret=True)
        want = np.asarray(score(
            group_member_variables(variables), jnp.asarray(vols),
            jnp.asarray(gt), rng))
    weights = group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables])
    return weights, vols, gt, rng, want


def test_tta_scorer_matches_packed_tta_scorer(scorer_case, monkeypatch):
    """The 16 variants in the reference order, un-flipped, each member's
    softmax streamed in, given the JAX scorer's variance and noise (drawn
    over its padded batch): atol = rtol = 5e-3, as the other scorer
    tests."""
    weights, vols, gt, rng, want = scorer_case
    var_key, noise_key, _ = jax.random.split(rng, 3)
    noise = _Noise([_noise(var_key, noise_key, (BP, P, P, P, 1),
                           jnp.float32, B)])
    monkeypatch.setattr(E, "draw_tta_noise", noise)
    score, _ = make_tta_scorer(M, P, agg_patch=AGG, dtype=torch.float32,
                               device="cpu")
    got = score(weights, torch.from_numpy(vols), torch.from_numpy(gt), 0)
    assert noise.calls == 1 and got.shape == (10, B)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


def test_tta_scorer_seed(scorer_case):
    weights, vols, gt, _, _ = scorer_case
    score, _ = make_tta_scorer(M, P, agg_patch=AGG, dtype=torch.float32,
                               device="cpu")
    args = (weights, torch.from_numpy(vols[:2]), torch.from_numpy(gt[:2]))
    first = score(*args, 1)
    assert bool(torch.isfinite(first).all())
    assert torch.equal(score(*args, 1), first)
    assert not torch.equal(score(*args, 2), first)


def test_tta_noise_draw():
    """The port's own draws: the noise scale lies in [0, 0.1) and is
    uniform there (mean 0.05 within 4 sigma over 400 draws); the field is
    a standard normal (mean and variance within 4 sigma)."""
    scales = []
    for seed in range(400):
        variance, noise = E.draw_tta_noise(
            torch.Generator().manual_seed(seed), (2, 8, 8, 8, 1),
            torch.float32, "cpu")
        assert variance.shape == () and 0.0 <= float(variance) < 0.1
        scales.append(float(variance))
    assert abs(np.mean(scales) - 0.05) < 4 * 0.1 / np.sqrt(12 * 400)
    n = noise.numel()
    assert abs(float(noise.mean())) < 4 / np.sqrt(n)
    assert abs(float(noise.var()) - 1.0) < 4 * np.sqrt(2 / n)


def test_tta_inputs_order():
    """[clean, clean flips..., noisy, noisy flips...], the flips in
    FLIP_COMBOS order over the NDHWC spatial axes."""
    x = torch.arange(2 * 4 * 4 * 4, dtype=torch.float64).reshape(
        2, 4, 4, 4, 1)
    variants = list(E.tta_inputs(x, torch.Generator().manual_seed(0)))
    assert [axes for _, axes in variants] == 2 * ([()] + list(E.FLIP_COMBOS))
    for xv, axes in variants[:8]:
        assert torch.equal(torch.flip(xv, axes) if axes else xv, x)
    noisy = variants[8][0]
    assert not torch.equal(noisy, x)
    for xv, axes in variants[8:]:
        assert torch.equal(torch.flip(xv, axes) if axes else xv, noisy)


# -- the engine -----------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_case():
    """A (16, 32, 16) volume (two windows, one chunk) through the JAX
    engine's ``tta`` mode (its grouped predictor, 16 * M groups) at
    float64, for two members and one, computed once."""
    variables = _members(2, seed=9)
    vol = np.random.RandomState(4).rand(16, 32, 16)
    runs = {}
    jax.config.update("jax_enable_x64", True)
    try:
        for n in (2, 1):
            engine = JaxEngine(JaxUNet3D(num_classes=2, initial_filter_size=2),
                               variables[:n], mode="tta", patch_size=P,
                               seed=7, dtype=jnp.float64,
                               use_grouped_ensemble=True)
            runs[n] = engine.run_volume(vol)
        sub = jax.random.split(jax.random.PRNGKey(7))[1]
        draw = _noise(*jax.random.split(sub), (2, P, P, P, 1), jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return variables, vol, runs, draw


@pytest.mark.parametrize("members_n", [2, 1])
def test_engine_tta_mode_matches_jax(engine_case, monkeypatch, members_n):
    """Softmax sums (S = 16 M, member-major), counts and data sums of one
    volume given the JAX engine's noise: float64 at 1e-10."""
    variables, vol, runs, draw = engine_case
    noise = _Noise([draw])
    monkeypatch.setattr(E, "draw_tta_noise", noise)
    engine = SlidingWindowEngine(UNet3D(2, initial_filter_size=2),
                                 variables[:members_n], mode="tta",
                                 patch_size=P, dtype=torch.float64,
                                 device="cpu")
    assert engine.total_samples == 16 * members_n
    got = engine.run_volume(vol)
    assert noise.calls == 1
    for name, g, w in zip(("softmax", "counts", "data"), got,
                          runs[members_n]):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-10, rtol=0,
                                   err_msg=name)
