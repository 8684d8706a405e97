"""The port's TTA scorer on a dropout model (dropout live in each of the
16 variants, as the reference never switches to eval mode) against the
JAX package's ``make_packed_tta_scorer(do_dropout=True)``, given the same
noise and masks.

The JAX scorer splits its rng in three: the variance and the noise
(``uniform(k0, (), 0, 0.1)``, ``normal(k1, padded_shape)``) and variant
v's 17 dropout masks, ``bernoulli(split(fold_in(k2, v), 17)[k], 0.5,
packed_shape_k)`` (``scoring.py:349-363``,
``ensemble_unet3d_pallas.py:172-175``). The test records the packed
shapes as the JAX scorer traces, draws the same bits, unpacks them to
NDHWC and replays noise and masks through the port's draw functions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
import values_tpu.models.ensemble_unet3d_pallas as jpallas
from values_tpu.inference import scoring as jscoring
from values_tpu.models.ensemble_unet3d import group_member_variables
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.ops.pallas.conv3d import unpack_ndhwc
from values_tpu_torch.inference.scoring import make_tta_scorer
from values_tpu_torch.models import ensemble_unet3d as E
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_to_torch)

M, P, B, BP, AGG = 2, 16, 4, 8, 4


@pytest.fixture(scope="module")
def case():
    """Members (f 4), inputs, the JAX scorer's scores and the 17 sites'
    packed shapes, computed once (interpret mode; VALUES_TPU_AGG_LINEAR=0
    set before tracing, fault R1)."""
    model = JaxUNet3D(num_classes=2, initial_filter_size=4)
    variables = [flax_init(model, 80 + m, jnp.zeros((1, P, P, P, 1)))
                 for m in range(M)]
    rs = np.random.RandomState(5)
    vols = rs.rand(B, P, P, P, 1).astype(np.float32)
    gt = (rs.rand(B, 3, P, P, P) > 0.7).astype(np.int32)
    rng = jax.random.PRNGKey(22)
    shapes = []
    orig = jpallas._dropout

    def recording(x, key, rate=0.5):
        shapes.append(tuple(x.shape))
        return orig(x, key, rate)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        # the 16 variants share one trace of the grouped forward
        mp.setattr(jscoring, "grouped_forward_packed",
                   jax.jit(jscoring.grouped_forward_packed,
                           static_argnums=(2, 3),
                           static_argnames=("do_dropout", "apply_final",
                                            "interpret", "trainable")))
        mp.setattr(jpallas, "_dropout", recording)
        score, _ = jscoring.make_packed_tta_scorer(
            M, P, do_dropout=True, agg_patch=AGG, dtype=jnp.float32,
            interpret=True)
        want = np.asarray(score(
            group_member_variables(variables), jnp.asarray(vols),
            jnp.asarray(gt), rng))
    assert len(shapes) == 17   # one trace of the jitted forward
    weights = group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables])
    return weights, vols, gt, rng, want, shapes


def test_tta_scorer_with_live_dropout_matches_packed_tta_scorer(
        case, monkeypatch):
    """Each variant draws its own 17 masks after the one noise draw:
    atol = rtol = 5e-3, as the other scorer tests."""
    weights, vols, gt, rng, want, shapes = case
    var_key, noise_key, drop_key = jax.random.split(rng, 3)
    variance = float(jax.random.uniform(var_key, (), jnp.float32, 0.0, 0.1))
    noise = torch.from_numpy(np.array(jax.random.normal(
        noise_key, (BP, P, P, P, 1), jnp.float32))[:B])
    monkeypatch.setattr(E, "draw_tta_noise", lambda g, shape, dtype, dev: (
        torch.tensor(variance, dtype=dtype), noise.to(dtype)))
    masks = iter([[torch.from_numpy(np.array(unpack_ndhwc(
        jax.random.bernoulli(k, 0.5, s), BP // s[0]))[:B])
        for k, s in zip(jax.random.split(jax.random.fold_in(drop_key, v),
                                         17), shapes)]
        for v in range(16)])
    monkeypatch.setattr(E, "draw_dropout_masks",
                        lambda shapes, generator, device: next(masks))
    score, _ = make_tta_scorer(M, P, do_dropout=True, agg_patch=AGG,
                               dtype=torch.float32, device="cpu")
    got = score(weights, torch.from_numpy(vols), torch.from_numpy(gt), 0)
    assert next(masks, None) is None and got.shape == (10, B)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)
