"""The port's aleatoric ensemble scorer (K1 forward + K3 draws) against
the JAX package's packed aleatoric scorer with the Pallas sampler in
interpret mode, drawing the same counter bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.inference import scoring as jscoring
from values_tpu.models.ensemble_unet3d import group_member_variables
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu_torch.inference.scoring import (make_aleatoric_scorer,
                                                score_rows)
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_to_torch)

M, P, B, RATERS, AGG, NS = 2, 16, 8, 3, 4, 2
MI_ROWS = [i for i, r in enumerate(score_rows())
           if r.startswith("mutual_information")]


@pytest.fixture(scope="module")
def case():
    """Aleatoric member weights, inputs, the seed the JAX scorer draws,
    and its scores for a single and a 3-rater gt, computed once.
    VALUES_TPU_AGG_LINEAR=0 is set before the JAX scorer is built and
    traced (fault R1)."""
    base = JaxUNet3D(num_classes=2, initial_filter_size=8,
                     aleatoric_loss=True)
    variables = [flax_init(base, 10 + m, jnp.zeros((1, P, P, P, 1)))
                 for m in range(M)]
    rs = np.random.RandomState(0)
    vols = rs.rand(B, P, P, P, 1).astype(np.float32)
    gts = {"single": (rs.rand(B, P, P, P) > 0.7).astype(np.int32),
           "raters": (rs.rand(B, RATERS, P, P, P) > 0.7).astype(np.int32)}
    rng = jax.random.PRNGKey(5)
    # the int seed the JAX scorer draws from rng (scoring.py:266-267)
    seed = int(jax.random.randint(rng, (), 0, jnp.iinfo(jnp.int32).max,
                                  jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        score, rows = jscoring.make_packed_aleatoric_scorer(
            M, P, n_aleatoric_samples=NS, agg_patch=AGG, dtype=jnp.float32,
            sampler="pallas", interpret=True)
        stacked = group_member_variables(variables)
        want = {k: np.asarray(jax.jit(score)(stacked, jnp.asarray(vols),
                                             jnp.asarray(g), rng))
                for k, g in gts.items()}
    weights = group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables])
    return weights, vols, gts, seed, want, rows


@pytest.mark.parametrize("gt_kind", ["single", "raters"])
def test_aleatoric_scorer_matches_packed_pallas_scorer(case, gt_kind):
    """Counter bits with the JAX kernel's D-block at patch 16
    (counter_rows=16): the same draws on both sides. atol = rtol = 5e-3,
    as tests/test_torch_scoring.py; the largest error seen is 4.9e-4
    absolute, 2.9e-6 relative, on the image-level EE sum of 16^3
    voxels."""
    weights, vols, gts, seed, want, rows = case
    score, port_rows = make_aleatoric_scorer(
        M, P, n_aleatoric_samples=NS, agg_patch=AGG, dtype=torch.float32,
        bits="counter", counter_rows=16, device="cpu")
    assert port_rows == rows
    got = score(weights, torch.from_numpy(vols),
                torch.from_numpy(gts[gt_kind]), seed)
    assert got.shape == (10, B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[gt_kind], atol=5e-3,
                               rtol=5e-3)


def test_philox_batch_of_five(case):
    """Any B in Philox mode: finite scores, Dice in [0, 1], MI rows
    >= -1e-4 (MI >= 0 per voxel up to rounding, by Jensen), and the same
    seed gives the same scores."""
    weights, vols, gts, seed, _, _ = case
    score, _ = make_aleatoric_scorer(M, P, n_aleatoric_samples=NS,
                                     agg_patch=AGG, dtype=torch.float32,
                                     device="cpu")
    args = (weights, torch.from_numpy(vols[:5, ..., 0]),
            torch.from_numpy(gts["single"][:5]), 1234)
    got = score(*args)
    assert got.shape == (10, 5) and bool(torch.isfinite(got).all())
    assert bool(((got[0] >= 0) & (got[0] <= 1)).all())
    assert float(got[MI_ROWS].min()) >= -1e-4
    assert torch.equal(score(*args), got)
    assert not torch.equal(score(*args[:3], 1235), got)


def test_aleatoric_scorer_refusals(case):
    weights, vols, gts, _, _, _ = case
    with pytest.raises(ValueError):
        make_aleatoric_scorer(M, 48, bits="counter", device="cpu")
    with pytest.raises(ValueError):
        make_aleatoric_scorer(M, P, bits="hw", device="cpu")
    score, _ = make_aleatoric_scorer(M, P, agg_patch=AGG, device="cpu")
    plain = {k: v for k, v in weights.items() if k != "final_aleatoric"}
    with pytest.raises(ValueError, match="final_aleatoric"):
        score(plain, torch.from_numpy(vols[:1]),
              torch.from_numpy(gts["single"][:1]), 0)
