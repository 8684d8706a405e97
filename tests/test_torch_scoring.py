"""The port's headline scorer against the JAX package's packed scorer
(interpret mode), per-map C3 aggregation on both sides."""
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
from values_tpu_torch.inference.scoring import make_scorer
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_to_torch)

M, P, B, RATERS, AGG = 2, 16, 8, 3, 4


@pytest.fixture(scope="module")
def case():
    """Weights, inputs and the JAX scores for a single and a 3-rater gt,
    computed once. VALUES_TPU_AGG_LINEAR=0 is set before the JAX scorer
    is built and traced: the variable is read at trace time (fault R1),
    and the port aggregates each map on its own."""
    base = JaxUNet3D(num_classes=2, initial_filter_size=8)
    variables = [flax_init(base, m, jnp.zeros((1, P, P, P, 1)))
                 for m in range(M)]
    rs = np.random.RandomState(0)
    vols = rs.rand(B, P, P, P, 1).astype(np.float32)
    gts = {"single": (rs.rand(B, P, P, P) > 0.7).astype(np.int32),
           "raters": (rs.rand(B, RATERS, P, P, P) > 0.7).astype(np.int32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        score, rows = jscoring.make_packed_scorer(
            M, P, agg_patch=AGG, dtype=jnp.float32, interpret=True)
        stacked = group_member_variables(variables)
        want = {k: np.asarray(jax.jit(score)(stacked, jnp.asarray(vols),
                                             jnp.asarray(g), None))
                for k, g in gts.items()}
    weights = group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables])
    return weights, vols, gts, want, rows


def _port_scorer():
    return make_scorer(M, P, agg_patch=AGG, dtype=torch.float32,
                       device="cpu")


@pytest.mark.parametrize("gt_kind", ["single", "raters"])
def test_scorer_matches_packed_scorer(case, gt_kind):
    """atol = rtol = 5e-3, as tests/test_scoring.py holds the JAX scorer
    to its unpacked composition. The largest error seen here is 4.9e-4
    absolute, 2.1e-6 relative, on the image-level sums of 16^3
    entropies; every other row is within 2e-5."""
    weights, vols, gts, want, rows = case
    score, port_rows = _port_scorer()
    assert port_rows == rows == jscoring.score_rows()
    got = score(weights, torch.from_numpy(vols), torch.from_numpy(gts[gt_kind]))
    assert got.shape == (10, B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[gt_kind], atol=5e-3,
                               rtol=5e-3)


def test_batch_of_five(case):
    """B is not tied to 128 // patch: five volumes score as the first
    five of the batch of eight (each volume's path is independent)."""
    weights, vols, gts, want, _ = case
    score, _ = _port_scorer()
    got = score(weights, torch.from_numpy(vols[:5, ..., 0]),
                torch.from_numpy(gts["single"][:5]))
    assert got.shape == (10, 5)
    np.testing.assert_allclose(got.numpy(), want["single"][:, :5],
                               atol=5e-3, rtol=5e-3)
    full = score(weights, torch.from_numpy(vols),
                 torch.from_numpy(gts["single"]))
    np.testing.assert_allclose(got.numpy(), full[:, :5].numpy(), atol=1e-5,
                               rtol=1e-5)


def test_per_key_thresholds(case):
    """A (PE, EE, MI) triple sets each map's threshold; the other rows
    do not move."""
    weights, vols, gts, _, rows = case
    args = (weights, torch.from_numpy(vols[:2]),
            torch.from_numpy(gts["single"][:2]))
    base = make_scorer(M, P, agg_patch=AGG, threshold=0.3,
                       dtype=torch.float32, device="cpu")[0](*args)
    triple = make_scorer(M, P, agg_patch=AGG, threshold=(0.3, 0.3, 0.01),
                         dtype=torch.float32, device="cpu")[0](*args)
    moved = [r for i, r in enumerate(rows)
             if not torch.equal(base[i], triple[i])]
    assert moved == ["mutual_information/threshold"]


def test_scorer_rejects_bad_shapes():
    with pytest.raises(ValueError):
        make_scorer(M, 24, device="cpu")
    score, _ = make_scorer(M, P, agg_patch=AGG, device="cpu")
    with pytest.raises(ValueError):
        score({}, torch.zeros(1, P, P, 8), torch.zeros(1, P, P, 8))
    with pytest.raises(ValueError):
        score({}, torch.zeros(2, P, P, P), torch.zeros(1, P, P, P))
