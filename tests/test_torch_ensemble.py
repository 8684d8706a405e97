"""The port's grouped ensemble forward (K1 for every 3x3x3 conv; its
plain version on CPU tensors) against the JAX package's Pallas forward in
interpret mode (float32) and its flax EnsembleUNet3D (float64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.models.ensemble_unet3d import (EnsembleUNet3D,
                                               group_member_variables)
from values_tpu.models.ensemble_unet3d_pallas import grouped_forward_packed
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.ops.pallas.conv3d import pack_ndhwc, unpack_ndhwc
from values_tpu_torch.models.ensemble_unet3d import grouped_forward_fused
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_to_torch)

M, P, B = 2, 16, 8


def _member_variables(f, dtype, aleatoric=False):
    with jax.enable_x64(dtype == jnp.float64):
        model = JaxUNet3D(num_classes=2, initial_filter_size=f,
                          aleatoric_loss=aleatoric, dtype=dtype,
                          param_dtype=dtype)
        return [flax_init(model, m, jnp.zeros((1, P, P, P, 1), dtype),
                          dtype=dtype) for m in range(M)]


def _port_weights(variables, dtype):
    return group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables], dtype)


@pytest.fixture(scope="module")
def pallas_case():
    """Inputs, weights and the JAX Pallas forward's logits (B, P, P, P,
    M, C), computed once: f=8, float32, interpret mode."""
    variables = _member_variables(8, jnp.float32)
    x = np.random.RandomState(0).rand(B, P, P, P, 1).astype(np.float32)
    bp = 128 // P
    grouped = jax.tree_util.tree_map(jnp.asarray,
                                     group_member_variables(variables))
    out = jax.jit(lambda g, xx: grouped_forward_packed(
        g, xx, M, P, interpret=True))(grouped, pack_ndhwc(jnp.asarray(x), bp))
    nb, d, h, m, c, lanes = out.shape
    logits = unpack_ndhwc(out.reshape(nb, d, h, m * c, lanes), bp)
    return variables, x, np.asarray(logits).reshape(B, P, P, P, M, c)


def test_fused_forward_matches_pallas_forward(pallas_case):
    """float32, atol 1e-4: the same fused arithmetic (pool on raw conv
    outputs, deferred norms) with other summation orders over ~18
    layers of O(1) activations."""
    variables, x, want = pallas_case
    got = grouped_forward_fused(_port_weights(variables, torch.float32),
                                torch.from_numpy(x), M)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_member_channel_input_matches_tiled_input(pallas_case):
    """A (B, ..., 1) input is tiled across the members' channel groups."""
    variables, x, _ = pallas_case
    weights = _port_weights(variables, torch.float32)
    x = torch.from_numpy(x[:2])
    tiled = grouped_forward_fused(weights, x.expand(-1, -1, -1, -1, M), M)
    assert torch.equal(grouped_forward_fused(weights, x, M), tiled)


@pytest.mark.parametrize("case", ["logits", "aleatoric", "non_cubic"])
def test_fused_forward_matches_flax_ensemble_f64(case):
    """float64, atol 1e-9: the fused identities are exact in real
    arithmetic, so only rounding separates the two forwards. The
    non-cubic case checks that each level's norm counts its own voxels."""
    aleatoric = case == "aleatoric"
    shape = (16, 32, 48) if case == "non_cubic" else (P, P, P)
    variables = _member_variables(4, jnp.float64, aleatoric)
    x = np.random.RandomState(1).rand(2, *shape, 1)
    with jax.enable_x64(True):
        model = EnsembleUNet3D(num_classes=2, members=M,
                               initial_filter_size=4, aleatoric=aleatoric,
                               dtype=jnp.float64, param_dtype=jnp.float64)
        want = np.asarray(jax.jit(model.apply)(
            group_member_variables(variables, np.float64), jnp.asarray(x)))
    got = grouped_forward_fused(_port_weights(variables, torch.float64),
                                torch.from_numpy(x), M)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
