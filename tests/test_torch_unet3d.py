"""The port's per-member UNet3D and weight bridge against the JAX
package: float64 forwards at atol 1e-10 (PARITY.md's UNet3D tolerance),
reference key names, and the grouped weight layouts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.models.ensemble_unet3d import group_member_variables
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  strip_model_prefix,
                                                  unet3d_params_to_torch)
from values_tpu_torch.models.unet3d import UNet3D

P, F = 16, 4
VARIANTS = {"plain": {}, "no_instancenorm": {"do_instancenorm": False},
            "aleatoric": {"aleatoric_loss": True}}


def flax_init(model, seed, *inputs, dtype=np.float32):
    """Variables of ``model.init(key, *inputs)``, its tree and shapes, drawn
    in numpy as flax's default initializers draw them: every kernel normal
    with std 1/sqrt(fan in), biases and BatchNorm means 0, norm scales and
    BatchNorm variances 1. ``jax.eval_shape`` traces ``init`` and compiles
    nothing, where a jitted init of one of these models is an XLA program
    of 5-25 s on the CPU; the port's tests compare the two packages on
    the same weights, so what draws them is theirs to choose. The golden
    runs, which need flax's own draw, keep ``model.init``."""
    with jax.enable_x64(np.dtype(dtype) == np.float64):
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, *inputs))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rs.randn(*leaf.shape) / np.sqrt(fan_in)).astype(dtype)
        return np.full(leaf.shape, 1.0 if name in ("scale", "var") else 0.0,
                       dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_variables(kwargs, seed=0):
    """flax UNet3D variables in float64, as nested dicts of numpy."""
    model = JaxUNet3D(num_classes=2, initial_filter_size=F,
                      dtype=jnp.float64, param_dtype=jnp.float64, **kwargs)
    return model, flax_init(model, seed, jnp.zeros((1, P, P, P, 1)),
                            dtype=np.float64)


def _port_model(kwargs, variables):
    net = UNet3D(2, initial_filter_size=F, **kwargs).double().eval()
    net.load_state_dict(strip_model_prefix(unet3d_params_to_torch(variables)),
                        strict=True)
    return net


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax_f64(rng, variant):
    kwargs = VARIANTS[variant]
    model, variables = _jax_variables(kwargs)
    x = rng.randn(2, P, P, P, 1)
    with jax.enable_x64(True):
        want = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(kwargs, variables)(torch.from_numpy(x))
    if kwargs.get("aleatoric_loss"):
        assert len(got) == len(want) == 2
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10)


@pytest.mark.parametrize("aleatoric", [False, True])
def test_bridge_keys_load_strictly(aleatoric):
    """The bridge emits the reference's ``model.``-prefixed key names,
    including the heads the reference builds but flax never creates."""
    _, variables = _jax_variables({"aleatoric_loss": aleatoric})
    state = unet3d_params_to_torch(variables)
    assert all(k.startswith("model.") for k in state)
    net = UNet3D(2, initial_filter_size=F, aleatoric_loss=aleatoric)
    assert set(strip_model_prefix(state)) == set(net.state_dict())
    net.load_state_dict(strip_model_prefix(state), strict=True)
    assert strip_model_prefix({"a.b": 1, "model.c": 2}) == {"a.b": 1,
                                                             "c": 2}


def test_grouped_weights_match_jax_layout():
    """group_member_state_dicts holds the JAX grouped tree's tensors:
    3x3x3 and 1x1x1 kernels stacked on the output channels, the k2s2
    transposed convs on a leading member axis."""
    variables = [_jax_variables({}, seed)[1] for seed in (0, 1, 2)]
    grouped = group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables], torch.float64)
    want = group_member_variables(variables, np.float64)["params"]
    assert set(grouped) == set(want)
    for name, leaves in want.items():
        leaves = leaves.get("conv", leaves)
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(grouped[name][leaf].numpy(),
                                          leaves[leaf], err_msg=name)
