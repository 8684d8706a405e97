"""K2 of the port (values_tpu_torch.ops.kernels.entropy): the plain
version against the Pallas kernel it replaces (interpret mode) and the
JAX package's XLA statistics; the Triton kernel against the plain version
where a card is present."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from values_tpu.ops.pallas.entropy import fused_entropy_pallas
from values_tpu.ops.uncertainty import fused_sample_statistics
from values_tpu_torch.ops.kernels.entropy import (fused_entropy,
                                                  fused_entropy_reference)

S, C, N = 5, 2, 2048
KEYS = ("mean_softmax", "pred_entropy", "expected_entropy",
        "mutual_information")


def _stack(seed=0):
    """(S, C, N) float32 softmax stack; a quarter of the voxels are
    one-hot, so exact zeros exercise the 0*log(0) guard."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(S, C, N) * 3
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    hard = rs.rand(N) < 0.25
    p[:, :, hard] = 0.0
    p[:, 0, hard] = 1.0
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs():
    stack = jnp.asarray(_stack())
    pallas = fused_entropy_pallas(stack, tile_n=1024, interpret=True)
    xla = fused_sample_statistics(stack, class_axis=1)
    return ({k: np.asarray(v) for k, v in pallas.items()},
            {k: np.asarray(v) for k, v in xla.items()})


@pytest.mark.parametrize("which", [0, 1], ids=["pallas", "xla"])
def test_plain_matches_jax(jax_outputs, which):
    """f32, atol 1e-6: the same float32 sums of at most S*C terms."""
    stack = _stack()
    assert (stack == 0).any()
    got = fused_entropy(torch.from_numpy(stack))
    for key in KEYS:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(),
                                   jax_outputs[which][key], atol=1e-6,
                                   err_msg=key)


def test_plain_takes_a_channels_last_view():
    """The scorer hands over an (S, C, N) view of an (N, S, C) tensor;
    the reductions may add in another order (atol 1e-6, as above)."""
    stack = torch.from_numpy(_stack())
    view = stack.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert not view.is_contiguous()
    want = fused_entropy(stack)
    got = fused_entropy(view)
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=1e-6, err_msg=key)


def test_cpu_tensors_take_the_plain_version():
    before = fused_entropy.launches
    stack = torch.from_numpy(_stack(1))
    got = fused_entropy(stack)
    want = fused_entropy_reference(stack)
    assert fused_entropy.launches == before
    for key in KEYS:
        assert torch.equal(got[key], want[key])


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """atol 1e-5: the kernel's float32 log and PyTorch's differ in the
    last ulps, and each map adds S*C terms of magnitude <= 1/e."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stack = torch.from_numpy(_stack()).cuda()
    before = fused_entropy.launches
    got = fused_entropy(stack)
    assert fused_entropy.launches == before + 1
    want = fused_entropy_reference(stack)
    for key in KEYS:
        np.testing.assert_allclose(got[key].cpu().numpy(),
                                   want[key].cpu().numpy(), atol=1e-5,
                                   err_msg=key)
    with pytest.raises(TypeError):
        fused_entropy(stack.double())
