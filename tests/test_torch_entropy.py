"""K2 of the port (values_tpu_torch.ops.kernels.entropy): the plain
version, in both forms, against the Pallas kernel it replaces (interpret
mode) and the JAX package's XLA statistics; the CUDA kernel against the
plain version where a card is present."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
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


def _logits(seed=2):
    """(S, C, N) float32 logits; a quarter of the voxels far from 0, so
    their softmax is nearly one-hot."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(S, C, N) * 3
    hard = rs.rand(N) < 0.25
    logits[:, 0, hard] += 40.0
    return logits.astype(np.float32)


def _layout(t, layout):
    """An (S, C, N) tensor with the same values in another memory layout:
    ``voxel-major`` (N, S, C) in memory, ``sample-major`` (S, N, C), as
    the forward's grouped head leaves its logits."""
    if layout == "voxel-major":
        return t.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    if layout == "sample-major":
        return t.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    return t


@pytest.mark.parametrize("layout",
                         ["contiguous", "voxel-major", "sample-major"])
def test_plain_logits_form_matches_jax(layout):
    """The logits form against ``fused_entropy_pallas`` (interpret mode)
    on ``jax.nn.softmax`` of the same logits over C, f32 atol 1e-6 (the
    file's tolerance); the sample-major view is how the scorer hands
    over its logits."""
    logits = _logits()
    want = fused_entropy_pallas(jax.nn.softmax(jnp.asarray(logits), axis=1),
                                tile_n=1024, interpret=True)
    got = fused_entropy(_layout(torch.from_numpy(logits), layout),
                        logits=True)
    for key in KEYS:
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, err_msg=key)


def test_plain_logits_form_takes_bf16_as_its_upcast():
    """bfloat16 logits give exactly the statistics of their float32
    upcast, in float32."""
    t = torch.from_numpy(_logits(3)).to(torch.bfloat16)
    got = fused_entropy(t, logits=True)
    want = fused_entropy(t.float(), logits=True)
    for key in KEYS:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key])


@pytest.mark.parametrize("layout,dtype,n,expect", [
    ("sample-major", torch.float32, N, N * C),
    ("sample-major", torch.bfloat16, N, N * C),
    ("sample-major", torch.bfloat16, 1001, 0),    # rows not 16-byte aligned
    ("voxel-major", torch.float32, N, 0),
    ("contiguous", torch.float32, N, 0),
])
def test_kernel_reads_only_aligned_sample_major_stacks(layout, dtype, n,
                                                       expect):
    """The stride the kernel is handed: a sample-major view as it is,
    every other layout 0 (the wrapper copies it first, into rows of N*C
    rounded up to 16 bytes)."""
    from values_tpu_torch.ops.kernels.entropy import (_aligned_stride,
                                                      _sample_stride)
    t = _layout(torch.zeros((S, C, n), dtype=dtype), layout)
    assert _sample_stride(t) == expect
    per_chunk = 16 // t.element_size()
    assert _aligned_stride(t) == -(-n * C // per_chunk) * per_chunk


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
    """atol 1e-5: the kernel's float32 transcendentals and PyTorch's
    differ in the last ulps, and each map adds S*C terms of magnitude
    <= 1/e. Both forms; contiguous, voxel-major and sample-major (the
    kernel's own layout, which the others are copied into); float32 and
    bfloat16 logits; a ragged N whose rows are padded in the copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stack = torch.from_numpy(_stack()).cuda()
    logits = torch.from_numpy(_logits()).cuda()
    cases = [(stack, False), (_layout(stack, "voxel-major"), False),
             (_layout(stack, "sample-major"), False),
             (logits, True), (logits.to(torch.bfloat16), True),
             (_layout(logits, "voxel-major"), True),
             (_layout(logits, "sample-major").to(torch.bfloat16), True),
             (logits[..., :1001].to(torch.bfloat16), True)]
    for x, is_logits in cases:
        before = fused_entropy.launches
        got = fused_entropy(x, logits=is_logits)
        assert fused_entropy.launches == before + 1
        want = fused_entropy_reference(x, logits=is_logits)
        for key in KEYS:
            np.testing.assert_allclose(got[key].cpu().numpy(),
                                       want[key].cpu().numpy(), atol=1e-5,
                                       err_msg=key)
    with pytest.raises(TypeError):
        fused_entropy(stack.double())
