"""K2's streaming regime and K3's shared-memory regime: the shapes the
tiled and register kernels refuse (K2: more than 16 classes, or more than
454 bytes of samples a voxel; K3: more than 8 classes). The plain
versions against the JAX package's Pallas kernels in interpret mode at
the class counts those kernels are not held to elsewhere, and against
float64 where only the card's regime differs; the regime functions
against the old refusal, and the CUDA kernels against their plain
versions where a card is present."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.ops.pallas import sampling as jsampling
from values_tpu.ops.pallas.conv3d import pack_ndhwc, unpack_ndhwc
from values_tpu.ops.pallas.entropy import fused_entropy_pallas
from values_tpu_torch.ops.kernels import entropy, sampling

KEYS = ("mean_softmax", "pred_entropy", "expected_entropy",
        "mutual_information")
N2 = 1024


def _stack(s, c, seed):
    """(S, C, N2) float32 softmax stack, exact zeros at a quarter of the
    voxels (one-hot there)."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(s, c, N2) * 3
    p = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    hard = rs.rand(N2) < 0.25
    p[:, :, hard] = 0.0
    p[:, 0, hard] = 1.0
    return p.astype(np.float32)


def _stats64(x, logits=False):
    """K2's four statistics of an (S, C, N) stack (softmax probabilities,
    or logits), spelled out in float64, with 0 log 0 = 0."""
    def plogp(q):
        return np.where(q > 0, q * np.log(np.where(q > 0, q, 1.0)), 0.0)
    p = x.astype(np.float64)
    if logits:
        p = np.exp(p - p.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
    mean = p.mean(axis=0)
    pe = -plogp(mean).sum(axis=0)
    ee = -plogp(p).sum(axis=1).mean(axis=0)
    return {"mean_softmax": mean, "pred_entropy": pe,
            "expected_entropy": ee, "mutual_information": pe - ee}


def _pallas(x, logits=False):
    x = jnp.asarray(x)
    return fused_entropy_pallas(jax.nn.softmax(x, axis=1) if logits else x,
                                tile_n=N2, interpret=True)


# (5, 24): more classes than the tiled kernel takes, which the Pallas
# kernel in interpret mode is held to; (80, 2): the scorer's two classes,
# whose sample count moves only the card's choice of regime, held against
# the statistics spelled out in float64 (tests/test_torch_entropy.py holds
# two classes against the Pallas kernel).
REFERENCES = {(5, 24): _pallas, (80, 2): _stats64}


@pytest.mark.parametrize("s,c", list(REFERENCES))
def test_k2_plain_matches_pallas_at_stream_shapes(s, c):
    """The probability form and the logits form (on the same stack's
    logs) against the shape's reference, f32 atol 1e-6
    (test_torch_entropy.py's tolerance: float32 sums of S*C terms in
    another order)."""
    assert entropy.plan(s, c, torch.float32) == "stream"
    reference = REFERENCES[s, c]
    stack = _stack(s, c, seed=s + c)
    logits = np.random.RandomState(c).randn(s, c, N2).astype(np.float32) * 3
    for x, form in ((stack, False), (logits, True)):
        want = reference(x, logits=form)
        got = entropy.fused_entropy(torch.from_numpy(x), logits=form)
        for key in KEYS:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=1e-6,
                                       err_msg=f"{key}, logits={form}")


def test_k2_plan_streams_exactly_what_the_tile_refused():
    """``plan`` picks "stream" on exactly the shapes the tiled kernel's
    wrapper raised on before the streaming regime: C > 16, or two tiles
    of 256 voxels' S*C values over 232,448 bytes."""
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        for s in (1, 2, 5, 10, 50, 80, 113, 114, 227, 228, 400):
            for c in (1, 2, 3, 8, 15, 16, 17, 24, 64):
                refused = not (c <= 16 and
                               2 * 256 * s * c * size <= 232448)
                assert (entropy.plan(s, c, dtype) == "stream") == refused, \
                    (s, c, dtype)
    assert entropy.plan(5, 2, torch.bfloat16) == "tile"   # the scorer's
    with pytest.raises(ValueError):
        entropy.plan(0, 2, torch.float32)


# K3 at 12 classes: W=16 packs 8 items per lane row, B=8 is one pack
B, D, H, W, M, C3, NS, SD, SEED = 8, 4, 4, 16, 2, 12, 3, 2, 7


def _pack(x):
    p = pack_ndhwc(jnp.asarray(x.reshape(B, D, H, W, M * C3)), 128 // W)
    return p.reshape(B // (128 // W), D, H, M, C3, 128)


def _unpack(sum_p, sum_e):
    bp = 128 // W
    p = np.asarray(unpack_ndhwc(sum_p, bp))
    e = np.asarray(unpack_ndhwc(sum_e[:, :, :, None], bp))[..., 0]
    return p.reshape(-1, C3).T, e.reshape(-1)


def test_k3_plain_counter_mode_matches_pallas_at_12_classes():
    """bits="counter" at C = 12 draws the JAX kernel's numbers: the plain
    version against ``sampled_softmax_stats`` in interpret mode, atol
    2e-4, rtol 1e-4 (test_torch_sampling.py's tolerance for sums of M*n
    float32 terms added in another order)."""
    assert sampling.plan(C3) == ("shared", 256)
    rs = np.random.RandomState(3)
    mu = rs.randn(B, D, H, W, M, C3).astype(np.float32)
    sigma = (np.abs(rs.randn(B, D, H, W, M, C3)) * 0.5).astype(np.float32)
    want = _unpack(*jsampling.sampled_softmax_stats(
        _pack(mu), _pack(sigma), SEED, n_samples=NS, sd=SD, interpret=True))
    got = sampling.sampled_softmax_stats(
        torch.from_numpy(mu.reshape(-1, M, C3)),
        torch.from_numpy(sigma.reshape(-1, M, C3)), SEED, n_samples=NS,
        bits="counter", spatial=(D, H, W), counter_rows=SD)
    assert got[0].shape == (C3, B * D * H * W)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=1e-4)


def test_k3_plan_takes_the_classes_the_registers_refused():
    """Up to 8 classes the register kernels (C = 2 its own), above that
    the shared-memory one, whose block halves until 16 bytes a class and
    thread fit 232,448 bytes; past 454 classes even 32 threads' do not,
    and the call raises."""
    assert sampling.plan(2) == ("two_class", 256)
    for c in (1, 3, 8):
        assert sampling.plan(c) == ("registers", 256)
    assert sampling.plan(9) == ("shared", 256)
    assert sampling.plan(56) == ("shared", 256)
    assert sampling.plan(57) == ("shared", 128)
    assert sampling.plan(454) == ("shared", 32)
    assert sampling.plan(24, block=64) == ("shared", 64)
    with pytest.raises(ValueError):
        sampling.plan(455)
    with pytest.raises(ValueError):
        sampling.plan(0)


@pytest.mark.cuda
def test_stream_and_shared_regimes_match_plain_on_cuda():
    """K2 at the streaming regime's shapes (both forms, f32 and bf16, the
    path's sample-major layout and a copied one; each launch in the regime
    ``plan`` names, S 80 C 2 in bf16 still the tiled one) at atol 1e-5, K3's
    shared-memory regime at C = 12 (bits exactly, sums atol 1e-4, rtol
    1e-5), as test_torch_entropy.py and test_torch_sampling.py hold the
    other regimes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for s, c in ((5, 24), (80, 2)):
        stack = torch.from_numpy(_stack(s, c, 1)).cuda()
        logits = torch.randn((s, N2 - 3, c), device="cuda").permute(0, 2, 1)
        for x, is_logits in ((stack, False), (stack.bfloat16(), False),
                             (logits, True), (logits.bfloat16(), True)):
            regime = entropy.plan(s, c, x.dtype)   # bf16 S 80 C 2: "tile"
            before = dict(entropy.fused_entropy.regime_launches)
            got = entropy.fused_entropy(x, logits=is_logits)
            assert entropy.fused_entropy.regime_launches[regime] == \
                before[regime] + 1
            want = entropy.fused_entropy_reference(x, logits=is_logits)
            for key in KEYS:
                np.testing.assert_allclose(
                    got[key].float().cpu().numpy(),
                    want[key].float().cpu().numpy(), atol=1e-5, err_msg=key)
    n = 1000
    head = torch.randn((n, M, 2 * C3), device="cuda")
    mu, sigma = head[..., :C3], torch.exp(head[..., C3:] / 2)
    for bits in ("philox", "counter"):
        kw = dict(n_samples=NS, bits=bits)
        if bits == "counter":   # whole volumes of the counter geometry
            n = B * D * H * W
            mu, sigma = torch.randn((n, M, C3), device="cuda"), \
                torch.rand((n, M, C3), device="cuda")
            kw.update(spatial=(D, H, W), counter_rows=SD)
        assert torch.equal(
            sampling.sample_bits(n, M, C3, SEED, device="cuda", **kw),
            sampling.sample_bits_reference(n, M, C3, SEED, device="cuda",
                                           **kw))
        got = sampling.sampled_softmax_stats(mu, sigma, SEED, **kw)
        want = sampling.sampled_softmax_stats_reference(mu, sigma, SEED,
                                                        **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
