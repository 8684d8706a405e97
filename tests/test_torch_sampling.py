"""K3 of the port (values_tpu_torch.ops.kernels.sampling): the bit
sources, the draw and the plain version against the JAX package's
sampling kernel (interpret mode) and its jnp oracle; the CUDA kernel
against the plain version where a card is present. The module imports
jax but not flax, so it collects on the card's machine."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.ops.pallas import sampling as jsampling
from values_tpu.ops.pallas.conv3d import pack_ndhwc, unpack_ndhwc
from values_tpu_torch.inference.scoring import streaming_finalize
from values_tpu_torch.ops.kernels import sampling

# the JAX test's packed geometry, on the port's layout: W=16 packs 8
# items per 128-lane row, so B=16 is nb=2 packs
B, D, H, W, M, C, NS, SD, SEED = 16, 8, 8, 16, 2, 2, 3, 4, 11


def _heads(seed=0, b=B):
    """mu and sigma (B, D, H, W, M, C) float32, drawn as the JAX test
    draws its packed heads."""
    rs = np.random.RandomState(seed)
    mu = rs.randn(b, D, H, W, M, C).astype(np.float32)
    sigma = (np.abs(rs.randn(b, D, H, W, M, C)) * 0.5).astype(np.float32)
    return mu, sigma


def _pack(x):
    """(B, D, H, W, M, C) -> the JAX kernel's (nb, D, H, M, C, 128)."""
    p = pack_ndhwc(jnp.asarray(x.reshape(B, D, H, W, M * C)), 128 // W)
    return p.reshape(B // (128 // W), D, H, M, C, 128)


def _unpack(sum_p, sum_e):
    """JAX (nb, D, H, C, 128) and (nb, D, H, 128) -> the port's (C, N)
    and (N,) layout."""
    bp = 128 // W
    p = np.asarray(unpack_ndhwc(sum_p, bp))              # (B, D, H, W, C)
    e = np.asarray(unpack_ndhwc(sum_e[:, :, :, None], bp))[..., 0]
    return p.reshape(-1, C).T, e.reshape(-1)


@pytest.fixture(scope="module")
def jax_case():
    mu, sigma = _heads()
    mp, sp = _pack(mu), _pack(sigma)
    kernel = jsampling.sampled_softmax_stats(mp, sp, SEED, n_samples=NS,
                                             sd=SD, interpret=True)
    oracle = jsampling.sampled_softmax_stats_reference(mp, sp, SEED,
                                                       n_samples=NS, sd=SD)
    return mu, sigma, {"kernel": _unpack(*kernel),
                       "oracle": _unpack(*oracle)}


def _port(mu, sigma, seed=SEED, **kw):
    kw.setdefault("n_samples", NS)
    return sampling.sampled_softmax_stats(
        torch.from_numpy(mu.reshape(-1, M, C)),
        torch.from_numpy(sigma.reshape(-1, M, C)), seed, **kw)


@pytest.mark.parametrize("seed,salt,shape", [
    (7, 3, (64, 128)), (0, 0, (3, 5)), (2 ** 31 - 1, 5, (4, 8, 2, 128)),
    (2 ** 31 - 2, 2 ** 30 + 7, (2, 2, 128)), (-5, 1, (16, 2, 128))])
def test_counter_bits_match_jax_exactly(seed, salt, shape):
    """uint32 equality; 2**31 - 1 and -5 exercise the int32 wrap."""
    want = np.asarray(jsampling.counter_bits(jnp.int32(seed),
                                             jnp.int32(salt), shape))
    got = sampling.counter_bits(seed, salt, shape).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_uniform_from_bits_exact():
    bits = sampling.counter_bits(7, 3, (64, 128))
    bits[0, :4] = torch.tensor([0, 255, 2 ** 32 - 1, 2 ** 31])
    want = np.asarray(jsampling.uniform_from_bits(
        jnp.asarray(bits.numpy().astype(np.uint32))))
    got = sampling.uniform_from_bits(bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() > 0.0 and got.max() < 1.0


def test_inverse_normal_cdf_matches_jax_and_scipy():
    """rtol 2e-6 against the JAX function on the same float32 uniforms
    (the same operations, in another library's order), and the JAX
    test's own atol 5e-4 / rtol 1e-3 against scipy's exact quantile."""
    scipy_stats = pytest.importorskip("scipy.stats")
    u = np.concatenate([
        np.linspace(1e-6, 0.02, 7), np.linspace(0.03, 0.97, 23),
        np.linspace(0.98, 1 - 1e-6, 7),
        sampling.uniform_from_bits(
            sampling.counter_bits(3, 1, (4096,))).numpy()]).astype(np.float32)
    got = sampling.inverse_normal_cdf(torch.from_numpy(u)).numpy()
    want = np.asarray(jsampling.inverse_normal_cdf(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    np.testing.assert_allclose(got[:37], scipy_stats.norm.ppf(u[:37]),
                               atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("which", ["kernel", "oracle"])
def test_plain_counter_mode_matches_jax(jax_case, which):
    """The same draws on the port's NDHWC layout: atol 2e-4, rtol 1e-4,
    the JAX test's own tolerance for sums of M*n float32 terms added in
    another order (largest difference seen: 5.8e-5 against the
    interpreted kernel, 9.5e-7 against the oracle)."""
    mu, sigma, want = jax_case
    got_p, got_e = _port(mu, sigma, bits="counter", spatial=(D, H, W),
                         counter_rows=SD)
    assert got_p.shape == (C, B * D * H * W) and got_e.shape == (B * D * H * W,)
    assert got_p.dtype == got_e.dtype == torch.float32
    np.testing.assert_allclose(got_p.numpy(), want[which][0], atol=2e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got_e.numpy(), want[which][1], atol=2e-4,
                               rtol=1e-4)


def test_counter_mode_seed_wraps_as_jax_int32(jax_case):
    """A seed of 2**31 - 2 with 3 samples: the JAX oracle's int32
    ``seed + i`` wraps to -2**31 at i = 2, and the port's ``(seed + i)
    mod 2**32`` must draw the same bits (same tolerance as above)."""
    mu, sigma, _ = jax_case
    seed = 2 ** 31 - 2
    want = _unpack(*jsampling.sampled_softmax_stats_reference(
        _pack(mu), _pack(sigma), seed, n_samples=NS, sd=SD))
    got = _port(mu, sigma, seed, bits="counter", spatial=(D, H, W),
                counter_rows=SD)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=1e-4)


def test_strided_head_views_take_the_same_draws(jax_case):
    """mu and sigma as (N, M, C) views into an (N, M, 2C) head, as the
    scorer passes them: the same result as contiguous inputs."""
    mu, sigma, _ = jax_case
    head = torch.from_numpy(np.concatenate([mu, sigma], -1).reshape(-1, M,
                                                                    2 * C))
    views = head[..., :C], head[..., C:]
    assert not views[0].is_contiguous()
    for bits in sampling.BITS:
        kw = dict(n_samples=NS, bits=bits, spatial=(D, H, W),
                  counter_rows=SD)
        got = sampling.sampled_softmax_stats(*views, SEED, **kw)
        want = _port(mu, sigma, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("bits", sampling.BITS)
def test_sigma_zero_is_n_times_softmax(bits):
    """With sigma = 0 every draw is softmax(mu): sum_p = n sum_m
    softmax(mu) and sum_ent = n sum_m H(mu), atol 1e-5."""
    mu, _ = _heads(1, b=8)
    n = 4
    sum_p, sum_e = _port(mu, np.zeros_like(mu), n_samples=n, bits=bits,
                         spatial=(D, H, W), counter_rows=SD)
    t = torch.from_numpy(mu.reshape(-1, M, C))
    p = torch.softmax(t, dim=-1)
    ent = -(p * torch.log_softmax(t, dim=-1)).sum(-1)
    np.testing.assert_allclose(sum_p.numpy(), (n * p.sum(1)).T.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(sum_e.numpy(), (n * ent.sum(1)).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))],
    ids=["zero", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    """Random123's published Philox4x32-10 known-answer vectors."""
    words = sampling.philox4x32(*(torch.tensor(c) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_philox_normals_and_streams():
    """z ~ N(0, 1): mean within 4/sqrt(n), std within 0.02 of 1; another
    seed gives another stream, and a voxel's bits do not depend on N."""
    n_vox = 4096
    bits = sampling.sample_bits_reference(n_vox, 2, 3, 123, n_samples=2)
    z = sampling.inverse_normal_cdf(sampling.uniform_from_bits(bits)).numpy()
    assert abs(z.mean()) < 4.0 / np.sqrt(z.size)
    assert abs(z.std() - 1.0) < 0.02
    other = sampling.sample_bits_reference(n_vox, 2, 3, 124, n_samples=2)
    assert (bits == other).float().mean() < 0.01
    high = sampling.sample_bits_reference(n_vox, 2, 3, 123 + 2 ** 32,
                                          n_samples=2)
    assert (bits == high).float().mean() < 0.01
    prefix = sampling.sample_bits_reference(1000, 2, 3, 123, n_samples=2)
    assert torch.equal(prefix, bits[:1000])
    # classes 0..3 share one Philox call; class 4 starts the next counter
    wide = sampling.sample_bits_reference(64, 1, 5, 9, n_samples=1)
    words = sampling.philox4x32(torch.arange(64), torch.zeros(64, dtype=torch.long),
                                torch.ones(64, dtype=torch.long),
                                torch.zeros(64, dtype=torch.long), 9, 0)
    assert torch.equal(wide[:, 0, 0, 4], words[0])


@pytest.mark.parametrize("c,n_samples", [(2, 3), (3, 5)])
def test_plain_philox_draws_use_every_word_of_the_new_counter(c, n_samples):
    """Draw (i, c) of member m takes word j mod 4 of Philox at counter
    (n, m, j // 4, 0), j = i * C + c; with an odd n_samples the last call
    is ragged. Word for word against ``philox4x32``."""
    n_vox, m, seed = 37, 3, 2 ** 32 + 99
    bits = sampling.sample_bits_reference(n_vox, m, c, seed,
                                          n_samples=n_samples)
    assert bits.shape == (n_vox, m, n_samples, c)
    vox = torch.arange(n_vox)
    zero = torch.zeros(n_vox, dtype=torch.long)
    for im in range(m):
        calls = [sampling.philox4x32(vox, zero + im, zero + g, zero,
                                     seed & sampling.MASK32, seed >> 32)
                 for g in range(-(-n_samples * c // 4))]
        for i in range(n_samples):
            for cls in range(c):
                g, word = divmod(i * c + cls, 4)
                assert torch.equal(bits[:, im, i, cls], calls[g][word])


@pytest.mark.parametrize("bits", sampling.BITS)
def test_log_var_form_equals_sigma_form(bits):
    """``log_var=s`` draws what ``sigma=exp(s / 2)`` draws, f32 atol 1e-6
    (the same float32 sigma on both sides)."""
    mu, sigma = _heads(5, b=8)
    log_var = (2.0 * np.log(sigma + 0.05)).astype(np.float32)
    kw = dict(n_samples=NS, bits=bits, spatial=(D, H, W), counter_rows=SD)
    t_mu = torch.from_numpy(mu.reshape(-1, M, C))
    t_lv = torch.from_numpy(log_var.reshape(-1, M, C))
    got = sampling.sampled_softmax_stats(t_mu, None, SEED, log_var=t_lv, **kw)
    want = sampling.sampled_softmax_stats(t_mu, torch.exp(t_lv / 2.0), SEED,
                                          **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("form", ["sigma", "log_var"])
def test_bf16_inputs_give_their_float32_upcast(form):
    """bfloat16 mu and scale give exactly the result of their float32
    upcast: the plain version computes in float32 either way."""
    mu, sigma = _heads(6, b=8)
    head = torch.from_numpy(np.concatenate([mu, sigma], -1)
                            .reshape(-1, M, 2 * C)).to(torch.bfloat16)
    kw = dict(n_samples=NS)
    views = head[..., :C], head[..., C:]
    up = tuple(v.float() for v in views)

    def call(mu_t, scale):
        if form == "sigma":
            return sampling.sampled_softmax_stats(mu_t, scale, SEED, **kw)
        return sampling.sampled_softmax_stats(mu_t, None, SEED,
                                              log_var=scale, **kw)

    got, want = call(*views), call(*up)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)


@pytest.mark.parametrize("which", ["both", "neither"])
def test_exactly_one_of_sigma_and_log_var(which):
    mu = torch.zeros(16, M, C)
    scale = torch.ones(16, M, C)
    sigma, log_var = (scale, scale) if which == "both" else (None, None)
    for fn in (sampling.sampled_softmax_stats,
               sampling.sampled_softmax_stats_reference):
        with pytest.raises(ValueError, match="exactly one"):
            fn(mu, sigma, SEED, n_samples=1, log_var=log_var)


def test_sample_bits_device_none_means_the_card():
    """``device=None`` resolves to the CUDA card, as every entry of the
    port does, and raises without one; ``device="cpu"`` is the plain
    version."""
    want = sampling.sample_bits_reference(20, 2, 2, 5, n_samples=2)
    assert torch.equal(sampling.sample_bits(20, 2, 2, 5, n_samples=2,
                                            device="cpu"), want)
    if torch.cuda.is_available():
        got = sampling.sample_bits(20, 2, 2, 5, n_samples=2)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sampling.sample_bits(20, 2, 2, 5, n_samples=2)


def test_streaming_finalize_matches_jax():
    """The port's (C, N) finalize against JAX's on the transposed layout
    (class axis -1), f32 atol 1e-6."""
    # imported here: values_tpu.inference needs flax, which the card's
    # machine lacks, and the cuda-marked test below runs there
    from values_tpu.inference.scoring import \
        streaming_finalize as jax_finalize
    mu, sigma = _heads(2, b=8)
    sum_p, sum_e = _port(mu, sigma, n_samples=2)
    got = streaming_finalize((sum_p, sum_e), M * 2)
    want = jax_finalize((jnp.asarray(sum_p.numpy().T),
                         jnp.asarray(sum_e.numpy())), M * 2, class_axis=-1)
    np.testing.assert_allclose(got["mean_softmax"].numpy(),
                               np.asarray(want["mean_softmax"]).T, atol=1e-6)
    for key in ("pred_entropy", "expected_entropy", "mutual_information"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, err_msg=key)
    assert got["mutual_information"].min() > -1e-4


def test_cpu_tensors_take_the_plain_version_and_bad_calls_raise():
    mu, sigma = _heads(3, b=8)
    before = sampling.sampled_softmax_stats.launches
    got = _port(mu, sigma, n_samples=1)
    want = sampling.sampled_softmax_stats_reference(
        torch.from_numpy(mu.reshape(-1, M, C)),
        torch.from_numpy(sigma.reshape(-1, M, C)), SEED, n_samples=1)
    assert sampling.sampled_softmax_stats.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        _port(mu, sigma, bits="hw")
    with pytest.raises(ValueError):
        _port(mu, sigma, bits="counter")                 # no spatial
    with pytest.raises(ValueError):      # W must divide the 128 lanes
        sampling.sampled_softmax_stats(torch.zeros(48, M, C),
                                       torch.zeros(48, M, C), 0, n_samples=1,
                                       bits="counter", spatial=(1, 1, 24))
    with pytest.raises(ValueError):
        _port(mu, sigma, bits="counter", spatial=(D, H, W), counter_rows=3)


def test_default_counter_rows_is_the_jax_default():
    """The JAX kernel's own D-block choice (16 at patch 16, 4 at 64)."""
    assert sampling.default_counter_rows(16, 16, 2) == 16
    assert sampling.default_counter_rows(64, 64, 2) == 4
    assert sampling.default_counter_rows(D, H, C) == D


@pytest.mark.cuda
@pytest.mark.parametrize("bits", sampling.BITS)
def test_kernel_matches_plain_on_cuda(bits, monkeypatch):
    """Bits exactly; sums at atol 1e-4, rtol 1e-5 (the kernel's float32
    transcendentals and FMAs differ from PyTorch's in the last ulps, over
    M*n terms of at most 1 and log C), in the sigma form, the log_var
    form and in bfloat16. A smaller block draws the same bits and gives
    the same sums (atol 1e-6: only the compiler's instruction choice can
    differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mu, sigma = _heads(4)
    n_vox = mu.size // (M * C) - 37                      # a ragged N
    log_var = 2.0 * np.log(sigma + 0.05)
    head = torch.from_numpy(np.concatenate([mu, sigma, log_var], -1)
                            .astype(np.float32)
                            .reshape(-1, M, 3 * C)[:n_vox]).cuda()
    spatial = (D, H, W) if bits == "philox" else None
    if bits == "counter":   # the counter geometry needs whole volumes
        n_vox = (n_vox // (D * H * W)) * D * H * W
        head = head[:n_vox]
        spatial = (D, H, W)
    views = head[..., :C], head[..., C:2 * C]
    kw = dict(n_samples=NS, bits=bits, spatial=spatial, counter_rows=SD)
    got_bits = sampling.sample_bits(n_vox, M, C, SEED, device="cuda", **kw)
    want_bits = sampling.sample_bits_reference(n_vox, M, C, SEED,
                                               device="cuda", **kw)
    assert torch.equal(got_bits, want_bits)
    before = sampling.sampled_softmax_stats.launches
    got = sampling.sampled_softmax_stats(*views, SEED, **kw)
    assert sampling.sampled_softmax_stats.launches == before + 1
    want = sampling.sampled_softmax_stats_reference(*views, SEED, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    for dtype in (torch.float32, torch.bfloat16):
        mu_t, lv = head[..., :C].to(dtype), head[..., 2 * C:].to(dtype)
        got_lv = sampling.sampled_softmax_stats(mu_t, None, SEED,
                                                log_var=lv, **kw)
        want_lv = sampling.sampled_softmax_stats_reference(
            mu_t, None, SEED, log_var=lv, **kw)
        for g, w in zip(got_lv, want_lv):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)
    monkeypatch.setattr(sampling, "BLOCK", 64)
    assert torch.equal(sampling.sample_bits(n_vox, M, C, SEED,
                                            device="cuda", **kw), want_bits)
    small = sampling.sampled_softmax_stats(*views, SEED, **kw)
    for g, s in zip(got, small):
        torch.testing.assert_close(g, s, atol=1e-6, rtol=0)
    with pytest.raises(TypeError):
        sampling.sampled_softmax_stats(views[0].double(), views[1].double(),
                                       SEED, **kw)
