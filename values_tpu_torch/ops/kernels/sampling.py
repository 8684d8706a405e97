"""K3: streaming sampled-softmax statistics (the aleatoric tail).

Port of ``values_tpu/ops/pallas/sampling.py::_sample_stats_kernel``
(entry ``sampled_softmax_stats``) to a Triton kernel. For the (mu, sigma)
heads of M members at N voxels over C classes it draws ``n_samples``
logit samples per member, ``logits = mu + sigma * z`` with z ~ N(0, 1),
and returns

- ``sum_p`` (C, N): the sum over members x samples of softmax(logits);
- ``sum_ent`` (N,): the sum of the per-sample entropies
  ``-sum_c p log p`` (log-sum-exp form: log p = logits - lse, so an
  underflowing p contributes exactly 0).

Both are float32, and :func:`values_tpu_torch.inference.scoring.
streaming_finalize` turns them into the C2 statistics with
``n = M * n_samples``. ``sum_p`` has the (C, N) layout of K2's
``mean_softmax``, so the scorer's tail takes it unchanged.

The draw: uint32 bits -> :func:`uniform_from_bits` (top 24 bits) ->
Acklam's :func:`inverse_normal_cdf`. Two bit sources:

- ``"philox"`` (default; it takes the place of the TPU's hardware PRNG):
  Philox4x32-10 with key (seed mod 2**32, seed >> 32 mod 2**32) and
  counter (voxel n, m * n_samples + i, c // 4, 0); class c takes output
  word c mod 4. An element's bits depend on (seed, n, m, i, c) only,
  never on the block size or the grid.
- ``"counter"``: the JAX package's ``counter_bits`` murmur3-finalizer
  hash, indexed as the JAX kernel indexes its packed tiles (batch pack
  ``bp = 128 // W``, D-blocks of ``counter_rows`` rows), so the port
  reproduces ``sampled_softmax_stats(bits_source="counter")`` draw for
  draw on NDHWC tensors. It needs ``spatial=(D, H, W)`` with
  ``128 % W == 0`` and ``D % counter_rows == 0``.

The kernel is compiled without FMA contraction (``enable_fp_fusion=
False``): Acklam's central polynomial cancels some 180-fold near its
edges in float32, so a fused evaluation would move z by up to 3e-4 from
the plain version and the JAX float32 form, which round each product and
sum (:func:`inverse_normal_cdf`).

What bounds it on an H100: per voxel it reads 2*M*C floats and writes
C+1, but draws M*n_samples*C normals, each costing a Philox share or a
hash, an inverse CDF with a log, a sqrt and two divisions, and a softmax
and entropy with exp, log and a division. At the path's shape (B 32,
64^3, M 5, C 2, n 10) that is 0.23 ms of bytes at 3.35 TB/s against
about 100 G operations, 1.5 ms at 67 TFLOP/s f32: it is bound by
operations. Each program holds a block of voxels with all C classes as
the second block axis and loops over members (unrolled) and samples
(a runtime loop) in registers, so every mu/sigma byte is read once,
every output written once, and no atomics are needed -- the loop inside
the block takes the place of the TPU grid's member axis, which revisited
the output.

:func:`sampled_softmax_stats` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; it never falls back from one to
the other. ``triton`` is imported only when a kernel is launched.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Sequence, Tuple

import torch

from .build import BUILD_DIR

BITS = ("philox", "counter")
LANES = 128
BLOCK = 256
MASK32 = 0xFFFFFFFF

# Philox4x32-10 (Salmon et al. 2011, Random123)
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10

# Acklam's inverse normal CDF (values_tpu/ops/pallas/sampling.py:57-68)
_A = (-3.969683028665376e+01, 2.209460984245205e+02,
      -2.759285104469687e+02, 1.383577518672690e+02,
      -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02,
      -1.556989798598866e+02, 6.680131188771972e+01,
      -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01,
      -2.400758277161838e+00, -2.549732539343734e+00,
      4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01,
      2.445134137142996e+00, 3.754408661907416e+00)
PLOW = 0.02425


# -- the draw, in plain PyTorch ------------------------------------------------
#
# uint32 values live in int64 tensors, reduced mod 2**32 after each step.
# A 32 x 32 -> 64-bit product would overflow int64, so products take the
# multiplier in 16-bit halves.

def _mul_lo(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2**32 for x in [0, 2**32) and a constant k."""
    lo = x * (k & 0xFFFF)
    hi = (x * (k >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _mul_hilo(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of x * k for x in [0, 2**32)."""
    p0 = x * (k & 0xFFFF)                       # < 2**48
    p1 = x * (k >> 16)                          # < 2**48
    t = ((p1 & 0xFFFF) << 16) + p0              # < 2**49
    return (p1 >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words (int64 tensors of uint32
    values, broadcastable) under the key (k0, k1); returns four words."""
    c0, c1, c2, c3 = (torch.as_tensor(c) & MASK32 for c in (c0, c1, c2, c3))
    k0, k1 = k0 & MASK32, k1 & MASK32
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mul_hilo(c0, PHILOX_M0)
        hi1, lo1 = _mul_hilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def _hash32(flat: torch.Tensor, seed: int, salt) -> torch.Tensor:
    """The murmur3-finalizer hash of ``counter_bits``
    (values_tpu/ops/pallas/sampling.py:107-113), all mod 2**32; ``salt``
    is an int or an int64 tensor broadcastable to ``flat``."""
    x = flat ^ (((seed & MASK32) * 0x9E3779B9) & MASK32)
    if isinstance(salt, torch.Tensor):
        x = (x + _mul_lo(salt & MASK32, 0x85EBCA6B)) & MASK32
    else:
        x = (x + (((salt & MASK32) * 0x85EBCA6B) & MASK32)) & MASK32
    x = x ^ (x >> 16)
    x = _mul_lo(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_lo(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_bits(seed: int, salt: int, shape: Sequence[int]) -> torch.Tensor:
    """The JAX package's ``counter_bits(seed, salt, shape)``: one tile of
    uint32 bits, returned as int64 values in [0, 2**32). The counter is
    the row-major flat index of the tile."""
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.arange(n, dtype=torch.int64).reshape(tuple(shape))
    return _hash32(flat, seed, salt)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 uniform strictly inside (0, 1): the top 24
    bits, u = top * 2**-24 + 2**-26."""
    top = ((bits & MASK32) >> 8).to(torch.int32)
    return top.to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 25))


def inverse_normal_cdf(u: torch.Tensor) -> torch.Tensor:
    """Acklam's rational approximation of the standard normal inverse CDF
    (relative error < 1.15e-9 in exact arithmetic), in the JAX form: all
    three branches evaluated, the one that applies selected.

    In float32 the central branch is ill-conditioned near its edges
    (|u - 0.5| near 0.4758): the numerator's last step adds a[5] = 2.5066
    to about -2.493, so rounding errors grow some 180-fold there. This
    unfused form is then off the exact quantile by up to ~1.3e-4 (at
    u = 0.027145: -1.92465 against -1.92452), and a form with fused
    multiply-adds by as much the other way; the kernel therefore runs
    with FMA contraction off, so both round alike."""
    a, b, c, d = _A, _B, _C, _D
    q = u - 0.5
    r = q * q
    central = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
               * r + a[5]) * q / (
        ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0)
    ql = torch.sqrt(-2.0 * torch.log(torch.clamp(u, max=0.5)))
    lower = (((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4])
             * ql + c[5]) / (
        (((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1.0)
    qh = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u, max=0.5)))
    upper = -(((((c[0] * qh + c[1]) * qh + c[2]) * qh + c[3]) * qh + c[4])
              * qh + c[5]) / (
        (((d[0] * qh + d[1]) * qh + d[2]) * qh + d[3]) * qh + 1.0)
    return torch.where(u < PLOW, lower,
                       torch.where(u > 1.0 - PLOW, upper, central))


def entropy_terms(logits: torch.Tensor, class_axis: int = -1):
    """softmax and per-voxel entropy of ``logits`` in log-sum-exp form:
    ``log p = logits - max - log(sum exp)``, so p log p never goes
    through log(0)."""
    m = torch.amax(logits, dim=class_axis, keepdim=True)
    e = torch.exp(logits - m)
    se = torch.sum(e, dim=class_axis, keepdim=True)
    p = e / se
    logp = (logits - m) - torch.log(se)
    return p, -torch.sum(p * logp, dim=class_axis)


def default_counter_rows(d: int, h: int, c: int) -> int:
    """The JAX kernel's default D-block (``sd``,
    values_tpu/ops/pallas/sampling.py:213-224): the largest divisor of D
    whose six (sd, H, C, 128) float32 tiles stay within 2 MiB."""
    sd = d
    while sd > 1 and (d % sd or 6 * sd * h * c * LANES * 4 > 2 * 2 ** 20):
        sd -= 1
    return sd


def _counter_geometry(n: int, m: int, c: int, spatial, counter_rows):
    """Validate the counter mode's packed geometry; returns (B, D, H, W,
    rows)."""
    if spatial is None or len(spatial) != 3:
        raise ValueError("bits='counter' needs spatial=(D, H, W)")
    d, h, w = (int(s) for s in spatial)
    if n % (d * h * w):
        raise ValueError(f"N={n} is not a multiple of D*H*W={d * h * w}")
    if LANES % w:
        raise ValueError(f"bits='counter' packs {LANES} // W items per "
                         f"lane row; W={w} does not divide {LANES}")
    rows = default_counter_rows(d, h, c) if counter_rows is None \
        else int(counter_rows)
    if rows < 1 or d % rows:
        raise ValueError(f"counter_rows={rows} must divide D={d}")
    return n // (d * h * w), d, h, w, rows


def _bit_source(n: int, m: int, c: int, seed: int, *, n_samples: int,
                bits: str, spatial, counter_rows, device):
    """``draw(im, i) -> (N, C)`` int64 bits of member im's sample i, as
    the kernel draws them."""
    seed = int(seed) & (2 ** 64 - 1)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if bits == "counter":
        _, d, h, w, rows = _counter_geometry(n, m, c, spatial, counter_rows)
        bp = LANES // w
        cls = torch.arange(c, dtype=torch.int64, device=device)
        wi, t = idx % w, idx // w
        hi, t = t % h, t // h
        di, bi = t % d, t // d
        lane = (bi % bp) * w + wi
        flat = (((di % rows) * h + hi)[:, None] * c + cls) * LANES \
            + lane[:, None]
        salt0 = (((bi // bp) * (d // rows) + di // rows) * m)[:, None]
        return lambda im, i: _hash32(flat, seed + i, salt0 + im)

    def draw(im, i):
        out = torch.empty((n, c), dtype=torch.int64, device=device)
        c1 = torch.full_like(idx, im * n_samples + i)
        zero = torch.zeros_like(idx)
        for g in range((c + 3) // 4):
            words = philox4x32(idx, c1, zero + g, zero, seed & MASK32,
                               seed >> 32)
            for j in range(min(4, c - 4 * g)):
                out[:, 4 * g + j] = words[j]
        return out
    return draw


def sample_bits_reference(n: int, m: int, c: int, seed: int, *,
                          n_samples: int, bits: str = "philox",
                          spatial=None, counter_rows=None,
                          device=None) -> torch.Tensor:
    """Every draw's bits, (N, M, n_samples, C) int64 in [0, 2**32): the
    plain version of what the kernel draws for (voxel, member, sample,
    class)."""
    draw = _bit_source(n, m, c, seed, n_samples=n_samples, bits=bits,
                       spatial=spatial, counter_rows=counter_rows,
                       device=device)
    return torch.stack([torch.stack([draw(im, i) for i in range(n_samples)],
                                    dim=1) for im in range(m)], dim=1)


def _check(mu: torch.Tensor, sigma: torch.Tensor, n_samples: int,
           bits: str):
    if bits not in BITS:
        raise ValueError(f"bits={bits!r} is not one of {BITS}")
    if mu.ndim != 3 or tuple(sigma.shape) != tuple(mu.shape):
        raise ValueError(f"mu {tuple(mu.shape)} and sigma "
                         f"{tuple(sigma.shape)} must both be (N, M, C)")
    if n_samples < 1:
        raise ValueError(f"n_samples={n_samples} must be at least 1")


def sampled_softmax_stats_reference(mu: torch.Tensor, sigma: torch.Tensor,
                                    seed: int, *, n_samples: int,
                                    bits: str = "philox", spatial=None,
                                    counter_rows=None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K3, member by member and sample by
    sample in float32 (float64 for float64 input): the same bits, draws
    and log-sum-exp terms as the kernel."""
    _check(mu, sigma, n_samples, bits)
    n, m, c = mu.shape
    compute = torch.float64 if mu.dtype == torch.float64 else torch.float32
    draw = _bit_source(n, m, c, seed, n_samples=n_samples, bits=bits,
                       spatial=spatial, counter_rows=counter_rows,
                       device=mu.device)
    sum_p = torch.zeros((n, c), dtype=compute, device=mu.device)
    sum_e = torch.zeros((n,), dtype=compute, device=mu.device)
    for im in range(m):
        mu_m, sig_m = mu[:, im].to(compute), sigma[:, im].to(compute)
        for i in range(n_samples):
            z = inverse_normal_cdf(uniform_from_bits(draw(im, i)))
            p, ent = entropy_terms(mu_m + sig_m * z.to(compute))
            sum_p += p
            sum_e += ent
    return sum_p.t().contiguous(), sum_e


@functools.lru_cache(maxsize=None)
def _kernels():
    # keep Triton's compile cache beside the CUDA builds, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    # the constants below are PHILOX_*, _A.._D and PLOW above, written
    # out: a jitted function reads no plain module globals
    @triton.jit
    def philox(c0, c1, c2, c3, k0, k1):
        for _ in tl.static_range(10):
            hi0 = tl.umulhi(c0, 0xD2511F53)
            lo0 = c0 * 0xD2511F53
            hi1 = tl.umulhi(c2, 0xCD9E8D57)
            lo1 = c2 * 0xCD9E8D57
            c0 = hi1 ^ c1 ^ k0
            c1 = lo1
            c2 = hi0 ^ c3 ^ k1
            c3 = lo0
            k0 = k0 + 0x9E3779B9
            k1 = k1 + 0xBB67AE85
        return c0, c1, c2, c3

    @triton.jit
    def draw_bits(ctr, cols, flat, salt, m, i, n_samples, k0, k1,
                  C: tl.constexpr, NG: tl.constexpr,
                  COUNTER: tl.constexpr):
        """uint32 bits (BLOCK_N, CP) of member m's sample i."""
        if COUNTER:
            s = k0 + i.to(tl.uint32)
            x = flat ^ (s * 0x9E3779B9)
            x = x + ((salt + m).to(tl.uint32) * 0x85EBCA6B)[:, None]
            x = x ^ (x >> 16)
            x = x * 0x7FEB352D
            x = x ^ (x >> 15)
            x = x * 0x846CA68B
            out = x ^ (x >> 16)
        else:
            zero = ctr * 0
            c1 = zero + (m * n_samples + i).to(tl.uint32)
            out = flat * 0
            for g in tl.static_range(NG):
                w0, w1, w2, w3 = philox(ctr, c1, zero + g, zero, k0, k1)
                out = tl.where(cols[None, :] == 4 * g, w0[:, None], out)
                out = tl.where(cols[None, :] == 4 * g + 1, w1[:, None], out)
                out = tl.where(cols[None, :] == 4 * g + 2, w2[:, None], out)
                out = tl.where(cols[None, :] == 4 * g + 3, w3[:, None], out)
        return out

    @triton.jit
    def geometry(offs, cols, seed_lo, seed_hi, D, H, W, rows,
                 M: tl.constexpr, C: tl.constexpr, COUNTER: tl.constexpr):
        """The key and the per-voxel counter words; in counter mode the
        packed flat index (BLOCK_N, CP) and the salt base (BLOCK_N,)."""
        # the wrapper passes each key word minus 2**31, as an int32
        k0 = seed_lo.to(tl.uint32, bitcast=True) ^ 0x80000000
        k1 = seed_hi.to(tl.uint32, bitcast=True) ^ 0x80000000
        ctr = offs.to(tl.uint32)
        if COUNTER:
            wi = offs % W
            t = offs // W
            hi = t % H
            t = t // H
            di = t % D
            bi = t // D
            bp = 128 // W
            lane = (bi % bp) * W + wi
            flat = ((((di % rows) * H + hi)[:, None] * C + cols[None, :])
                    * 128 + lane[:, None]).to(tl.uint32)
            salt = ((bi // bp) * (D // rows) + di // rows) * M
        else:
            flat = (offs[:, None] * 0 + cols[None, :]).to(tl.uint32)
            salt = offs * 0
        return k0, k1, ctr, flat, salt

    @triton.jit
    def normal_from_bits(bits):
        """uniform_from_bits, then Acklam's inverse CDF. The two tails
        share one log and sqrt: q = sqrt(-2 log(min(u, 1 - u))), and the
        upper tail is the lower one's negative; the branch that applies
        is selected."""
        u = (bits >> 8).to(tl.float32) * (1.0 / 16777216.0) \
            + (0.5 / 33554432.0)
        q = u - 0.5
        r = q * q
        num = (((((-3.969683028665376e+01 * r + 2.209460984245205e+02) * r
                  - 2.759285104469687e+02) * r + 1.383577518672690e+02) * r
                - 3.066479806614716e+01) * r + 2.506628277459239e+00) * q
        den = ((((-5.447609879822406e+01 * r + 1.615858368580409e+02) * r
                 - 1.556989798598866e+02) * r + 6.680131188771972e+01) * r
               - 1.328068155288572e+01) * r + 1.0
        central = num / den
        lower_half = u < 0.5
        qt = tl.sqrt(-2.0 * tl.log(tl.where(lower_half, u, 1.0 - u)))
        tnum = ((((-7.784894002430293e-03 * qt - 3.223964580411365e-01) * qt
                  - 2.400758277161838e+00) * qt - 2.549732539343734e+00) * qt
                + 4.374664141464968e+00) * qt + 2.938163982698783e+00
        tden = (((7.784695709041462e-03 * qt + 3.224671290700398e-01) * qt
                 + 2.445134137142996e+00) * qt + 3.754408661907416e+00) * qt \
            + 1.0
        tail = tnum / tden
        tail = tl.where(lower_half, tail, -tail)
        in_tail = (u < 0.02425) | (u > 1.0 - 0.02425)
        return tl.where(in_tail, tail, central)

    # the key words may take any int32 value: never specialize on them
    @triton.jit(do_not_specialize=["seed_lo", "seed_hi"])
    def sampled_stats_kernel(mu_ptr, sig_ptr, sump_ptr, sument_ptr, n,
                             n_samples, seed_lo, seed_hi,
                             smu_n, smu_m, smu_c, ssg_n, ssg_m, ssg_c,
                             D, H, W, rows,
                             M: tl.constexpr, C: tl.constexpr,
                             CP: tl.constexpr, NG: tl.constexpr,
                             COUNTER: tl.constexpr, BLOCK_N: tl.constexpr):
        offs = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        cols = tl.arange(0, CP)
        rmask = offs < n
        cmask = cols < C
        mask = rmask[:, None] & cmask[None, :]
        k0, k1, ctr, flat, salt = geometry(offs, cols, seed_lo, seed_hi,
                                           D, H, W, rows, M, C, COUNTER)
        acc_p = tl.zeros([BLOCK_N, CP], dtype=tl.float32)
        acc_e = tl.zeros([BLOCK_N], dtype=tl.float32)
        for m in tl.static_range(M):
            mu = tl.load(mu_ptr + offs[:, None] * smu_n + m * smu_m
                         + cols[None, :] * smu_c, mask=mask, other=0.0)
            sg = tl.load(sig_ptr + offs[:, None] * ssg_n + m * ssg_m
                         + cols[None, :] * ssg_c, mask=mask, other=0.0)
            for i in range(n_samples):
                z = normal_from_bits(draw_bits(ctr, cols, flat, salt, m, i,
                                               n_samples, k0, k1, C, NG,
                                               COUNTER))
                logits = tl.where(cmask[None, :], mu + sg * z,
                                  float("-inf"))
                shifted = logits - tl.max(logits, axis=1)[:, None]
                e = tl.exp(shifted)
                se = tl.sum(e, axis=1)
                p = e / se[:, None]
                plogp = tl.where(cmask[None, :],
                                 p * (shifted - tl.log(se)[:, None]), 0.0)
                acc_p += p
                acc_e -= tl.sum(plogp, axis=1)
        tl.store(sump_ptr + cols[None, :] * n + offs[:, None], acc_p,
                 mask=mask)
        tl.store(sument_ptr + offs, acc_e, mask=rmask)

    @triton.jit(do_not_specialize=["seed_lo", "seed_hi"])
    def bits_kernel(out_ptr, n, n_samples, seed_lo, seed_hi, D, H, W, rows,
                    M: tl.constexpr, C: tl.constexpr, CP: tl.constexpr,
                    NG: tl.constexpr, COUNTER: tl.constexpr,
                    BLOCK_N: tl.constexpr):
        """The draws' bits as (N, M, n_samples, C) int32 words: the
        sampling kernel's bit source, on its own, for exact checks."""
        offs = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        cols = tl.arange(0, CP)
        mask = (offs < n)[:, None] & (cols < C)[None, :]
        k0, k1, ctr, flat, salt = geometry(offs, cols, seed_lo, seed_hi,
                                           D, H, W, rows, M, C, COUNTER)
        for m in tl.static_range(M):
            for i in range(n_samples):
                b = draw_bits(ctr, cols, flat, salt, m, i, n_samples, k0,
                              k1, C, NG, COUNTER)
                tl.store(out_ptr + ((offs[:, None] * M + m) * n_samples + i)
                         * C + cols[None, :], b.to(tl.int32, bitcast=True),
                         mask=mask)

    return triton, sampled_stats_kernel, bits_kernel


def _launch_args(n: int, m: int, c: int, seed: int, bits: str, spatial,
                 counter_rows):
    """Scalar launch arguments shared by both kernels: the key words
    (each minus 2**31, so Triton types them int32 whatever the seed) and
    the counter geometry (zeros in Philox mode)."""
    seed = int(seed) & (2 ** 64 - 1)
    key = ((seed & MASK32) - 2 ** 31, (seed >> 32) - 2 ** 31)
    geo = (1, 1, 1, 1)
    if bits == "counter":
        geo = _counter_geometry(n, m, c, spatial, counter_rows)[1:]
    cp = 1 << max(0, (c - 1).bit_length())
    # no FMA contraction: the kernel rounds each product and sum as the
    # plain version and the JAX float32 form do (see inverse_normal_cdf)
    meta = dict(M=m, C=c, CP=cp, NG=(c + 3) // 4,
                COUNTER=bits == "counter", BLOCK_N=BLOCK,
                enable_fp_fusion=False)
    return key, geo, meta


def _span(t: torch.Tensor) -> int:
    return sum((dim - 1) * stride for dim, stride in zip(t.shape, t.stride()))


def sampled_softmax_stats(mu: torch.Tensor, sigma: torch.Tensor, seed: int,
                          *, n_samples: int, bits: str = "philox",
                          spatial: Optional[Sequence[int]] = None,
                          counter_rows: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on (N, M, C) ``mu`` and ``sigma`` of any strides; returns
    ``(sum_p (C, N), sum_ent (N,))`` float32, each summed over the M
    members and ``n_samples`` draws per member (module docstring)."""
    if mu.device.type == "cpu" and sigma.device.type == "cpu":
        return sampled_softmax_stats_reference(
            mu, sigma, seed, n_samples=n_samples, bits=bits,
            spatial=spatial, counter_rows=counter_rows)
    if mu.device.type != "cuda" or sigma.device != mu.device:
        raise ValueError(f"sampled_softmax_stats runs on one cuda device or "
                         f"the cpu, not {mu.device} and {sigma.device}")
    _check(mu, sigma, n_samples, bits)
    if mu.dtype != torch.float32 or sigma.dtype != torch.float32:
        raise TypeError(f"sampled_softmax_stats takes float32, not "
                        f"{mu.dtype} and {sigma.dtype}")
    n, m, c = mu.shape
    if max(_span(mu), _span(sigma), n * c) >= 2 ** 31:
        raise ValueError("sampled_softmax_stats indexes with 32-bit "
                         "offsets; an operand spans more than 2**31 "
                         "elements")
    key, geo, meta = _launch_args(n, m, c, seed, bits, spatial,
                                  counter_rows)
    sum_p = torch.empty((c, n), dtype=torch.float32, device=mu.device)
    sum_ent = torch.empty((n,), dtype=torch.float32, device=mu.device)
    triton, kernel, _ = _kernels()
    with torch.cuda.device(mu.device):
        kernel[(triton.cdiv(n, BLOCK),)](
            mu, sigma, sum_p, sum_ent, n, n_samples, *key, *mu.stride(),
            *sigma.stride(), *geo, num_warps=4, **meta)
    sampled_softmax_stats.launches += 1
    return sum_p, sum_ent


sampled_softmax_stats.launches = 0


def sample_bits(n: int, m: int, c: int, seed: int, *, n_samples: int,
                bits: str = "philox", spatial=None, counter_rows=None,
                device=None) -> torch.Tensor:
    """The bits K3 draws, (N, M, n_samples, C) int64 in [0, 2**32): on a
    CUDA ``device`` from the kernel's own bit source (a separate launch,
    not counted), else from :func:`sample_bits_reference`."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cpu":
        return sample_bits_reference(n, m, c, seed, n_samples=n_samples,
                                     bits=bits, spatial=spatial,
                                     counter_rows=counter_rows)
    if device.type != "cuda":
        raise ValueError(f"sample_bits runs on cuda or cpu, not {device}")
    if bits not in BITS:
        raise ValueError(f"bits={bits!r} is not one of {BITS}")
    if n * m * n_samples * c >= 2 ** 31:
        raise ValueError("sample_bits indexes with 32-bit offsets")
    key, geo, meta = _launch_args(n, m, c, seed, bits, spatial,
                                  counter_rows)
    out = torch.empty((n, m, n_samples, c), dtype=torch.int32, device=device)
    triton, _, kernel = _kernels()
    with torch.cuda.device(device):
        kernel[(triton.cdiv(n, BLOCK),)](out, n, n_samples, *key, *geo,
                                         num_warps=4, **meta)
    return out.to(torch.int64) & MASK32
