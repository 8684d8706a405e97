"""K3: streaming sampled-softmax statistics (the aleatoric tail).

Port of ``values_tpu/ops/pallas/sampling.py::_sample_stats_kernel``
(entry ``sampled_softmax_stats``) to a CUDA C++ kernel for Hopper
(``values_tpu_torch/csrc/sampling.cu``, built with K2 into one library).
For the heads of M members at N voxels over C classes it draws
``n_samples`` logit samples per member, ``logits = mu + sigma * z`` with
z ~ N(0, 1), and returns

- ``sum_p`` (C, N): the sum over members x samples of softmax(logits);
- ``sum_ent`` (N,): the sum of the per-sample entropies
  ``-sum_c p log p`` (log-sum-exp form: log p = logits - lse, so an
  underflowing p contributes exactly 0).

Both are float32, and :func:`values_tpu_torch.inference.scoring.
streaming_finalize` turns them into the C2 statistics with
``n = M * n_samples``. ``sum_p`` has the (C, N) layout of K2's
``mean_softmax``, so the scorer's tail takes it unchanged. The scale is
given as ``sigma``, or as the head's log-variance ``log_var`` (sigma =
exp(log_var / 2) in float32); mu and the scale are float32 or bfloat16
(N, M, C) views of any strides, so the scorer hands over its bf16 head.

The draw: uint32 bits -> :func:`uniform_from_bits` (top 24 bits) ->
Acklam's :func:`inverse_normal_cdf`. Two bit sources:

- ``"philox"`` (default; it takes the place of the TPU's hardware PRNG):
  Philox4x32-10 with key (seed mod 2**32, seed >> 32 mod 2**32) and
  counter (voxel n, member m, j // 4, 0) with j = i * C + c; draw (i, c)
  takes output word j mod 4, so every word of a call is used. An
  element's bits depend on (seed, n, m, i, c) only, never on the block
  size or the grid.
- ``"counter"``: the JAX package's ``counter_bits`` murmur3-finalizer
  hash, indexed as the JAX kernel indexes its packed tiles (batch pack
  ``bp = 128 // W``, D-blocks of ``counter_rows`` rows), so the port
  reproduces ``sampled_softmax_stats(bits_source="counter")`` draw for
  draw on NDHWC tensors. It needs ``spatial=(D, H, W)`` with
  ``128 % W == 0`` and ``D % counter_rows == 0``.

:func:`plan` picks one of three kernels from C: the two-class one, the
general one up to 8 classes (accumulators in registers), and above 8 one
that holds each thread's per-class values (logits, mu, scale, sums) in
shared memory; all three draw the same bits for (voxel, member, sample,
class).

The kernel evaluates Acklam's central branch with every product and sum
rounded (``__fmul_rn``/``__fadd_rn``): it cancels some 180-fold near its
edges in float32, so a fused evaluation would move z by up to 3e-4 from
the plain version and the JAX float32 form, which round each step
(:func:`inverse_normal_cdf`). The rest of the kernel contracts freely.
Its design and what bounds it on an H100 (the SFU) are in the source.

:func:`sampled_softmax_stats` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; it never falls back from one to
the other. The library is built at the first launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ...core.device import resolve_device
from .build import STATS_LIBRARY, STATS_SOURCES, load_library

BITS = ("philox", "counter")
MAX_CLASSES = 8               # sampling.cu's kMaxC
LANES = 128
BLOCK = 256
SMEM_LIMIT = 232448           # bytes of shared memory a block may use
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
    multiply-adds by as much the other way; the kernel therefore rounds
    every step of the central branch, so both round alike."""
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

    k0, k1 = seed & MASK32, seed >> 32
    zero = torch.zeros_like(idx)
    held = {}

    def draw(im, i):
        out = torch.empty((n, c), dtype=torch.int64, device=device)
        for cls in range(c):
            g, word = divmod(i * c + cls, 4)
            if held.get("at") != (im, g):
                held.update(at=(im, g), words=philox4x32(
                    idx, zero + im, zero + g, zero, k0, k1))
            out[:, cls] = held["words"][word]
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


def _scale(mu: torch.Tensor, sigma: Optional[torch.Tensor],
           log_var: Optional[torch.Tensor], n_samples: int, bits: str
           ) -> Tuple[torch.Tensor, bool]:
    """Check a call; returns (the scale tensor, whether it is log_var)."""
    if bits not in BITS:
        raise ValueError(f"bits={bits!r} is not one of {BITS}")
    if (sigma is None) == (log_var is None):
        raise ValueError("pass exactly one of sigma and log_var")
    scale = sigma if log_var is None else log_var
    if mu.ndim != 3 or tuple(scale.shape) != tuple(mu.shape):
        raise ValueError(f"mu {tuple(mu.shape)} and the scale "
                         f"{tuple(scale.shape)} must both be (N, M, C)")
    if n_samples < 1:
        raise ValueError(f"n_samples={n_samples} must be at least 1")
    return scale, log_var is not None


def sampled_softmax_stats_reference(mu: torch.Tensor,
                                    sigma: Optional[torch.Tensor], seed: int,
                                    *, n_samples: int,
                                    log_var: Optional[torch.Tensor] = None,
                                    bits: str = "philox", spatial=None,
                                    counter_rows=None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K3, member by member and sample by
    sample in float32 (float64 for float64 input): the same bits, draws
    and log-sum-exp terms as the kernel; with ``log_var``, sigma =
    exp(log_var / 2) in that type, as the scorer once formed it."""
    scale, is_log_var = _scale(mu, sigma, log_var, n_samples, bits)
    n, m, c = mu.shape
    compute = torch.float64 if mu.dtype == torch.float64 else torch.float32
    sigma = (torch.exp(scale.to(compute) / 2.0) if is_log_var
             else scale.to(compute))
    draw = _bit_source(n, m, c, seed, n_samples=n_samples, bits=bits,
                       spatial=spatial, counter_rows=counter_rows,
                       device=mu.device)
    sum_p = torch.zeros((n, c), dtype=compute, device=mu.device)
    sum_e = torch.zeros((n,), dtype=compute, device=mu.device)
    for im in range(m):
        mu_m, sig_m = mu[:, im].to(compute), sigma[:, im]
        for i in range(n_samples):
            z = inverse_normal_cdf(uniform_from_bits(draw(im, i)))
            p, ent = entropy_terms(mu_m + sig_m * z.to(compute))
            sum_p += p
            sum_e += ent
    return sum_p.t().contiguous(), sum_e


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the K2 + K3 library; declare K3's
    entries."""
    lib = load_library(STATS_LIBRARY, STATS_SOURCES)
    ptr, i32, u32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_longlong)
    lib.sampled_stats_launch.restype = i32
    lib.sampled_stats_launch.argtypes = (
        [i32] * 4 + [ptr] * 4 + [i32] * 4 + [u32] * 2 + [i64] * 6
        + [i32] * 4 + [ptr])
    lib.sample_bits_launch.restype = i32
    lib.sample_bits_launch.argtypes = ([i32] * 2 + [ptr] + [i32] * 4
                                       + [u32] * 2 + [i32] * 4 + [ptr])
    return lib


def plan(c: int, block: int = BLOCK) -> Tuple[str, int]:
    """K3's kernel for C classes and its block: ``"two_class"`` at C = 2,
    ``"registers"`` up to :data:`MAX_CLASSES` (C + 1 accumulators a
    thread), ``"shared"`` above (4 C floats a thread in shared memory: a
    sample's logits, the member's mu and scale, the sums; the block
    halved until they fit). Raises where even 32 threads' overflow a
    block's shared memory."""
    if c < 1:
        raise ValueError(f"sampled_softmax_stats takes C >= 1, not {c}")
    if c == 2:
        return "two_class", block
    if c <= MAX_CLASSES:
        return "registers", block
    while block > 32 and 16 * block * c > SMEM_LIMIT:
        block //= 2
    if 16 * block * c > SMEM_LIMIT:
        raise ValueError(f"sampled_softmax_stats takes at most "
                         f"{SMEM_LIMIT // (32 * 16)} classes, not {c}")
    return "shared", block


def _launch_geometry(n: int, m: int, c: int, seed: int, bits: str, spatial,
                     counter_rows):
    """The key words and the counter geometry (ones in Philox mode)."""
    seed = int(seed) & (2 ** 64 - 1)
    geo = (1, 1, 1, 1)
    if bits == "counter":
        geo = _counter_geometry(n, m, c, spatial, counter_rows)[1:]
    return (seed & MASK32, seed >> 32), geo


def sampled_softmax_stats(mu: torch.Tensor, sigma: Optional[torch.Tensor],
                          seed: int, *, n_samples: int,
                          log_var: Optional[torch.Tensor] = None,
                          bits: str = "philox",
                          spatial: Optional[Sequence[int]] = None,
                          counter_rows: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on (N, M, C) ``mu`` and one scale of the same shape, ``sigma``
    or ``log_var`` (pass the other as None), any strides, float32 or
    bfloat16 (one type for both); returns ``(sum_p (C, N), sum_ent
    (N,))`` float32, each summed over the M members and ``n_samples``
    draws per member (module docstring)."""
    scale, is_log_var = _scale(mu, sigma, log_var, n_samples, bits)
    if mu.device.type == "cpu" and scale.device.type == "cpu":
        return sampled_softmax_stats_reference(
            mu, sigma, seed, n_samples=n_samples, log_var=log_var,
            bits=bits, spatial=spatial, counter_rows=counter_rows)
    if mu.device.type != "cuda" or scale.device != mu.device:
        raise ValueError(f"sampled_softmax_stats runs on one cuda device or "
                         f"the cpu, not {mu.device} and {scale.device}")
    if mu.dtype not in (torch.float32, torch.bfloat16) \
            or scale.dtype != mu.dtype:
        raise TypeError(f"sampled_softmax_stats takes float32 or bfloat16 "
                        f"(one type for mu and the scale), not {mu.dtype} "
                        f"and {scale.dtype}")
    n, m, c = mu.shape
    regime, block = plan(c, BLOCK)
    if n == 0 or n * c >= 2 ** 31:
        raise ValueError(f"sampled_softmax_stats writes 1 to 2**31 - 1 "
                         f"values of sum_p, not N={n} x C={c}")
    key, geo = _launch_geometry(n, m, c, seed, bits, spatial, counter_rows)
    sum_p = torch.empty((c, n), dtype=torch.float32, device=mu.device)
    sum_ent = torch.empty((n,), dtype=torch.float32, device=mu.device)
    lib = load_kernel()
    with torch.cuda.device(mu.device):
        rc = lib.sampled_stats_launch(
            int(mu.dtype == torch.bfloat16), int(is_log_var),
            int(bits == "counter"), block,
            mu.data_ptr(), scale.data_ptr(), sum_p.data_ptr(),
            sum_ent.data_ptr(), n, m, c, n_samples, *key, *mu.stride(),
            *scale.stride(), *geo,
            torch.cuda.current_stream(mu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sampled_softmax_stats launch failed with CUDA "
                           f"error {rc}")
    sampled_softmax_stats.launches += 1
    sampled_softmax_stats.regime_launches[regime] += 1
    return sum_p, sum_ent


sampled_softmax_stats.launches = 0
sampled_softmax_stats.regime_launches = {"two_class": 0, "registers": 0,
                                         "shared": 0}


def sample_bits(n: int, m: int, c: int, seed: int, *, n_samples: int,
                bits: str = "philox", spatial=None, counter_rows=None,
                device=None) -> torch.Tensor:
    """The bits K3 draws, (N, M, n_samples, C) int64 in [0, 2**32): on a
    CUDA ``device`` (``None``: the card) from the kernel's own bit source
    (a separate launch, not counted), on the CPU from
    :func:`sample_bits_reference`."""
    device = resolve_device(device)
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
    key, geo = _launch_geometry(n, m, c, seed, bits, spatial, counter_rows)
    out = torch.empty((n, m, n_samples, c), dtype=torch.int32, device=device)
    lib = load_kernel()
    with torch.cuda.device(device):
        rc = lib.sample_bits_launch(
            int(bits == "counter"), BLOCK, out.data_ptr(), n, m, c,
            n_samples, *key, *geo,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sample_bits launch failed with CUDA error {rc}")
    return out.to(torch.int64) & MASK32
