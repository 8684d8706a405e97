"""The aleatoric-logit-sampling ensemble of the ValUES 3D test bed
(``test_3D.py``'s aleatoric loop; the UNet3D's ``final_aleatoric`` head of
``unet3D_module.py``), scored per volume, in plain torch.

Each member's ``final_aleatoric`` head gives 2C channels over the volume:
mu (the first C) and s, the log-variance (the last C). A sample's logits
are ``mu + exp(s / 2) z`` with z standard normal per (voxel, member,
sample, class); the softmax and its entropy are accumulated over members
x samples, and the mean softmax, PE, EE and MI feed the same Dice and
three aggregations as :func:`.measures.volume_scores`.

The normals are the program's: the bits K3 draws, formed here by a copy
of the program's plain Philox (``values_tpu_torch/ops/kernels/
sampling.py``, its ``"philox"`` bit source): Philox4x32-10 with key (seed
mod 2**32, seed >> 32) and counter (voxel, member, j // 4, 0), j =
sample * C + class, the draw taking word j mod 4; the top 24 bits give u
= top * 2**-24 + 2**-26, and Acklam's inverse normal CDF gives z.

Departures from the published description: the normals come from those
bits, not from ``torch.randn``; Acklam's approximation (relative error
below 1.15e-9) stands in for the exact quantile, evaluated here in
float64 where the program evaluates it in float32; the forward runs in
float32 with TF32 and cuDNN off (the caller's
:func:`benchmark.reference.exact`), everything after it in float64.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from . import measures
from . import unet3d

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10
# Acklam's inverse normal CDF
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


def heads(sd: Dict[str, torch.Tensor], x: torch.Tensor, quantize=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, s), each (B, C, D, H, W), of the plain UNet3D with its
    ``final_aleatoric`` head in place of ``final``."""
    out = unet3d.forward(dict(sd, **{
        "final.weight": sd["final_aleatoric.weight"],
        "final.bias": sd["final_aleatoric.bias"]}), x, quantize)
    return torch.chunk(out, 2, dim=1)


# -- the bits: uint32 values in int64 tensors, reduced mod 2**32 ------------

def _mul_hilo(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of x * k for x in [0, 2**32), the
    multiplier taken in 16-bit halves so that no product leaves int64."""
    p0 = x * (k & 0xFFFF)
    p1 = x * (k >> 16)
    t = ((p1 & 0xFFFF) << 16) + p0
    return (p1 >> 16) + (t >> 32), t & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words under the key (k0, k1)."""
    c0, c1, c2, c3 = (torch.as_tensor(c) & MASK32 for c in (c0, c1, c2, c3))
    k0, k1 = k0 & MASK32, k1 & MASK32
    for _ in range(PHILOX_ROUNDS):
        hi0, lo0 = _mul_hilo(c0, PHILOX_M0)
        hi1, lo1 = _mul_hilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def inverse_normal_cdf(u: torch.Tensor) -> torch.Tensor:
    """Acklam's rational approximation of the standard normal quantile,
    in u's type: the central branch, or a tail's below PLOW or above
    1 - PLOW."""
    a, b, c, d = _A, _B, _C, _D
    q = u - 0.5
    r = q * q
    central = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
               * r + a[5]) * q / (
        ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0)

    def tail(p):
        t = torch.sqrt(-2.0 * torch.log(torch.clamp(p, max=0.5)))
        return (((((c[0] * t + c[1]) * t + c[2]) * t + c[3]) * t + c[4])
                * t + c[5]) / ((((d[0] * t + d[1]) * t + d[2]) * t + d[3])
                               * t + 1.0)
    return torch.where(u < PLOW, tail(u),
                       torch.where(u > 1.0 - PLOW, -tail(1.0 - u), central))


def normals(seed: int, n: int, members: int, samples: int, classes: int,
            device):
    """Yields (member, sample, z (N, C) float64) of every draw, member by
    member."""
    seed = int(seed) & (2 ** 64 - 1)
    k0, k1 = seed & MASK32, seed >> 32
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    for m in range(members):
        words = {}
        for i in range(samples):
            bits = []
            for c in range(classes):
                g, word = divmod(i * classes + c, 4)
                if g not in words:
                    words.clear()
                    words[g] = philox4x32(idx, zero + m, zero + g, zero,
                                          k0, k1)
                bits.append(words[g][word])
            top = torch.stack(bits, dim=1) >> 8
            u = top.double() * 2.0 ** -24 + 2.0 ** -26
            yield m, i, inverse_normal_cdf(u)


def sampled_statistics(variants: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       seed: int, samples: int) -> List[Dict]:
    """For each variant's (mu, s), both (M, N, C): the C2 statistics over
    members x ``samples`` draws, all variants sharing each draw's z; the
    maps (N,) and the mean softmax (N, C), float64."""
    m, n, c = variants[0][0].shape
    sums = [[torch.zeros((n, c), dtype=torch.float64, device=mu.device),
             torch.zeros((n,), dtype=torch.float64, device=mu.device)]
            for mu, _ in variants]
    sigmas = [torch.exp(s.double() / 2.0) for _, s in variants]
    for im, _, z in normals(seed, n, m, samples, c, variants[0][0].device):
        for (mu, _), sigma, acc in zip(variants, sigmas, sums):
            p = torch.softmax(mu[im].double() + sigma[im] * z, dim=-1)
            acc[0] += p
            acc[1] += measures.entropy(p, -1)
    out = []
    for sum_p, sum_e in sums:
        mean = sum_p / (m * samples)
        pe = measures.entropy(mean, -1)
        ee = sum_e / (m * samples)
        out.append({"mean_softmax": mean, "pred_entropy": pe,
                    "expected_entropy": ee, "mutual_information": pe - ee})
    return out


def volume_scores(stats: Dict, raters: torch.Tensor, *, agg_patch: int,
                  threshold: float, ignore_index: int) -> torch.Tensor:
    """The statistics of a (B, D, H, W) batch, voxels flattened in that
    order, and (B, R, D, H, W) rater maps -> the (10, B) scores of
    :func:`.measures.volume_scores`."""
    spatial = raters.shape[:1] + raters.shape[2:]
    seg = stats["mean_softmax"].argmax(-1).reshape(spatial)
    rows = [measures.volume_dice(seg, raters.long(), ignore_index)]
    for key in measures.MAPS:
        unc = stats[key].reshape(spatial)
        rows += [measures.patch_level(unc, agg_patch), unc.flatten(1).sum(1),
                 measures.threshold_mean(unc, threshold)]
    return torch.stack(rows)
