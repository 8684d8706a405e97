"""Work counted from shapes for the sampled cells: the SSN's sampling
stage and factor head, and K3's operations and bytes.

Frozen with the benchmark, as :mod:`.flops` is, so a per-layer metric
reads the same work whatever implements the stage.

- The SSN sampling stage (span ``test2d.ssn_sample``) must read the mean,
  the diagonal and the factor once and write S softmaxed samples, float32:
  4 B N (2 + R + S) bytes, N = C H W.
- The factor head runs at the trunk's quarter size (two stride-2 3x3
  convs): a 1x1 conv of the concatenated branches onto themselves and a
  1x1 conv onto C x R channels, 2 x MACs each.
- K3 (``chip_smoke.py::k3_operations``): per (voxel, member, sample) draw
  group of C classes, counting an FMA as 2 and each compare, select,
  integer op, exp, log, sqrt and division as 1: Philox's 21 a class (80
  for 4 words, and placing the word), the uniform's 4, the inverse CDF's
  branch test 2 and the branch that applies (central 24, a tail 27, a
  tail at the share 2 PLOW of draws), the logit's FMA 2, the softmax and
  entropy 9 C - 1; and per (voxel, member, class) the exp and halving
  that form sigma from the log-variance. It reads the bfloat16 head (mu
  and s) once and writes C + 1 float32 sums a voxel.
"""
from __future__ import annotations

from .flops import PEAK_BYTES, PEAK_FLOPS, least_seconds

FLOAT32 = 4
BFLOAT16 = 2
ACKLAM_CENTRAL, ACKLAM_TAIL = 24, 27
ACKLAM_TAIL_SHARE = 2 * 0.02425


def _stride2(n: int) -> int:
    """The side after a stride-2 3x3 conv with padding 1."""
    return (n - 1) // 2 + 1


def ssn_sample_bytes(batch: int, classes: int, height: int, width: int,
                     rank: int, samples: int) -> float:
    """The sampling stage's float32 bytes for one member's batch."""
    return FLOAT32 * batch * classes * height * width * (2 + rank + samples)


def ssn_sample_least_seconds(batch: int, classes: int, height: int,
                             width: int, rank: int, samples: int) -> float:
    """The stage's bytes at the chip's peak bandwidth."""
    return ssn_sample_bytes(batch, classes, height, width, rank,
                            samples) / PEAK_BYTES


def ssn_factor_head_flops(height: int, width: int, channels: int,
                          classes: int, rank: int) -> float:
    """Operations of ``cov_factor_conv`` for one image of height x width
    over ``channels`` trunk channels."""
    pixels = _stride2(_stride2(height)) * _stride2(_stride2(width))
    return 2.0 * pixels * channels * (channels + classes * rank)


def k3_operations(n: int, members: int, classes: int, samples: int
                  ) -> float:
    """K3's operations with Philox bits and the log-variance head."""
    normal = (2 + (1 - ACKLAM_TAIL_SHARE) * ACKLAM_CENTRAL
              + ACKLAM_TAIL_SHARE * ACKLAM_TAIL)
    per_group = 21 * classes + classes * (4 + normal + 2) + 9 * classes - 1
    return n * members * (samples * per_group + 2 * classes)


def k3_bytes(n: int, members: int, classes: int) -> float:
    """The bfloat16 mu and s read once, the float32 sums written once."""
    return (BFLOAT16 * 2 * n * members * classes
            + FLOAT32 * (classes * n + n))


def k3_least_seconds(n: int, members: int, classes: int, samples: int
                     ) -> float:
    """K3's bound: its operations on the CUDA cores' float32 peak."""
    return least_seconds(k3_bytes(n, members, classes),
                         k3_operations(n, members, classes, samples),
                         PEAK_FLOPS["float32"])


def is_k3(name: str) -> bool:
    """K3's sampling kernels, as the profiler names them (not the bits
    kernel, which the scorer never launches)."""
    return "sampled_stats" in name
