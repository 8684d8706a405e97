"""The SSN's sampling stage on the card: the capacitance of a batch of
low-rank normals and their softmaxed samples, as CUDA C++ kernels for
Hopper (``values_tpu_torch/csrc/ssn_sample.cu``, a library of its own).

It replaces no TPU kernel: the JAX package samples the SSN in XLA
(``values_tpu/models/ssn_unet3d.py::LowRankMVN``). For B low-rank normals
over N = C * HW logits (``mean`` and ``cov_diag`` D (B, N),
``cov_factor`` W (B, N, R), logit n = c * HW + p, any strides):

- :func:`capacitance` gives the (B, R, R) float32 ``I + W^T D^-1 W`` in
  one read of the factor and the diagonal, summed in a fixed order (no
  atomics); on CPU tensors its plain version,
  :func:`capacitance_reference`. :func:`cholesky_flags` is
  ``LowRankMVN.degenerate``'s rule on it (the float32 Cholesky fails or
  is not finite), and :func:`degenerate` the two, on the device;
- :func:`sample_softmax` gives the (S, B, C, HW)
  ``softmax_c(mean + W eps_r + sqrt(D) eps_d)`` from the normals ``eps_r``
  (S, B, R) and ``eps_d`` (S, B, N), leaving a flagged image's low-rank
  term out (skipped, so a non-finite factor leaves no NaN), in one pass
  that reads the factor, mean, diagonal and ``eps_d`` once and writes the
  samples once. It takes CUDA tensors only: its plain version is
  ``LowRankMVN.samples`` then ``torch.softmax``.

The kernels take float32 or float64 (the capacitance is float32 either
way, as ``LowRankMVN.degenerate`` forms it). :func:`plan` picks the lanes
that share a pixel from C. The library is built at the first launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...core import tracing
from .build import load_library

LIBRARY, SOURCES = "ssn_sample", ("ssn_sample.cu",)
MAX_RANK = 16                 # ssn_sample.cu's kMaxRank (the capacitance)
MAX_PER_THREAD = 8            # ssn_sample.cu's kMaxCpt
LANES = (1, 2, 4, 8, 16, 32)  # lanes that may share a pixel


def plan(classes: int) -> Tuple[int, int]:
    """(lanes a pixel, classes a lane) of the sample kernel for C
    classes: the fewest lanes that hold C at most
    :data:`MAX_PER_THREAD` classes each."""
    for lanes in LANES:
        per_thread = -(-classes // lanes)
        if classes >= 1 and per_thread <= MAX_PER_THREAD:
            return lanes, per_thread
    raise ValueError(f"the SSN sample kernel takes 1 to "
                     f"{LANES[-1] * MAX_PER_THREAD} classes, not {classes}")


def capacitance_reference(cov_diag: torch.Tensor, factor: torch.Tensor
                          ) -> torch.Tensor:
    """The plain version of :func:`capacitance`: ``I + (W / D)^T W`` in
    float32, outside autograd, from which ``LowRankMVN.degenerate`` takes
    its flags."""
    w = factor.detach().to(torch.float32)
    w_d = w / cov_diag.detach().to(torch.float32)[..., None]
    return torch.eye(w.shape[-1], dtype=torch.float32, device=w.device) \
        + w_d.transpose(1, 2) @ w


def cholesky_flags(cap: torch.Tensor) -> torch.Tensor:
    """(B,) bool: where the Cholesky of the (B, R, R) capacitance fails
    or is not finite."""
    chol, info = torch.linalg.cholesky_ex(cap)
    return (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the library; declare its entries."""
    lib = load_library(LIBRARY, SOURCES)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssn_capacitance_blocks.restype = i64
    lib.ssn_capacitance_blocks.argtypes = [i64]
    lib.ssn_capacitance_launch.restype = i32
    lib.ssn_capacitance_launch.argtypes = (
        [i32] + [ptr] * 4 + [i32, i64, i32] + [i64] * 5 + [ptr])
    lib.ssn_sample_softmax_launch.restype = i32
    lib.ssn_sample_softmax_launch.argtypes = (
        [i32] * 3 + [ptr] * 7 + [i32] * 3 + [i64, i32] + [i64] * 13 + [ptr])
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """1 where the tensors are float64, 0 where float32; raises unless
    they are all of one of the two types on one CUDA device."""
    device, dtype = tensors[0].device, tensors[0].dtype
    if device.type != "cuda":
        raise ValueError(f"{name} launches its kernels on CUDA tensors, not "
                         f"{device} ones")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name} runs on one device, not {device} and "
                             f"{t.device}")
        if t.dtype != dtype or dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} takes float32 or float64 tensors of one "
                            f"type, not {dtype} and {t.dtype}")
    return int(dtype == torch.float64)


def _rank_shapes(cov_diag: torch.Tensor, factor: torch.Tensor
                 ) -> Tuple[int, int, int]:
    if cov_diag.ndim != 2 or factor.ndim != 3 \
            or tuple(factor.shape[:2]) != tuple(cov_diag.shape):
        raise ValueError(f"cov_diag (B, N) and cov_factor (B, N, R) do not "
                         f"match: {tuple(cov_diag.shape)}, "
                         f"{tuple(factor.shape)}")
    b, n, r = factor.shape
    return b, n, r


def capacitance(cov_diag: torch.Tensor, factor: torch.Tensor
                ) -> torch.Tensor:
    """(B, R, R) float32 ``I + W^T D^-1 W`` of ``cov_diag`` (B, N) and
    ``factor`` (B, N, R), any strides."""
    b, n, r = _rank_shapes(cov_diag, factor)
    if factor.device.type == "cpu" and cov_diag.device.type == "cpu":
        return capacitance_reference(cov_diag, factor)
    double = _check_cuda("capacitance", factor, cov_diag)
    if not 1 <= r <= MAX_RANK or n == 0:
        raise ValueError(f"the capacitance kernel takes ranks 1 to "
                         f"{MAX_RANK} over N >= 1, not R={r}, N={n}")
    lib = load_kernel()
    blocks = lib.ssn_capacitance_blocks(n)
    partial = torch.empty((b, blocks, r * (r + 1) // 2), dtype=torch.float32,
                          device=factor.device)
    cap = torch.empty((b, r, r), dtype=torch.float32, device=factor.device)
    with torch.cuda.device(factor.device):
        rc = lib.ssn_capacitance_launch(
            double, factor.data_ptr(), cov_diag.data_ptr(), partial.data_ptr(),
            cap.data_ptr(), b, n, r, *factor.stride(), *cov_diag.stride(),
            torch.cuda.current_stream(factor.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the capacitance launch failed with CUDA error "
                           f"{rc}")
    capacitance.launches += 1
    return cap


capacitance.launches = 0


def degenerate(cov_diag: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """(B,) bool flags of :func:`capacitance` by :func:`cholesky_flags`,
    on the tensors' device."""
    return cholesky_flags(capacitance(cov_diag, factor))


def sample_softmax(mean: torch.Tensor, cov_diag: torch.Tensor,
                   factor: torch.Tensor, degenerate: torch.Tensor,
                   eps_r: torch.Tensor, eps_d: torch.Tensor,
                   classes: int) -> torch.Tensor:
    """(S, B, C, N // C) softmax over C of the samples ``mean + W eps_r +
    sqrt(D) eps_d``, without the low-rank term where ``degenerate`` (B,)
    is set; ``eps_r`` (S, B, R), ``eps_d`` (S, B, N), any strides; CUDA
    tensors of one type, float32 or float64. Counts ``ssn_fused_samples``
    (S x B)."""
    b, n, r = _rank_shapes(cov_diag, factor)
    s = eps_d.shape[0]
    if (tuple(mean.shape) != (b, n) or tuple(eps_r.shape) != (s, b, r)
            or tuple(eps_d.shape) != (s, b, n)
            or tuple(degenerate.shape) != (b,)):
        raise ValueError(f"mean {tuple(mean.shape)}, eps_r "
                         f"{tuple(eps_r.shape)}, eps_d {tuple(eps_d.shape)} "
                         f"and degenerate {tuple(degenerate.shape)} do not "
                         f"fit cov_factor {tuple(factor.shape)}")
    if classes < 1 or n % classes:
        raise ValueError(f"N={n} logits are not a whole number of "
                         f"{classes} class maps")
    double = _check_cuda("sample_softmax", mean, cov_diag, factor, eps_r,
                         eps_d)
    if degenerate.device != mean.device or degenerate.dtype != torch.bool:
        raise TypeError(f"degenerate is a bool tensor on {mean.device}, not "
                        f"{degenerate.dtype} on {degenerate.device}")
    lanes, per_thread = plan(classes)
    hw = n // classes
    out = torch.empty((s, b, classes, hw), dtype=mean.dtype,
                      device=mean.device)
    deg = degenerate.contiguous()
    lib = load_kernel()
    with torch.cuda.device(mean.device):
        rc = lib.ssn_sample_softmax_launch(
            double, lanes, per_thread, mean.data_ptr(), cov_diag.data_ptr(),
            factor.data_ptr(), deg.data_ptr(), eps_r.data_ptr(),
            eps_d.data_ptr(), out.data_ptr(), s, b, classes, hw, r,
            *mean.stride(), *cov_diag.stride(), *factor.stride(),
            *eps_r.stride(), *eps_d.stride(),
            torch.cuda.current_stream(mean.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the SSN sample launch failed with CUDA error "
                           f"{rc}")
    sample_softmax.launches += 1
    tracing.count("ssn_fused_samples", s * b)
    return out


sample_softmax.launches = 0
