"""K2: one pass over a stack of samples giving mean softmax, PE, EE and MI.

Port of ``values_tpu/ops/pallas/entropy.py::_make_kernel`` (entry
``fused_entropy_pallas``) to a CUDA C++ kernel for Hopper
(``values_tpu_torch/csrc/entropy.cu``, built with K3 into one library).
For a stack (S, C, N) of S softmax samples over C classes at N voxels it
returns

- ``mean_softmax`` (C, N): m = (1/S) sum_s p_s;
- ``pred_entropy`` (N,): PE = -sum_c m log m;
- ``expected_entropy`` (N,): EE = -(1/S) sum_s sum_c p log p;
- ``mutual_information`` (N,): MI = PE - EE;

where a term with p == 0 counts 0. The sums run in float32.

Two forms: the probability form (the JAX kernel's contract; outputs in
the stack's type), and with ``logits=True`` the logits form, which takes
the forward's logits and applies the float32 softmax over C to each
sample first (outputs float32), so the scorer hands over its bf16 logits
with no cast and no softmax pass.

The kernel reads one layout of an (S, C, N) view, sample-major: each
sample's N*C values contiguous with the classes innermost (strides
(ss, 1, C), ss >= N*C), which is how the forward's grouped 1x1x1 head
leaves its logits. It stages contiguous runs through shared memory (see
the source for the design and what bounds it). The wrapper first copies
a stack of any other strides, or one not 16-byte aligned, into that
layout: one extra read and write of the stack, which the scorer's view
never pays.

Two regimes, chosen by :func:`plan` from (S, C, dtype): ``"tile"`` stages
256-voxel tiles in shared memory (up to 16 classes and 454 bytes of
samples a voxel); ``"stream"`` takes every other shape, each thread
streaming its voxel's samples from device memory, with the mean's running
sums in a float32 (C, N) buffer. Both take both forms and both types and
guard ``p log p`` alike.

:func:`fused_entropy` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
The library is built at the first launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from ..uncertainty import fused_sample_statistics
from .build import STATS_LIBRARY, STATS_SOURCES, load_library

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CLASSES = 16              # entropy.cu's kMaxC
TILE = 256                    # voxel rows a block stages (entropy.cu's kTile)
SMEM_LIMIT = 232448           # bytes of shared memory a block may use


def plan(s: int, c: int, dtype: torch.dtype) -> str:
    """K2's regime for a stack of S samples of C classes in ``dtype``:
    ``"tile"`` where two staged tiles of 256 voxels fit a block's shared
    memory and C is at most :data:`MAX_CLASSES`, else ``"stream"``."""
    if s < 1 or c < 1:
        raise ValueError(f"fused_entropy takes S >= 1 and C >= 1, not "
                         f"S={s} C={c}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    if c <= MAX_CLASSES and 2 * TILE * s * c * itemsize <= SMEM_LIMIT:
        return "tile"
    return "stream"


def fused_entropy_reference(stack: torch.Tensor, *, logits: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of K2 on an (S, C, N) stack: the port's
    :func:`values_tpu_torch.ops.uncertainty.fused_sample_statistics` in
    float32 (float64 for float64 input), returned in the stack's type;
    with ``logits``, of ``torch.softmax`` over C of the stack in that
    type, returned in that type."""
    compute = torch.float64 if stack.dtype == torch.float64 else torch.float32
    x = stack.to(compute)
    if logits:
        x = torch.softmax(x.movedim(1, -1), dim=-1).movedim(-1, 1)
    stats = fused_sample_statistics(x, class_axis=1)
    out = compute if logits else stack.dtype
    return {k: v.to(out) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load the K2 + K3 library; declare K2's
    entry."""
    lib = load_library(STATS_LIBRARY, STATS_SOURCES)
    fn = lib.fused_entropy_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
    fn = lib.fused_entropy_stream_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
    return lib


def _aligned_stride(stack: torch.Tensor) -> int:
    """N*C rounded up to a whole number of 16-byte chunks, in elements."""
    _, c, n = stack.shape
    per_chunk = 16 // stack.element_size()
    return -(-n * c // per_chunk) * per_chunk


def _sample_stride(stack: torch.Tensor) -> int:
    """The stride between samples, in elements, when ``stack`` is
    sample-major and the kernel can stage it as it is (strides (ss, 1, C)
    with ss >= N*C, every run 16-byte aligned); else 0."""
    s, c, n = stack.shape
    ss, sc, sn = stack.stride()
    if s == 1:                            # the stride is never used
        ss = _aligned_stride(stack)
    if (sc == 1 or c == 1) and (sn == c or n == 1) and ss >= n * c \
            and (ss * stack.element_size()) % 16 == 0 \
            and stack.data_ptr() % 16 == 0:
        return ss
    return 0


def fused_entropy(stack: torch.Tensor, *, logits: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """K2 on an (S, C, N) stack of probabilities, or of logits with
    ``logits=True`` (dict layout above). A CUDA stack that is not
    sample-major is first copied into that layout."""
    if stack.device.type == "cpu":
        return fused_entropy_reference(stack, logits=logits)
    if stack.device.type != "cuda":
        raise ValueError(f"fused_entropy runs on cuda or cpu, not "
                         f"{stack.device}")
    if stack.dtype not in _DTYPES:
        raise TypeError(f"fused_entropy takes float32 or bfloat16, not "
                        f"{stack.dtype}")
    if stack.ndim != 3:
        raise ValueError(f"stack: shape {tuple(stack.shape)} is not (S, C, N)")
    s, c, n = stack.shape
    if not (n >= 1 and n * c < 2 ** 31):
        raise ValueError(f"fused_entropy takes 1 to 2**31 - 1 values a "
                         f"sample, not C={c} x N={n}")
    regime = plan(s, c, stack.dtype)
    rows, sample_stride = stack, _sample_stride(stack)
    if sample_stride == 0:                # copy to (S, N, C), padded rows
        sample_stride = _aligned_stride(stack)
        rows = torch.empty((s, sample_stride), dtype=stack.dtype,
                           device=stack.device)
        rows[:, :n * c].view(s, n, c).copy_(stack.permute(0, 2, 1))
    out = torch.float32 if logits else stack.dtype
    mean = torch.empty((c, n), dtype=out, device=stack.device)
    pe, ee, mi = (torch.empty((n,), dtype=out, device=stack.device)
                  for _ in range(3))
    lib = load_kernel()
    flags = (int(stack.dtype == torch.bfloat16), int(logits))
    outs = (mean.data_ptr(), pe.data_ptr(), ee.data_ptr(), mi.data_ptr())
    with torch.cuda.device(stack.device):
        cuda_stream = torch.cuda.current_stream(stack.device).cuda_stream
        if regime == "tile":
            rc = lib.fused_entropy_launch(*flags, rows.data_ptr(), *outs, n,
                                          s, c, sample_stride, cuda_stream)
        else:   # the mean's float32 running sums
            acc = mean if out == torch.float32 else torch.empty(
                (c, n), dtype=torch.float32, device=stack.device)
            rc = lib.fused_entropy_stream_launch(
                *flags, rows.data_ptr(), acc.data_ptr(), *outs, n, s, c,
                sample_stride, cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_entropy launch failed with CUDA error {rc}")
    fused_entropy.launches += 1
    fused_entropy.regime_launches[regime] += 1
    return {"mean_softmax": mean, "pred_entropy": pe,
            "expected_entropy": ee, "mutual_information": mi}


fused_entropy.launches = 0
fused_entropy.regime_launches = {"tile": 0, "stream": 0}
