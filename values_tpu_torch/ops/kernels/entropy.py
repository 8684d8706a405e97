"""K2: one pass over a softmax stack giving mean softmax, PE, EE and MI.

Port of ``values_tpu/ops/pallas/entropy.py::_make_kernel`` (entry
``fused_entropy_pallas``) to a Triton kernel. For a stack (S, C, N) of S
softmax samples over C classes at N voxels it returns

- ``mean_softmax`` (C, N): m = (1/S) sum_s p_s;
- ``pred_entropy`` (N,): PE = -sum_c m log m;
- ``expected_entropy`` (N,): EE = -(1/S) sum_s sum_c p log p;
- ``mutual_information`` (N,): MI = PE - EE;

where a term with p == 0 counts 0. Outputs have the stack's type; the
sums run in float32.

What bounds it on an H100: it reads S*C values and writes C+3 per voxel
and does a few dozen operations per value, so it is bound by memory
bytes. Each program loads a block of voxels for all S*C (sample, class)
pairs once and keeps the sums in registers, so every input byte is read
once and every output byte written once. The wrapper passes strides, so
the scorer hands over a permuted view of its channels-last (N, S, C)
softmax without a copy.

:func:`fused_entropy` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
``triton`` is imported only when the kernel is launched.
"""
from __future__ import annotations

import functools
import os
from typing import Dict

import torch

from ..uncertainty import fused_sample_statistics
from .build import BUILD_DIR

BLOCK = 1024
_DTYPES = (torch.float32, torch.bfloat16)


def fused_entropy_reference(stack: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of K2 on an (S, C, N) stack: the port's
    :func:`values_tpu_torch.ops.uncertainty.fused_sample_statistics` in
    float32 (float64 for float64 input), returned in the stack's type."""
    compute = torch.float64 if stack.dtype == torch.float64 else torch.float32
    stats = fused_sample_statistics(stack.to(compute), class_axis=1)
    return {k: v.to(stack.dtype) for k, v in stats.items()}


@functools.lru_cache(maxsize=None)
def _kernel():
    # keep Triton's compile cache beside the CUDA builds, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def fused_entropy_kernel(stack_ptr, mean_ptr, pe_ptr, ee_ptr, mi_ptr, n,
                             stride_s, stride_c, stride_n,
                             S: tl.constexpr, C: tl.constexpr,
                             BLOCK_N: tl.constexpr):
        offs = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        mask = offs < n
        inv_s = 1.0 / S
        pe = tl.zeros([BLOCK_N], dtype=tl.float32)
        ee = tl.zeros([BLOCK_N], dtype=tl.float32)
        for c in tl.static_range(C):
            m = tl.zeros([BLOCK_N], dtype=tl.float32)
            for s in tl.static_range(S):
                p = tl.load(stack_ptr + s * stride_s + c * stride_c
                            + offs * stride_n, mask=mask, other=0.0
                            ).to(tl.float32)
                m += p * inv_s
                ee += tl.where(p > 0, p * tl.log(tl.where(p > 0, p, 1.0)),
                               0.0)
            tl.store(mean_ptr + c * n + offs,
                     m.to(mean_ptr.dtype.element_ty), mask=mask)
            pe += tl.where(m > 0, m * tl.log(tl.where(m > 0, m, 1.0)), 0.0)
        pe = -pe
        ee = -(ee * inv_s)
        out_ty = pe_ptr.dtype.element_ty
        tl.store(pe_ptr + offs, pe.to(out_ty), mask=mask)
        tl.store(ee_ptr + offs, ee.to(out_ty), mask=mask)
        tl.store(mi_ptr + offs, (pe - ee).to(out_ty), mask=mask)

    return triton, fused_entropy_kernel


def fused_entropy(stack: torch.Tensor) -> Dict[str, torch.Tensor]:
    """K2 on an (S, C, N) stack of any strides (dict layout above)."""
    if stack.device.type == "cpu":
        return fused_entropy_reference(stack)
    if stack.device.type != "cuda":
        raise ValueError(f"fused_entropy runs on cuda or cpu, not "
                         f"{stack.device}")
    if stack.dtype not in _DTYPES:
        raise TypeError(f"fused_entropy takes float32 or bfloat16, not "
                        f"{stack.dtype}")
    if stack.ndim != 3:
        raise ValueError(f"stack: shape {tuple(stack.shape)} is not (S, C, N)")
    s, c, n = stack.shape
    last = sum((dim - 1) * stride
               for dim, stride in zip(stack.shape, stack.stride()))
    if last >= 2 ** 31:
        raise ValueError("fused_entropy indexes with 32-bit offsets; the "
                         "stack spans more than 2**31 elements")
    mean = torch.empty((c, n), dtype=stack.dtype, device=stack.device)
    pe, ee, mi = (torch.empty((n,), dtype=stack.dtype, device=stack.device)
                  for _ in range(3))
    triton, kernel = _kernel()
    with torch.cuda.device(stack.device):
        kernel[(triton.cdiv(n, BLOCK),)](
            stack, mean, pe, ee, mi, n, *stack.stride(), S=s, C=c,
            BLOCK_N=BLOCK, num_warps=4)
    fused_entropy.launches += 1
    return {"mean_softmax": mean, "pred_entropy": pe,
            "expected_entropy": ee, "mutual_information": mi}


fused_entropy.launches = 0
