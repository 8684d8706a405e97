"""K1: the fused grouped 3x3x3 convolution, NDHWC.

Port of ``values_tpu/ops/pallas/conv3d.py::_conv_kernel`` (entry
``conv3d_banded_packed``) to a hand-written CUDA kernel
(``values_tpu_torch/csrc/conv3d_fused.cu``). The TPU kernel's batch-packed
lanes and banded weights are TPU layout and are not ported: tensors here
are plain NDHWC and the weight is the grouped DHWIO kernel of
:func:`values_tpu_torch.models.torch_import.group_member_state_dicts`.

The contract, per group g of ``groups`` (``conv3d_fused_reference``):

1. ``v = concat(x[g], x2[g])`` along the group's channels;
2. optional prologue ``u = v*scale - shift; max(u, u*slope)`` with
   per-(item, channel) maps of shape (B, G*Cin), rounded to the input
   type; voxels outside the volume stay exactly 0 (SAME padding);
3. the 3x3x3 SAME convolution with f32 accumulation, plus bias;
4. optional ``(sum, sumsq)`` of that pre-activation value per (item,
   channel), shape (B, G*Cout), float32;
5. activation none / leaky (0.01) / relu, output in the input type.

:func:`conv3d_fused` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.

K1b, the training form (:func:`conv3d_fused_train`, the autograd
:class:`Conv3dFusedFn`), is the port of the custom VJP around the TPU
kernel (``conv3d.py::_banded_packed_ad`` and ``_banded_packed_ad_stats``,
:888-1208). Its forward is K1 without ``x2`` or prologue; its backward
runs K1 again for dx. Autograd through :func:`conv3d_fused_reference` is
its plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .build import load_library

ACTIVATIONS = {"none": 0, "leaky": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SOURCES = ("conv3d_fused.cu",)

Prologue = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _apply_activation(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return torch.where(y > 0, y, 0.01 * y)
    if activation == "relu":
        return torch.clamp(y, min=0.0)
    return y


def concat_groups(x: torch.Tensor, x2: torch.Tensor, groups: int
                  ) -> torch.Tensor:
    """Per-group channel concat of two NDHWC tensors: group g's channels
    become [x's block g, x2's block g]."""
    lead = x.shape[:-1]
    return torch.cat([x.reshape(*lead, groups, -1),
                      x2.reshape(*lead, groups, -1)], dim=-1
                     ).reshape(*lead, -1)


def conv3d_fused_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           groups: int = 1, *,
                           x2: Optional[torch.Tensor] = None,
                           prologue: Optional[Prologue] = None,
                           activation: str = "none",
                           emit_stats: bool = False):
    """The plain PyTorch version of K1, written from the contract above.
    Computes in float32 (float64 for float64 input); returns ``out`` or
    ``(out, (sum, sumsq))``."""
    compute = torch.float64 if x.dtype == torch.float64 else torch.float32
    v = x if x2 is None else concat_groups(x, x2, groups)
    if prologue is not None:
        scale, shift, slope = (m.to(compute)[:, None, None, None, :]
                               for m in prologue)
        u = v.to(compute) * scale - shift
        v = torch.maximum(u, u * slope).to(x.dtype)
    w = weight.to(compute).permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    b = None if bias is None else bias.to(compute)
    y = F.conv3d(v.to(compute).permute(0, 4, 1, 2, 3), w, b, padding=1,
                 groups=groups).permute(0, 2, 3, 4, 1)
    out = _apply_activation(y, activation).to(x.dtype)
    if not emit_stats:
        return out
    return out, (y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3)))


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conv3d_fused(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, groups: int = 1, *,
                 x2: Optional[torch.Tensor] = None,
                 prologue: Optional[Prologue] = None,
                 activation: str = "none", emit_stats: bool = False):
    """K1. x (B, D, H, W, G*Cin1), x2 (B, D, H, W, G*Cin2) or None,
    weight (3, 3, 3, Cin1+Cin2, G*Cout), bias (G*Cout,), prologue maps
    (B, G*Cin) float32. Returns ``out`` (B, D, H, W, G*Cout) in x's type,
    or ``(out, (sum, sumsq))`` with ``emit_stats``."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device.type == "cpu":
        return conv3d_fused_reference(x, weight, bias, groups, x2=x2,
                                      prologue=prologue,
                                      activation=activation,
                                      emit_stats=emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_fused runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d_fused takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.ndim != 5 or x.shape[-1] % groups:
        raise ValueError(f"x: shape {tuple(x.shape)} is not NDHWC with "
                         f"{groups} channel groups")
    b, d, h, w, gc1 = x.shape
    cin1 = gc1 // groups
    _check(x, "x", x.shape, x.dtype, x.device)
    cin2 = 0
    if x2 is not None:
        cin2 = x2.shape[-1] // groups
        _check(x2, "x2", (b, d, h, w, groups * cin2), x.dtype, x.device)
    cin = cin1 + cin2
    if weight.ndim != 5 or weight.shape[-1] % groups:
        raise ValueError(f"weight: shape {tuple(weight.shape)}")
    cout = weight.shape[-1] // groups
    _check(weight, "weight", (3, 3, 3, cin, groups * cout), x.dtype,
           x.device)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        _check(bias, "bias", (groups * cout,), torch.float32, x.device)
    maps = (None, None, None)
    if prologue is not None:
        maps = prologue
        for name, m in zip(("scale", "shift", "slope"), maps):
            _check(m, name, (b, groups * cin), torch.float32, x.device)
    out = torch.empty((b, d, h, w, groups * cout), dtype=x.dtype,
                      device=x.device)
    stats = (torch.zeros((2, b, groups * cout), dtype=torch.float32,
                         device=x.device) if emit_stats else None)
    lib = load_kernel()
    with torch.cuda.device(x.device):  # the launch goes to x's card
        rc = lib.conv3d_fused_launch(
            _DTYPES[x.dtype], x.data_ptr(), _ptr(x2), weight.data_ptr(),
            _ptr(bias), *(_ptr(m) for m in maps), out.data_ptr(),
            _ptr(None if stats is None else stats[0]),
            _ptr(None if stats is None else stats[1]),
            b, d, h, w, groups, cin1, cin2, cout, ACTIVATIONS[activation],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_fused launch failed with CUDA error {rc}")
    conv3d_fused.launches += 1
    if emit_stats:
        return out, (stats[0], stats[1])
    return out


conv3d_fused.launches = 0


_SLOPES = {"leaky": 0.01, "relu": 0.0}


def flip_transpose_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The dx kernel of a grouped SAME conv: (3, 3, 3, Cin, G*Cout) ->
    (3, 3, 3, Cout, G*Cin), flipped in space and transposed within each
    group (``conv3d.py:946-948``), contiguous, in the weight's type."""
    cin, cout = weight.shape[3], weight.shape[4] // groups
    w = weight.flip(0, 1, 2).reshape(3, 3, 3, cin, groups, cout)
    return w.permute(0, 1, 2, 5, 4, 3).reshape(3, 3, 3, cout,
                                               groups * cin).contiguous()


class Conv3dFusedFn(torch.autograd.Function):
    """K1b: K1 with a backward (``_banded_packed_ad*``'s custom VJP).

    Forward: K1 on x, weight, bias, with an epilogue activation or the
    (sum, sumsq) statistics of its output. Saved: x, the weight, and the
    output when there is an activation or statistics. Backward:

    1. the activation derivative from the saved output (leaky and ReLU
       keep the sign, so y > 0 iff the pre-activation is), or the stats
       cotangents folded in as ``dy + ds1 + 2 y ds2`` in float32 and
       rounded to dy's type, as the JAX package does (in bfloat16 a ds1
       below half an ulp of dy is lost: ROADMAP.md fault R5);
    2. dx: K1 on dy with the flipped, group-transposed weight, only where
       x needs a gradient;
    3. dW: the backward-weights contraction, a library call
       (``aten.convolution_backward``) on channels-last views of the
       NDHWC tensors, as the JAX package leaves it to XLA (:981-992);
       its float32 precision follows ``torch.backends.cudnn.allow_tf32``
       like any PyTorch convolution;
    4. db: Σdy in float32.

    On the card dx costs what a K1 forward of the same shape costs (K1
    is bound by its float32 FMA rate, far from the byte bound), and dW
    is whatever cuDNN picks for the shape and type.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, groups, activation, emit_stats):
        if emit_stats and activation != "none":
            raise ValueError("emit_stats takes the pre-activation output; "
                             "use activation='none' with it")
        res = conv3d_fused(x, weight, bias, groups, activation=activation,
                           emit_stats=emit_stats)
        out, stats = res if emit_stats else (res, None)
        ctx.groups, ctx.activation, ctx.emit_stats = (groups, activation,
                                                      emit_stats)
        ctx.bias_dtype = None if bias is None else bias.dtype
        keep_out = activation != "none" or emit_stats
        ctx.save_for_backward(x, weight, out if keep_out else None)
        ctx.set_materialize_grads(False)
        if emit_stats:
            return out, stats[0], stats[1]
        return out

    @staticmethod
    def backward(ctx, dy, ds1=None, ds2=None):
        x, weight, y = ctx.saved_tensors
        if dy is None and ds1 is None and ds2 is None:
            return None, None, None, None, None, None
        if dy is None:  # only the statistics were used; y was saved
            dy = torch.zeros_like(y)
        # float32 sums (float64 for a float64 run, as the plain version)
        acc = torch.float64 if dy.dtype == torch.float64 else torch.float32
        if ctx.emit_stats and (ds1 is not None or ds2 is not None):
            g = dy.to(acc)
            if ds1 is not None:
                g = g + ds1[:, None, None, None, :]
            if ds2 is not None:
                g = g + 2.0 * y.to(acc) * ds2[:, None, None, None, :]
            dy = g.to(dy.dtype)
        if ctx.activation != "none":
            dy = torch.where(y > 0, dy, _SLOPES[ctx.activation] * dy)
        dy = dy.contiguous()
        groups = ctx.groups
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_fused(dy, flip_transpose_weight(weight, groups),
                              None, groups)
            if dy.device.type == "cuda":
                conv3d_fused_train.launches += 1
        if ctx.needs_input_grad[1]:
            # NDHWC -> (N, C, D, H, W) views in channels-last-3d memory
            _, dw, _ = torch.ops.aten.convolution_backward(
                dy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
                weight.permute(4, 3, 0, 1, 2), None, [1, 1, 1], [1, 1, 1],
                [1, 1, 1], False, [0, 0, 0], groups, [False, True, False])
            dw = dw.permute(2, 3, 4, 1, 0).contiguous()
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = dy.to(acc).sum(dim=(0, 1, 2, 3)).to(ctx.bias_dtype)
        return dx, dw, db, None, None, None


def conv3d_fused_train(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, groups: int = 1,
                       activation: str = "none", emit_stats: bool = False):
    """K1b: the differentiable K1. x (B, D, H, W, G*Cin), weight (3, 3, 3,
    Cin, G*Cout) in x's type, bias (G*Cout,) or None. Returns ``out``, or
    ``(out, (sum, sumsq))`` with ``emit_stats`` (then activation must be
    "none"); gradients flow through all of them. On CUDA tensors the
    backward launches K1 for dx and counts it in ``launches``; on CPU
    tensors both directions run K1's plain version."""
    res = Conv3dFusedFn.apply(x, weight, bias, groups, activation,
                              emit_stats)
    if emit_stats:
        return res[0], (res[1], res[2])
    return res


conv3d_fused_train.launches = 0


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K1's library."""
    lib = load_library("conv3d_fused", SOURCES)
    fn = lib.conv3d_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib
