"""K1: the fused grouped 3x3x3 convolution, NDHWC.

Port of ``values_tpu/ops/pallas/conv3d.py::_conv_kernel`` (entry
``conv3d_banded_packed``) to hand-written CUDA kernels
(``values_tpu_torch/csrc/conv3d_fused.cu``). The TPU kernel's batch-packed
lanes and banded weights are TPU layout and are not ported: tensors here
are plain NDHWC and the weight is the grouped DHWIO kernel of
:func:`values_tpu_torch.models.torch_import.group_member_state_dicts`.

:func:`plan` picks the kernel (the regime) and its tile from the dtype
and the shape alone, before the launch; a shape that no regime takes
raises, and nothing falls back after a failed build or launch:

- ``f32``: float32, any shape. CUDA cores in full float32, one block per
  (item, group, 8 output channels, 4x8x8 voxels).
- ``cin1``: bfloat16, one input channel per group (the first conv),
  Cout a multiple of 8. CUDA cores in float32; an 8x8x32 tile of all
  groups staged once per block, 8 voxels along D and 4 output channels
  at a time per thread.
- ``shallow``, ``tile16``, ``tile8``, ``tile4``: bfloat16, Cin1, Cin2
  and Cout multiples of 8, Cin / 8 a power of two. The tensor-core
  implicit GEMM (``mma.sync`` m16n8k16, float32 accumulation, K = 27 Cin
  in the weight's (tap, channel) row order, zero-padded to 16 rows). BN,
  the output channels of one block, is the largest of 32, 16, 8 (64 too
  in ``tile4``) that divides Cout: each thread then holds at most 32
  float32 accumulators.

  - ``shallow`` (W >= 16, H >= 8, BN <= 16, Cin2 0 or Cin1, Cin1 / 8 at
    most 8: the 64^3 and 32^3 levels): persistent, warp-specialized
    blocks, each with the whole weight of one (group, n-tile) on chip,
    walk over 4x8x16-voxel tiles (2x8x16 at BN 16); producer warps load
    each haloed tile with TMA and apply the prologue while consumer
    warps multiply the previous one and store through TMA. Where two
    such blocks do not fit an SM's shared memory, ``tile16``.
  - ``tile16``, ``tile8``, ``tile4`` (named after the tile's W extent):
    one tile per block, the weight streamed through a ring of 64-row
    chunks. 2x8x16 voxels where W >= 16 and H >= 8, 4x8x8 where W >= 8
    and H >= 8, 4x4x4 otherwise (a whole 4^3 volume per tile).

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
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .build import load_library

ACTIVATIONS = {"none": 0, "leaky": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SOURCES = ("conv3d_fused.cu",)

# regime -> the C entry's kernel id
REGIMES = {"f32": 0, "cin1": 1, "shallow": 3, "tile16": 2, "tile8": 2,
           "tile4": 2}
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
# ``shallow`` takes a shape when two of its blocks fit an SM's shared
# memory: at one block an SM it lost to ``tile16`` on the card
SHALLOW_SMEM = 113 * 1024
# the tensor-core kernel's constants (conv3d_fused.cu: MmaCfg, kNStage,
# kChunk)
_N_STAGE = 3
_K_CHUNK = 64
_BLOCK_N = (32, 16, 8)
_CIN1_TILE = (8, 8, 32)


class Plan(NamedTuple):
    """A launch of K1: the regime, the voxel tile (D, H, W), the output
    channels of one block, the weight rows staged at a time (all of K,
    padded to 16 rows, for ``shallow``), the shared memory of a block in
    bytes."""
    regime: str
    tile: Tuple[int, int, int]
    block_n: int
    k_chunk: int
    smem_bytes: int


def _mma_warps_m(bm: int, bn: int) -> int:
    wn = 1 if bn <= 32 else 2
    return min(8 // wn, bm // 16)


@functools.lru_cache(maxsize=None)
def _row_stride(td, th, tw):
    """conv3d_fused.cu's row_stride: the least haloed row stride >= tw + 2
    that puts tile rows 16 apart a multiple of 8 stored voxels apart."""
    def stored(m, hwd):
        return (m // (tw * th) * (th + 2) + m // tw % th) * hwd + m % tw
    hwd = tw + 2
    while any((stored(m, hwd) - stored(m % 16, hwd)) % 8
              for m in range(16, td * th * tw)):
        hwd += 1
    return hwd


def _halo_bytes(tile, cin):
    """The staged haloed input tile: 16-byte units of 8 channels per
    voxel, at the padded row stride."""
    return (tile[0] + 2) * (tile[1] + 2) * _row_stride(*tile) * cin * 2


def _round_up(n, a):
    return -(-n // a) * a


def _mma_plan(regime, tile, bn, cin):
    """conv3d_fused.cu's mma_smem_bytes: a ring of weight chunks, the
    haloed tile, a zero row, the tap offsets and the statistics' sums."""
    bm = tile[0] * tile[1] * tile[2]
    return Plan(regime, tile, bn, _K_CHUNK, _N_STAGE * _K_CHUNK * bn * 2
                + _halo_bytes(tile, cin) + 16 + 128
                + 8 * _mma_warps_m(bm, bn) * bn)


def _shallow_plan(bn, cin1, cin2):
    """conv3d_fused.cu's ShallowSmem: the whole weight (K padded to 16
    rows), two tile buffers of x's and x2's boxes (each 1024-aligned), the
    output tile, the zero row, the tap offsets, the statistics' sums (4
    consumer warps), six mbarriers and 1024 bytes of alignment."""
    tile = (4, 8, 16) if bn == 8 else (2, 8, 16)
    bm = tile[0] * tile[1] * tile[2]
    k_pad = _round_up(27 * (cin1 + cin2), 16)
    buffer = sum(_round_up(_halo_bytes(tile, c), 1024) for c in (cin1, cin2))
    out = _round_up(bm * bn * 2, 128)
    smem = (_round_up(k_pad * bn * 2, 1024) + 2 * buffer + out + 16 + 128
            + _round_up(8 * 4 * bn, 16) + 48 + 1024)
    return Plan("shallow", tile, bn, k_pad, smem)


@functools.lru_cache(maxsize=None)
def plan(dtype: torch.dtype, d: int, h: int, w: int, groups: int,
         cin1: int, cin2: int, cout: int) -> Plan:
    """The K1 launch for this dtype and shape (see the module docstring).
    Raises ValueError for a shape that no regime takes."""
    cin = cin1 + cin2
    if dtype == torch.float32:  # channel chunks of 1 or 8, static memory
        ck = 1 if cin == 1 else 8
        return Plan("f32", (4, 8, 8), 8, 27 * ck,
                    ck * 600 * 4 + 27 * ck * 8 * 4 + 512)
    if dtype != torch.bfloat16:
        raise ValueError(f"no K1 regime takes dtype {dtype}")
    if cout % 8:
        raise ValueError(f"no K1 regime takes Cout {cout} (a multiple of 8 "
                         "in bfloat16)")
    if cin == 1 and cin2 == 0:
        hvox = (_CIN1_TILE[0] + 2) * (_CIN1_TILE[1] + 2) * (_CIN1_TILE[2] + 2)
        found = Plan("cin1", _CIN1_TILE, 8, 27,
                     -(-groups * hvox * 2 // 16) * 16 + 27 * groups * cout * 4
                     + 2 * 8 * 4 * 4)
    elif cin1 % 8 or cin2 % 8 or cin == 0 or (cin // 8) & (cin // 8 - 1):
        raise ValueError(f"no K1 regime takes Cin {cin1}+{cin2} in bfloat16 "
                         "(1, or multiples of 8 adding up to 8 times a "
                         "power of two)")
    else:
        bn = next(n for n in _BLOCK_N if cout % n == 0)
        if w >= 16 and h >= 8:
            q1 = cin1 // 8
            found = None
            if bn <= 16 and q1 <= 8 and not q1 & (q1 - 1) \
                    and cin2 in (0, cin1):
                found = _shallow_plan(bn, cin1, cin2)
            if found is None or found.smem_bytes > SHALLOW_SMEM:
                found = _mma_plan("tile16", (2, 8, 16), bn, cin)
        elif w >= 8 and h >= 8:
            found = _mma_plan("tile8", (4, 8, 8), bn, cin)
        else:
            found = _mma_plan("tile4", (4, 4, 4), 64 if cout % 64 == 0
                              else bn, cin)
    if found.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"no K1 regime fits Cin {cin}, Cout {cout}, G "
                         f"{groups} in shared memory ({found})")
    return found


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
    launch = plan(x.dtype, d, h, w, groups, cin1, cin2, cout)
    if launch.regime != "f32":  # 16-byte copies of x, x2 and the weight
        for name, t in (("x", x), ("x2", x2), ("weight", weight)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((b, d, h, w, groups * cout), dtype=x.dtype,
                      device=x.device)
    stats = (torch.zeros((2, b, groups * cout), dtype=torch.float32,
                         device=x.device) if emit_stats else None)
    lib = load_kernel()
    with torch.cuda.device(x.device):  # the launch goes to x's card
        rc = lib.conv3d_fused_launch(
            _DTYPES[x.dtype], REGIMES[launch.regime], *launch.tile,
            launch.block_n, x.data_ptr(), _ptr(x2), weight.data_ptr(),
            _ptr(bias), *(_ptr(m) for m in maps), out.data_ptr(),
            _ptr(None if stats is None else stats[0]),
            _ptr(None if stats is None else stats[1]),
            b, d, h, w, groups, cin1, cin2, cout, ACTIVATIONS[activation],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_fused launch ({launch}) failed with CUDA "
                           f"error {rc}")
    conv3d_fused.launches += 1
    conv3d_fused.regime_launches[launch.regime] += 1
    if emit_stats:
        return out, (stats[0], stats[1])
    return out


conv3d_fused.launches = 0
conv3d_fused.regime_launches = dict.fromkeys(REGIMES, 0)


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

    On the card dx costs what a K1 forward of the same shape costs: in
    bfloat16 the tensor-core regimes of :func:`plan` at G = 1 (Cin and
    Cout swapped, no x2, prologue, bias or statistics), in float32 the
    CUDA-core kernel. dW is whatever cuDNN picks for the shape and type.
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
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib
