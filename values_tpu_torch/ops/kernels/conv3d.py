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

- ``tf32x3``: float32 where the tensor-core regimes below take the shape
  (Cin1, Cin2 and Cout multiples of 8, Cin / 8 a power of two): their
  implicit GEMM in the 3xTF32 split (each float32 operand as a TF32 big
  part and a TF32 rest, three ``mma.sync`` m16n8k8 products, float32
  accumulation; float32's accuracy on the tensor cores). The one-tile-a-
  block kernel of ``tile16``/``tile8``/``tile4``: bfloat16's tile where
  two of its blocks fit an SM (a float32 tile is twice the bytes), else
  the next smaller tile that does, else the smallest that fits.
- ``f32``: float32, any other shape (Cin = 1, the first conv). CUDA cores
  in full float32, one block per (item, group, 8 output channels, 4x8x8
  voxels).
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
    and H >= 8, 4x4x4 otherwise (a whole 4^3 volume per tile); the next
    smaller tile where the haloed input of that one does not fit shared
    memory (Cin 256 at 8^3).

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
A bfloat16 shape the regimes do not take as it is runs zero-padded
(:func:`padded_channels`, :func:`run_padded`): Cin1 and Cin2 each to
8·2^k, Cout to a multiple of 8, with zero weights, bias and prologue
maps in the padded channels, the output and its statistics sliced back.
That is a shape transform around the same launch; :func:`plan` stays
strict, and a shape no regime takes after padding still raises. The dx
entry pads likewise (:func:`dx_padded_channels`, :func:`run_padded_dx`).

K1b, the training form (:func:`conv3d_fused_train`, the autograd
:class:`Conv3dFusedFn`), is the port of the custom VJP around the TPU
kernel (``conv3d.py::_banded_packed_ad`` and ``_banded_packed_ad_stats``,
:888-1208). Its forward is K1 without ``x2`` or prologue; its backward's
dx is one launch of the library's dx entry (:func:`conv3d_fused_dx`,
regime by :func:`plan_dx`): the fold of the cotangent, the conv on the
forward's weight read flipped, the folded cotangent for dW and db.
Autograd through :func:`conv3d_fused_reference` is its plain version.
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
           "tile4": 2, "tf32x3": 4}
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
_TILES = {"tile16": (2, 8, 16), "tile8": (4, 8, 8), "tile4": (4, 4, 4)}


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


def _halo_bytes(tile, cin, size=2):
    """The staged haloed input tile: 16-byte units of 16 / size channels
    per voxel, at the padded row stride."""
    return (tile[0] + 2) * (tile[1] + 2) * _row_stride(*tile) * cin * size


def _round_up(n, a):
    return -(-n // a) * a


def _weight_stage_bytes(rows, bn, size, dx):
    """conv3d_fused.cu's w_stage_bytes: bf16 (k, n) rows; f32 (k, n) rows
    padded to BN + 8 words (BN 8: 8); the dx entry's (n, k) rows of
    rows / (16 / size) units and one of padding."""
    if dx:
        return bn * (rows * size // 16 + 1) * 16
    if size == 4:
        return rows * (bn + (0 if bn == 8 else 8)) * 4
    return rows * bn * 2


def _mma_plan(regime, tile, bn, cin, size=2, dx=False):
    """conv3d_fused.cu's mma_smem_bytes: a ring of weight chunks, the
    haloed tile (in float32 above 4x4x4 voxels twice: its TF32 big parts
    and its rests, conv3d_fused.cu::presplit), a zero row, the tap
    offsets, the statistics' sums and, for the dx entry, its db sums."""
    bm = tile[0] * tile[1] * tile[2]
    presplit = size == 4 and bm > 64
    return Plan(regime, tile, bn, _K_CHUNK,
                _N_STAGE * _weight_stage_bytes(_K_CHUNK, bn, size, dx)
                + (2 if presplit else 1) * _halo_bytes(tile, cin, size)
                + 16 + 128
                + 8 * _mma_warps_m(bm, bn) * bn
                + (_round_up(4 * cin, 16) if dx else 0))


def _shallow_plan(bn, cin1, cin2, dx=False):
    """conv3d_fused.cu's ShallowSmem: the whole weight (K padded to 16
    rows), two tile buffers of x's and the second box's (x2's, or the dx
    entry's y) haloed tiles (each 1024-aligned), the output tile, the zero
    row, the tap offsets, the statistics' sums (4 consumer warps), the dx
    entry's db sums, six mbarriers and 1024 bytes of alignment."""
    tile = (4, 8, 16) if bn == 8 else (2, 8, 16)
    bm = tile[0] * tile[1] * tile[2]
    k_pad = _round_up(27 * (cin1 + cin2), 16)
    boxes = (cin1, cin1) if dx else (cin1, cin2)
    buffer = sum(_round_up(_halo_bytes(tile, c), 1024) for c in boxes)
    out = _round_up(bm * bn * 2, 128)
    smem = (_round_up(_weight_stage_bytes(k_pad, bn, 2, dx), 1024)
            + 2 * buffer + out + 16 + 128 + _round_up(8 * 4 * bn, 16)
            + (_round_up(4 * cin1, 16) if dx else 0) + 48 + 1024)
    return Plan("shallow", tile, bn, k_pad, smem)


def _tensor_core_shape(cin1, cin2, cout):
    """Cin1, Cin2 and Cout multiples of 8, Cin / 8 a power of two."""
    cin = cin1 + cin2
    return not (cout % 8 or cin1 % 8 or cin2 % 8 or cin == 0
                or (cin // 8) & (cin // 8 - 1))


def _tf32x3_plan(h, w, cin1, cin2, cout, dx):
    """The tensor-core tile for float32: bfloat16's tile, or the next
    smaller one, the first whose (twice as large) staging lets two blocks
    share an SM; else the one of least shared memory that fits; None if
    none fits."""
    cin = cin1 + cin2
    bn = next(n for n in _BLOCK_N if cout % n == 0)
    names = (["tile16"] if w >= 16 and h >= 8 else []) + \
        (["tile8"] if w >= 8 and h >= 8 else []) + ["tile4"]
    found = [_mma_plan("tf32x3", _TILES[name],
                       64 if name == "tile4" and cout % 64 == 0 else bn,
                       cin, 4, dx) for name in names]
    for limit in (SHALLOW_SMEM, SMEM_LIMIT):
        fits = [f for f in found if f.smem_bytes <= limit]
        if fits:
            return fits[0] if limit == SHALLOW_SMEM else min(
                fits, key=lambda f: f.smem_bytes)
    return None


@functools.lru_cache(maxsize=None)
def _plan(dtype, d, h, w, groups, cin1, cin2, cout, dx):
    cin = cin1 + cin2
    if dtype == torch.float32:
        if _tensor_core_shape(cin1, cin2, cout):
            found = _tf32x3_plan(h, w, cin1, cin2, cout, dx)
            if found is not None:
                return found
        # CUDA cores: channel chunks of 1 or 8, static memory
        ck = 1 if cin == 1 else 8
        return Plan("f32", (4, 8, 8), 8, 27 * ck,
                    ck * 600 * 4 + 27 * ck * 8 * 4 + 512 + 4 * ck)
    if dtype != torch.bfloat16:
        raise ValueError(f"no K1 regime takes dtype {dtype}")
    if cout % 8:
        raise ValueError(f"no K1 regime takes Cout {cout} (a multiple of 8 "
                         "in bfloat16)")
    if cin == 1 and cin2 == 0 and not dx:
        hvox = (_CIN1_TILE[0] + 2) * (_CIN1_TILE[1] + 2) * (_CIN1_TILE[2] + 2)
        found = Plan("cin1", _CIN1_TILE, 8, 27,
                     -(-groups * hvox * 2 // 16) * 16 + 27 * groups * cout * 4
                     + 2 * 8 * 4 * 4)
    elif not _tensor_core_shape(cin1, cin2, cout):
        raise ValueError(f"no K1 regime takes Cin {cin1}+{cin2} in bfloat16 "
                         "(1, or multiples of 8 adding up to 8 times a "
                         "power of two)" + (" for dx" if dx else ""))
    else:
        bn = next(n for n in _BLOCK_N if cout % n == 0)
        found = None
        if w >= 16 and h >= 8 and bn <= 16:
            q1 = cin1 // 8
            if q1 <= 8 and not q1 & (q1 - 1) and cin2 in (0, cin1):
                found = _shallow_plan(bn, cin1, cin2, dx)
            if found is not None and found.smem_bytes > SHALLOW_SMEM:
                found = None
        if found is None:
            # the volume's tile, or a smaller one where its haloed input
            # does not fit shared memory (wide Cin, as padding makes)
            names = ((["tile16"] if w >= 16 and h >= 8 else [])
                     + (["tile8"] if w >= 8 and h >= 8 else []) + ["tile4"])
            plans = [_mma_plan(name, _TILES[name],
                               64 if name == "tile4" and cout % 64 == 0
                               else bn, cin, 2, dx) for name in names]
            found = next((f for f in plans if f.smem_bytes <= SMEM_LIMIT),
                         plans[0])
    if found.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"no K1 regime fits Cin {cin}, Cout {cout}, G "
                         f"{groups} in shared memory ({found})")
    return found


def plan(dtype: torch.dtype, d: int, h: int, w: int, groups: int,
         cin1: int, cin2: int, cout: int) -> Plan:
    """The K1 launch for this dtype and shape (see the module docstring).
    Raises ValueError for a shape that no regime takes."""
    return _plan(dtype, d, h, w, groups, cin1, cin2, cout, False)


def plan_dx(dtype: torch.dtype, d: int, h: int, w: int, groups: int,
            cin: int, cout: int) -> Plan:
    """The launch of K1b's dx entry: the regime :func:`plan` gives the dx
    conv (``cin`` input channels a group, the forward's Cout; ``cout``
    output channels, the forward's Cin; no x2), with the entry's shared
    memory (the weight staged as flipped (n, k) rows, the second box of y
    in ``shallow``, the db sums). No ``cin1``: no dx has one input
    channel a group in bfloat16."""
    return _plan(dtype, d, h, w, groups, cin, 0, cout, True)


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


def _pow2_multiple_of_8(c: int) -> int:
    return 8 << max(0, (-(-c // 8) - 1).bit_length())


def padded_channels(dtype: torch.dtype, cin1: int, cin2: int, cout: int
                    ) -> Tuple[int, int, int]:
    """The channel counts a K1 launch runs the shape at: in bfloat16 Cin1
    and Cin2 (each on its own, 0 staying 0) zero-padded to 8·2^k and Cout
    to a multiple of 8, except one input channel and no x2 (the ``cin1``
    regime); float32 shapes as they are. :func:`plan` then takes the
    padded shape or raises."""
    if dtype != torch.bfloat16:
        return cin1, cin2, cout
    cout_p = _round_up(cout, 8)
    if cin1 == 1 and cin2 == 0:
        return 1, 0, cout_p
    return (_pow2_multiple_of_8(cin1),
            _pow2_multiple_of_8(cin2) if cin2 else 0, cout_p)


def dx_padded_channels(dtype: torch.dtype, cout: int, cin: int
                       ) -> Tuple[int, int]:
    """The (forward Cout, forward Cin) a group that a launch of K1b's dx
    entry runs at: in bfloat16 the first (dx's input channels) padded to
    8·2^k and the second (dx's output) to a multiple of 8."""
    if dtype != torch.bfloat16:
        return cout, cin
    return _pow2_multiple_of_8(cout), _round_up(cin, 8)


def _pad_last(t: Optional[torch.Tensor], groups: int, size: int):
    """Zero-pad each of ``groups`` channel blocks of the last axis to
    ``size`` channels."""
    if t is None:
        return None
    lead, c = t.shape[:-1], t.shape[-1] // groups
    if c == size:
        return t
    return F.pad(t.reshape(*lead, groups, c), (0, size - c)).reshape(
        *lead, groups * size).contiguous()


def _unpad_last(t: Optional[torch.Tensor], groups: int, size: int):
    """The first ``size`` channels of each of ``groups`` blocks."""
    if t is None or t.shape[-1] == groups * size:
        return t
    lead = t.shape[:-1]
    return t.reshape(*lead, groups, -1)[..., :size].reshape(
        *lead, groups * size).contiguous()


def _pad_weight(weight: torch.Tensor, groups: int, rows, rows_p,
                cols_p: int) -> torch.Tensor:
    """A (3, 3, 3, sum(rows), G*cols) weight with each block of ``rows``
    input rows zero-padded to its ``rows_p`` and each group's columns to
    ``cols_p``."""
    blocks, start = [], 0
    for r, rp in zip(rows, rows_p):
        block = weight[:, :, :, start:start + r]
        blocks.append(F.pad(block, (0, 0, 0, rp - r)) if rp > r else block)
        start += r
    return _pad_last(torch.cat(blocks, dim=3), groups, cols_p).contiguous()


def run_padded(conv, x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], groups: int,
               channels: Tuple[int, int, int], *,
               x2: Optional[torch.Tensor] = None,
               prologue: Optional[Prologue] = None,
               activation: str = "none", emit_stats: bool = False):
    """``conv`` (K1, or its plain version in the tests) on operands
    zero-padded to ``channels`` = (Cin1, Cin2, Cout) a group, its output
    and statistics sliced back: padded input channels meet zero weight
    rows and a prologue scale and shift of 0 (so they stay 0), padded
    output channels have zero weights and bias (their output and sums
    are 0)."""
    cin1, cout = x.shape[-1] // groups, weight.shape[-1] // groups
    cin2 = 0 if x2 is None else x2.shape[-1] // groups
    cin1_p, cin2_p, cout_p = channels
    w = _pad_weight(weight, groups, (cin1, cin2), (cin1_p, cin2_p), cout_p)
    if prologue is not None:
        def pad_map(m):
            m = m.reshape(m.shape[0], groups, cin1 + cin2)
            parts = [F.pad(m[..., :cin1], (0, cin1_p - cin1)),
                     F.pad(m[..., cin1:], (0, cin2_p - cin2))]
            return torch.cat(parts, -1).reshape(m.shape[0], -1).contiguous()
        prologue = tuple(pad_map(m) for m in prologue)
    res = conv(_pad_last(x, groups, cin1_p), w,
               _pad_last(bias, groups, cout_p), groups,
               x2=_pad_last(x2, groups, cin2_p), prologue=prologue,
               activation=activation, emit_stats=emit_stats)
    if not emit_stats:
        return _unpad_last(res, groups, cout)
    out, (s1, s2) = res
    return (_unpad_last(out, groups, cout),
            (_unpad_last(s1, groups, cout), _unpad_last(s2, groups, cout)))


def run_padded_dx(dx_entry, dy: torch.Tensor, weight: torch.Tensor,
                  groups: int, channels: Tuple[int, int], *,
                  y: Optional[torch.Tensor] = None, fold: str = "none",
                  ds1: Optional[torch.Tensor] = None,
                  ds2: Optional[torch.Tensor] = None,
                  cotangent: bool = False, bias_grad: bool = False):
    """``dx_entry`` (K1b's dx entry, or its plain version) on operands
    zero-padded to ``channels`` = (the forward's Cout, its Cin) a group:
    dy, y, ds1 and ds2 to the first, the weight's rows to the second and
    its columns to the first. dx, the cotangent and db are sliced back."""
    cout_f, cin_f = weight.shape[-1] // groups, weight.shape[3]
    cout_p, cin_p = channels
    w = _pad_weight(weight, groups, (cin_f,), (cin_p,), cout_p)
    dx, g, db = dx_entry(
        _pad_last(dy, groups, cout_p), w, groups,
        y=_pad_last(y, groups, cout_p), fold=fold,
        ds1=_pad_last(ds1, groups, cout_p), ds2=_pad_last(ds2, groups, cout_p),
        cotangent=cotangent, bias_grad=bias_grad)
    return (_unpad_last(dx, groups, cin_f), _unpad_last(g, groups, cout_f),
            _unpad_last(db, groups, cout_f))


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
    channels = padded_channels(x.dtype, cin1, cin2, cout)
    if channels != (cin1, cin2, cout):
        return run_padded(conv3d_fused, x, weight, bias, groups, channels,
                          x2=x2, prologue=prologue, activation=activation,
                          emit_stats=emit_stats)
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
# the dx entry's fold of the cotangent (conv3d_fused.cu: Fold)
FOLDS = {"none": 0, "leaky": 1, "relu": 2, "stats": 3}


def flip_transpose_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The dx kernel of a grouped SAME conv: (3, 3, 3, Cin, G*Cout) ->
    (3, 3, 3, Cout, G*Cin), flipped in space and transposed within each
    group (``conv3d.py:946-948``), contiguous, in the weight's type."""
    cin, cout = weight.shape[3], weight.shape[4] // groups
    w = weight.flip(0, 1, 2).reshape(3, 3, 3, cin, groups, cout)
    return w.permute(0, 1, 2, 5, 4, 3).reshape(3, 3, 3, cout,
                                               groups * cin).contiguous()


def fold_cotangent(dy: torch.Tensor, y: Optional[torch.Tensor], fold: str,
                   ds1: Optional[torch.Tensor] = None,
                   ds2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The cotangent that dx, dW and db take (``conv3d.py:918-928`` and
    ``:1155-1167``): after an activation ``where(y > 0, dy, slope dy)``
    (leaky and ReLU keep the sign, so y > 0 iff the pre-activation is);
    after statistics ``dy + ds1 + 2 y ds2`` in float32 (float64 for a
    float64 run) rounded to dy's type, as the JAX package does (in
    bfloat16 a ds1 below half an ulp of dy is lost: ROADMAP.md fault
    R5)."""
    if fold == "stats":
        if ds1 is None and ds2 is None:
            return dy
        acc = torch.float64 if dy.dtype == torch.float64 else torch.float32
        g = dy.to(acc)
        if ds1 is not None:
            g = g + ds1[:, None, None, None, :]
        if ds2 is not None:
            g = g + 2.0 * y.to(acc) * ds2[:, None, None, None, :]
        return g.to(dy.dtype)
    if fold in _SLOPES:
        return torch.where(y > 0, dy, _SLOPES[fold] * dy)
    return dy


def _bias_sums(g: torch.Tensor) -> torch.Tensor:
    acc = torch.float64 if g.dtype == torch.float64 else torch.float32
    return g.to(acc).sum(dim=(0, 1, 2, 3))


def conv3d_fused_dx_reference(dy, weight, groups=1, *, y=None, fold="none",
                              ds1=None, ds2=None, cotangent=False,
                              bias_grad=False):
    """The plain version of :func:`conv3d_fused_dx`: the fold in torch,
    K1's plain version on the flipped, group-transposed weight, db as a
    float32 sum."""
    g = fold_cotangent(dy, y, fold, ds1, ds2).contiguous()
    dx = conv3d_fused_reference(g, flip_transpose_weight(weight, groups),
                                None, groups)
    return (dx, g if cotangent else None,
            _bias_sums(g) if bias_grad else None)


def conv3d_fused_dx(dy: torch.Tensor, weight: torch.Tensor, groups: int = 1,
                    *, y: Optional[torch.Tensor] = None, fold: str = "none",
                    ds1: Optional[torch.Tensor] = None,
                    ds2: Optional[torch.Tensor] = None,
                    cotangent: bool = False, bias_grad: bool = False):
    """K1b's dx entry: the input gradient of K1 in one launch. dy (B, D,
    H, W, G*Cout), the forward's weight (3, 3, 3, Cin, G*Cout) in dy's
    type, y (the forward's output, as dy) where ``fold`` is not "none",
    ds1 and ds2 (B, G*Cout) float32 or None for the "stats" fold. The
    kernel folds the cotangent (:func:`fold_cotangent`) as it stages dy,
    reads the weight flipped and group-transposed, and computes dx (B, D,
    H, W, G*Cin) in dy's type; with ``cotangent`` it also writes the
    folded cotangent (what dW takes), with ``bias_grad`` its float32
    per-channel sums (db, added with atomics: not bitwise reproducible).
    Returns ``(dx, cotangent or None, db or None)``. The regime is
    :func:`plan_dx`'s. Each launch counts in ``conv3d_fused_dx.launches``
    and, as a launch of K1's kernels, in ``conv3d_fused.launches`` and
    its ``regime_launches``. CPU tensors run
    :func:`conv3d_fused_dx_reference`."""
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}")
    if fold == "stats" and ds1 is None and ds2 is None:
        fold = "none"
    if dy.device.type == "cpu":
        return conv3d_fused_dx_reference(dy, weight, groups, y=y, fold=fold,
                                         ds1=ds1, ds2=ds2,
                                         cotangent=cotangent,
                                         bias_grad=bias_grad)
    if dy.device.type != "cuda":
        raise ValueError(f"conv3d_fused_dx runs on cuda or cpu, not "
                         f"{dy.device}")
    if dy.dtype not in _DTYPES:
        raise TypeError(f"conv3d_fused_dx takes float32 or bfloat16, not "
                        f"{dy.dtype}")
    if dy.ndim != 5 or weight.ndim != 5 or weight.shape[-1] % groups:
        raise ValueError(f"dy {tuple(dy.shape)}, weight "
                         f"{tuple(weight.shape)}: not NDHWC and DHWIO with "
                         f"{groups} groups")
    b, d, h, w, _ = dy.shape
    cin, cout = weight.shape[-1] // groups, weight.shape[3]
    _check(dy, "dy", (b, d, h, w, groups * cin), dy.dtype, dy.device)
    _check(weight, "weight", (3, 3, 3, cout, groups * cin), dy.dtype,
           dy.device)
    if fold != "none":
        _check(y, "y", dy.shape, dy.dtype, dy.device)
    for name, m in (("ds1", ds1), ("ds2", ds2)):
        if fold == "stats" and m is not None:
            _check(m, name, (b, groups * cin), torch.float32, dy.device)
    channels = dx_padded_channels(dy.dtype, cin, cout)
    if channels != (cin, cout):
        return run_padded_dx(conv3d_fused_dx, dy, weight, groups, channels,
                             y=y, fold=fold, ds1=ds1, ds2=ds2,
                             cotangent=cotangent, bias_grad=bias_grad)
    launch = plan_dx(dy.dtype, d, h, w, groups, cin, cout)
    if launch.regime != "f32":  # 16-byte copies of dy, y and the weight
        for name, t in (("dy", dy), ("y", y), ("weight", weight)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    dx = torch.empty((b, d, h, w, groups * cout), dtype=dy.dtype,
                     device=dy.device)
    g = (torch.empty_like(dy) if cotangent and fold != "none" else None)
    db = (torch.zeros(groups * cin, dtype=torch.float32, device=dy.device)
          if bias_grad else None)
    stats = (ds1, ds2) if fold == "stats" else (None, None)
    lib = load_kernel()
    with torch.cuda.device(dy.device):  # the launch goes to dy's card
        rc = lib.conv3d_fused_dx_launch(
            _DTYPES[dy.dtype], REGIMES[launch.regime], *launch.tile,
            launch.block_n, dy.data_ptr(),
            _ptr(None if fold == "none" else y), weight.data_ptr(),
            *(_ptr(m) for m in stats), FOLDS[fold], dx.data_ptr(), _ptr(g),
            _ptr(db), b, d, h, w, groups, cin, cout,
            torch.cuda.current_stream(dy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_fused_dx launch ({launch}) failed with "
                           f"CUDA error {rc}")
    conv3d_fused_dx.launches += 1
    conv3d_fused.launches += 1
    conv3d_fused.regime_launches[launch.regime] += 1
    if cotangent and g is None:
        g = dy
    return dx, g, db


conv3d_fused_dx.launches = 0


class Conv3dFusedFn(torch.autograd.Function):
    """K1b: K1 with a backward (``_banded_packed_ad*``'s custom VJP).

    Forward: K1 on x, weight, bias, with an epilogue activation or the
    (sum, sumsq) statistics of its output. Saved: x, the weight, and the
    output when there is an activation or statistics. Backward:

    1. dx, where x needs a gradient: :func:`conv3d_fused_dx`, one launch
       that folds the activation derivative or the statistics' cotangents
       into dy (:func:`fold_cotangent`), runs K1's regime for the swapped
       shape on the flipped, group-transposed forward weight, and writes
       the folded cotangent (for dW) and db; where x needs none (the
       first conv), the fold and db in torch;
    2. dW: the backward-weights contraction, a library call
       (``aten.convolution_backward``) on channels-last views of the
       NDHWC tensors, as the JAX package leaves it to XLA (:981-992);
       its float32 precision follows ``torch.backends.cudnn.allow_tf32``
       like any PyTorch convolution.

    On CPU tensors every step is the plain version.
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
        fold = ctx.activation
        if ctx.emit_stats:
            fold = "stats"
            ds1, ds2 = (None if m is None else m.contiguous()
                        for m in (ds1, ds2))
        groups = ctx.groups
        need_dw = ctx.needs_input_grad[1]
        need_db = ctx.bias_dtype is not None and ctx.needs_input_grad[2]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx, g, db = conv3d_fused_dx(dy.contiguous(), weight, groups,
                                        y=y, fold=fold, ds1=ds1, ds2=ds2,
                                        cotangent=need_dw,
                                        bias_grad=need_db)
            if dy.device.type == "cuda":
                conv3d_fused_train.launches += 1
        else:
            g = fold_cotangent(dy, y, fold, ds1, ds2).contiguous()
            db = _bias_sums(g) if need_db else None
        if need_dw:
            # NDHWC -> (N, C, D, H, W) views in channels-last-3d memory
            _, dw, _ = torch.ops.aten.convolution_backward(
                g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
                weight.permute(4, 3, 0, 1, 2), None, [1, 1, 1], [1, 1, 1],
                [1, 1, 1], False, [0, 0, 0], groups, [False, True, False])
            dw = dw.permute(2, 3, 4, 1, 0).contiguous()
        if db is not None:
            db = db.to(ctx.bias_dtype)
        return dx, dw, db, None, None, None


def conv3d_fused_train(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, groups: int = 1,
                       activation: str = "none", emit_stats: bool = False):
    """K1b: the differentiable K1. x (B, D, H, W, G*Cin), weight (3, 3, 3,
    Cin, G*Cout) in x's type, bias (G*Cout,) or None. Returns ``out``, or
    ``(out, (sum, sumsq))`` with ``emit_stats`` (then activation must be
    "none"); gradients flow through all of them. On CUDA tensors the
    backward launches the dx entry once for dx and counts it in
    ``launches``; on CPU tensors both directions run the plain
    versions."""
    res = Conv3dFusedFn.apply(x, weight, bias, groups, activation,
                              emit_stats)
    if emit_stats:
        return res[0], (res[1], res[2])
    return res


conv3d_fused_train.launches = 0


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and load K1's library (K1 and K1b's dx
    entry)."""
    lib = load_library("conv3d_fused", SOURCES)
    fn = lib.conv3d_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn = lib.conv3d_fused_dx_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 6 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return lib
