"""Grouped ensemble UNet3D forward on the fused conv kernel (K1), NDHWC.

Counterpart of ``values_tpu/models/ensemble_unet3d_pallas.py::
_grouped_forward_fused`` (:593-703) with its map plumbing (``_norm_maps``
:396, ``_identity_maps`` :428, ``_concat_maps`` :433), the 1x1x1 head of
``_conv`` (:257-276) and ``_transpose_conv_k2s2`` (:198); the grouped
math is that of ``values_tpu/models/ensemble_unet3d.py::EnsembleUNet3D``
(:66). M members run as M channel groups of one network.

Every 3x3x3 convolution goes through
:func:`values_tpu_torch.ops.kernels.conv3d.conv3d_fused`, and the
network is arranged so the kernel's fusions carry everything between
convolutions:

- max-pool commutes with instance norm + leaky ReLU (both monotone
  increasing, the norm's scale rsqrt(var + eps) > 0), so pooling runs on
  the RAW conv output and each norm + activation is deferred to the
  consuming conv's prologue, with the statistics taken from the
  producing conv's epilogue;
- the decoder's skip concat is the kernel's second input, with per-part
  prologue maps: the upsampled half gets its bias and activation (shift
  = -bias, slope 0 after the center ReLU, 1 after the plain upscales),
  the skip half its encoder norm + leaky slope;
- ReLU/leaky activations without a norm ride the epilogue.

The k2s2 transposed convs and the 1x1x1 head are plain per-member
matrix products, as XLA computes them outside Pallas in the JAX package.
Tensors are plain NDHWC; none of the JAX package's lane packing is
carried over. Weights are the grouped layout of
:func:`values_tpu_torch.models.torch_import.group_member_state_dicts`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..ops.kernels.conv3d import conv3d_fused

Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
NORM_EPS = 1e-5


def norm_maps(stats: Tuple[torch.Tensor, torch.Tensor], n_vox: int,
              slope: float) -> Maps:
    """(sum, sumsq) (B, C) of a conv's output -> the consumer's prologue
    maps (scale, shift, slope) applying instance norm + activation:
    ``max(u, u*slope)`` with ``u = x*rsqrt(var+eps) - mean*rsqrt(..)``."""
    ssum, ssq = stats
    mean = ssum / n_vox
    var = torch.clamp(ssq / n_vox - mean * mean, min=0.0)
    inv = torch.rsqrt(var + NORM_EPS)
    return inv, mean * inv, torch.full_like(inv, slope)


def bias_maps(bias: torch.Tensor, batch: int, slope: float) -> Maps:
    """Prologue maps adding ``bias`` (C,) and applying an activation of
    the given slope: scale 1, shift -bias."""
    shift = -bias.to(torch.float32).expand(batch, -1)
    one = torch.ones_like(shift)
    return one, shift, torch.full_like(shift, slope)


def concat_maps(m1: Maps, m2: Maps, groups: int) -> Maps:
    """Per-group channel concat of two map triples, in the kernel's
    per-group [part1, part2] channel order."""
    out = []
    for a, b in zip(m1, m2):
        n = a.shape[0]
        out.append(torch.cat([a.reshape(n, groups, -1),
                              b.reshape(n, groups, -1)], dim=-1)
                   .reshape(n, -1).contiguous())
    return tuple(out)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 max pool of an NDHWC tensor with even spatial dims."""
    b, d, h, w, c = x.shape
    return x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c).amax(
        dim=(2, 4, 6))


def transpose_conv_k2s2(x: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """Per-member ConvTranspose(k=2, s=2), without its bias, of NDHWC
    ``x`` (B, D, H, W, M*Cin) with ``kernel`` (M, 2, 2, 2, Cin, Cout):
    out[b, 2d+a, 2h+e, 2w+f, m*Cout+o] = sum_i x[b, d, h, w, m*Cin+i]
    * kernel[m, a, e, f, i, o]. The bias rides the consumer's prologue."""
    b, d, h, w, mc = x.shape
    m, cin, cout = kernel.shape[0], kernel.shape[4], kernel.shape[5]
    xm = x.reshape(-1, m, cin).transpose(0, 1)           # (M, N, Cin)
    k = kernel.permute(0, 4, 1, 2, 3, 5).reshape(m, cin, 8 * cout)
    y = torch.bmm(xm, k.to(x.dtype))                      # (M, N, 8*Cout)
    y = y.reshape(m, b, d, h, w, 2, 2, 2, cout)
    return y.permute(1, 2, 5, 3, 6, 4, 7, 0, 8).reshape(
        b, 2 * d, 2 * h, 2 * w, m * cout)


def head_1x1(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
             members: int) -> torch.Tensor:
    """Per-member 1x1x1 conv: x (B, D, H, W, M*F), kernel (1, 1, 1, F,
    M*C) -> (B, D, H, W, M, C)."""
    f = kernel.shape[3]
    k = kernel.reshape(f, members, -1).to(x.dtype)
    xm = x.reshape(*x.shape[:-1], members, f)
    out = torch.einsum("...mi,imo->...mo", xm, k)
    return out + bias.reshape(members, -1).to(out.dtype)


def grouped_forward_fused(weights: Mapping[str, Mapping[str, torch.Tensor]],
                          x: torch.Tensor, members: int) -> torch.Tensor:
    """The deterministic grouped ensemble forward.

    Args:
        weights: ``{module: {"kernel", "bias"}}`` grouped weights, already
            in x's dtype and on x's device.
        x: (B, D, H, W, 1) input, tiled across members, or (B, D, H, W,
            M) with one channel per member. D, H and W divisible by 16.
        members: ensemble size M (the channel-group count).
    Returns logits (B, D, H, W, M, C) in x's dtype (2C channels per
    member with an aleatoric head).
    """
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], members)
    x = x.contiguous()

    def conv(v, name, **kw):
        prm = weights[name]
        return conv3d_fused(v, prm["kernel"], prm["bias"], members, **kw)

    # encoder: conv(+stats) -> conv(norm prologue, +stats) -> raw pool
    skips = []  # (raw conv output, its norm maps)
    v, prev_maps = x, None
    for lvl in (1, 2, 3, 4):
        n_vox = v.shape[1] * v.shape[2] * v.shape[3]
        y1, st1 = conv(v, f"contr_{lvl}_1", prologue=prev_maps,
                       emit_stats=True)
        y2, st2 = conv(y1, f"contr_{lvl}_2",
                       prologue=norm_maps(st1, n_vox, 0.01),
                       emit_stats=True)
        prev_maps = norm_maps(st2, n_vox, 0.01)
        skips.append((y2, prev_maps))
        v = max_pool_2x(y2)

    # bottleneck; the upscale's bias and ReLU ride the next prologue
    c = conv(v, "center_conv1", prologue=prev_maps, activation="relu")
    c = conv(c, "center_conv2", activation="relu")
    e = transpose_conv_k2s2(c, weights["center_up"]["kernel"])
    up_bias, up_slope = weights["center_up"]["bias"].reshape(-1), 0.0

    # decoder: split-input convs, the skip normalized in the prologue
    for lvl in (4, 3, 2, 1):
        skip, skip_maps = skips.pop()
        up_maps = bias_maps(up_bias, e.shape[0], up_slope)
        e = conv(e, f"expand_{lvl}_1", x2=skip,
                 prologue=concat_maps(up_maps, skip_maps, members),
                 activation="leaky")
        e = conv(e, f"expand_{lvl}_2", activation="leaky")
        if lvl > 1:
            e = transpose_conv_k2s2(e, weights[f"upscale{lvl}"]["kernel"])
            up_bias = weights[f"upscale{lvl}"]["bias"].reshape(-1)
            up_slope = 1.0  # plain upscales pass through unactivated

    head = weights.get("final_aleatoric") or weights["final"]
    return head_1x1(e, head["kernel"], head["bias"], members)


def cast_weights(weights: Mapping[str, Mapping[str, torch.Tensor]],
                 dtype: torch.dtype, device: torch.device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Grouped weights moved to ``device`` in ``dtype``, contiguous."""
    return {name: {leaf: t.to(device=device, dtype=dtype).contiguous()
                   for leaf, t in leaves.items()}
            for name, leaves in weights.items()}
