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

The training forward (:func:`grouped_forward_train`, :func:`train_forward`)
is the counterpart of ``grouped_forward_packed(trainable=True)`` (:471-590)
and ``packed_train_forward`` (:942-989): every 3x3x3 conv goes through
K1b (:func:`~values_tpu_torch.ops.kernels.conv3d.conv3d_fused_train`),
and the norms, pools, concats and transposed convs stay ordinary
differentiable torch ops.

:func:`group_member_variables` and :func:`ungroup_member_variables` move
between M flax-layout member trees and the grouped tree
(``values_tpu/models/ensemble_unet3d.py:187-256``); the joint ensemble
trainer keeps its parameters grouped. The sliding-window predictors
:func:`make_grouped_ensemble_predictor` and
:func:`make_grouped_aleatoric_predictor` run one fused forward over a
chunk of windows (``ensemble_unet3d_pallas.py:706-745``, :823-862).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.conv3d import (concat_groups, conv3d_fused,
                                  conv3d_fused_train)
from ..ops.uncertainty import aleatoric_softmax_samples
from .torch_import import TRANSPOSED

Maps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
NORM_EPS = 1e-5
# four 2x pools: every spatial dim must halve cleanly down to the center
PATCH_MULTIPLE = 16


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


def instance_norm_from_stats(x: torch.Tensor,
                             stats: Tuple[torch.Tensor, torch.Tensor]
                             ) -> torch.Tensor:
    """Affine-free instance norm of NDHWC ``x`` whose per-(item, channel)
    (sum, sumsq) came from the producing conv's epilogue
    (``_instance_norm_from_stats``, :448-468): normalized in the
    statistics' type (float32; float64 for a float64 run), returned in
    x's type. Gradients reach the statistics too."""
    n_vox = x.shape[1] * x.shape[2] * x.shape[3]
    ssum, ssq = stats
    mean = ssum / n_vox
    var = torch.clamp(ssq / n_vox - mean * mean, min=0.0)
    inv = torch.rsqrt(var + NORM_EPS)
    scale = inv[:, None, None, None, :]
    shift = (mean * inv)[:, None, None, None, :]
    return (x.to(ssum.dtype) * scale - shift).to(x.dtype)


def grouped_forward_train(weights: Mapping[str, Mapping[str, torch.Tensor]],
                          x: torch.Tensor, members: int,
                          apply_final: bool = True) -> torch.Tensor:
    """The differentiable grouped forward, without dropout.

    Args:
        weights: grouped weights in x's dtype (``{module: {"kernel",
            "bias"}}``, the layout of :func:`grouped_forward_fused`).
        x: (B, D, H, W, 1), tiled across members, or (B, D, H, W, M).
        members: the channel-group count M.
    Returns logits (B, D, H, W, M, C), or the pre-head features (B, D,
    H, W, M, F) with ``apply_final=False``. Norm blocks take their
    statistics from the conv's epilogue; the center and expand convs fuse
    their activation into it.
    """
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], members)
    x = x.contiguous()

    def block(v, name, norm=True, act="leaky"):
        prm = weights[name]
        if not norm:
            return conv3d_fused_train(v, prm["kernel"], prm["bias"], members,
                                      activation=act)
        y, stats = conv3d_fused_train(v, prm["kernel"], prm["bias"],
                                      members, emit_stats=True)
        v = instance_norm_from_stats(y, stats)
        return (torch.nn.functional.leaky_relu(v, 0.01) if act == "leaky"
                else torch.relu(v))

    def up(v, name):
        prm = weights[name]
        return (transpose_conv_k2s2(v, prm["kernel"])
                + prm["bias"].reshape(-1).to(v.dtype))

    skips = []
    v = x
    for lvl in (1, 2, 3, 4):
        v = block(block(v, f"contr_{lvl}_1"), f"contr_{lvl}_2")
        skips.append(v)
        v = max_pool_2x(v)
    c = block(v, "center_conv1", norm=False, act="relu")
    c = block(c, "center_conv2", norm=False, act="relu")
    e = torch.relu(up(c, "center_up"))
    for lvl in (4, 3, 2, 1):
        e = concat_groups(e, skips.pop(), members)
        e = block(e, f"expand_{lvl}_1", norm=False)
        e = block(e, f"expand_{lvl}_2", norm=False)
        if lvl > 1:
            e = up(e, f"upscale{lvl}")
    if not apply_final:
        return e.reshape(*e.shape[:-1], members, -1)
    head = weights.get("final_aleatoric") or weights["final"]
    return head_1x1(e, head["kernel"], head["bias"], members)


def single_member_tree(params: Mapping[str, Mapping]) -> Dict[str, Dict]:
    """A flax-layout UNet3D parameter tree as grouped weights at M=1
    (``_single_member_tree``, :927-939): conv blocks lose their ``conv``
    level, the transposed convs gain a leading member axis. Views, so
    gradients flow back to ``params``."""
    out = {}
    for name, leaves in params.items():
        leaves = leaves.get("conv", leaves)
        if name in TRANSPOSED:
            out[name] = {"kernel": leaves["kernel"][None],
                         "bias": leaves["bias"][None]}
        else:
            out[name] = dict(leaves)
    return out


def _split_head(out: torch.Tensor, params: Mapping, apply_final: bool):
    """(B, D, H, W, 1, C) -> (B, D, H, W, C), or (mu, s) for the
    aleatoric head."""
    flat = out.reshape(*out.shape[:4], out.shape[-1])
    if apply_final and "final_aleatoric" in params:
        mu, s = torch.chunk(flat, 2, dim=-1)
        return mu, s
    return flat


def train_forward(params: Mapping[str, Mapping], x: torch.Tensor,
                  apply_final: bool = True):
    """The differentiable single-model UNet3D forward of the training
    step (``packed_train_forward``, :942-989): flax-layout ``params`` (in
    x's dtype) and an NDHWC batch give logits (B, D, H, W, C), ``(mu, s)``
    with the aleatoric head, or the pre-head features with
    ``apply_final=False``."""
    out = grouped_forward_train(single_member_tree(params), x, 1,
                                apply_final=apply_final)
    return _split_head(out, params, apply_final)


def eval_forward(params: Mapping[str, Mapping], x: torch.Tensor):
    """The gradient-free single-model forward of the validation step
    (``_packed_val_apply``, experiment.py:309-330): the fused inference
    pipeline at M=1. Returns what :func:`train_forward` returns."""
    weights = {name: {leaf: t.detach().to(x.dtype).contiguous()
                      for leaf, t in leaves.items()}
               for name, leaves in single_member_tree(params).items()}
    with torch.no_grad():
        out = grouped_forward_fused(weights, x, 1)
    return _split_head(out, params, True)


def cast_weights(weights: Mapping[str, Mapping[str, torch.Tensor]],
                 dtype: torch.dtype, device: torch.device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Grouped weights moved to ``device`` in ``dtype``, contiguous."""
    return {name: {leaf: t.to(device=device, dtype=dtype).contiguous()
                   for leaf, t in leaves.items()}
            for name, leaves in weights.items()}


# 1x1x1 heads and bottleneck convs, grouped on the output channels
_HEADS = ("center_conv1", "center_conv2", "final", "final_aleatoric",
          "mean_conv", "log_cov_diag_conv", "cov_factor_conv")


def _numpy(a: Any) -> np.ndarray:
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def group_member_variables(member_variables: List[Mapping],
                           dtype=np.float32) -> Dict[str, Dict]:
    """M flax-layout UNet3D trees (numpy or tensors, ``{"params": ...}``
    or the bare tree) -> the grouped ``{"params": ...}`` tree of
    C-contiguous numpy arrays: conv blocks and heads concatenated on the
    output channels, the k2s2 transposed convs stacked on a leading
    member axis."""
    members = [v["params"] if "params" in v else v for v in member_variables]
    params: Dict[str, Dict[str, np.ndarray]] = {}
    names = ([k for k in members[0] if k.startswith(("contr_", "expand_"))]
             + [k for k in _HEADS if k in members[0]])
    for name in names:
        leaves = [m[name].get("conv", m[name]) for m in members]
        params[name] = {leaf: np.ascontiguousarray(np.concatenate(
            [_numpy(v[leaf]) for v in leaves], axis=-1), dtype=dtype)
            for leaf in ("kernel", "bias")}
    for name in TRANSPOSED:
        params[name] = {leaf: np.ascontiguousarray(np.stack(
            [_numpy(m[name][leaf]) for m in members]), dtype=dtype)
            for leaf in ("kernel", "bias")}
    return {"params": params}


def ungroup_member_variables(grouped: Mapping, members: int,
                             dtype=np.float32) -> List[Dict]:
    """The inverse of :func:`group_member_variables`: M flax-layout
    ``{"params": ...}`` trees of numpy arrays, conv blocks under their
    ``conv`` level."""
    params = grouped["params"] if "params" in grouped else grouped
    trees: List[Dict] = [{} for _ in range(members)]
    for name, leaves in params.items():
        kernel, bias = _numpy(leaves["kernel"]), _numpy(leaves["bias"])
        if name in TRANSPOSED:
            parts = [(kernel[m], bias[m]) for m in range(members)]
        else:
            parts = list(zip(np.split(kernel, members, axis=-1),
                             np.split(bias, members, axis=-1)))
        for m, (k, b) in enumerate(parts):
            leaf = {"kernel": k.astype(dtype), "bias": b.astype(dtype)}
            trees[m][name] = ({"conv": leaf}
                              if name.startswith(("contr_", "expand_"))
                              else leaf)
    return [{"params": t} for t in trees]


def stack_dtype(dtype: torch.dtype) -> torch.dtype:
    """Stacks leave a predictor in float32, or float64 in a float64 run
    (``values_tpu/inference/engine.py:195-205``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def make_grouped_ensemble_predictor(members: int):
    """``predict(weights, x, generator=None)`` -> ((M, B, D, H, W, C)
    softmax stack, None): one fused forward of the grouped ``weights``
    (:func:`cast_weights` layout) over x (B, D, H, W, 1), the softmax
    taken in float32."""
    def predict(weights, x, generator=None):
        logits = grouped_forward_fused(weights, x, members)
        probs = torch.softmax(logits.to(stack_dtype(x.dtype)), dim=-1)
        return probs.movedim(-2, 0), None
    return predict


def make_grouped_aleatoric_predictor(members: int,
                                     n_aleatoric_samples: int = 10):
    """``predict(weights, x, generator)`` -> ((M*S, B, D, H, W, C) softmax
    stack, sigma stack of the same shape), member-major then sample, as
    the JAX package orders its keys: one fused forward gives (mu, s) per
    member, ``eps`` (M, S, B, D, H, W, C) is drawn from ``generator`` in
    the stacks' type, and :func:`aleatoric_softmax_samples` maps them."""
    def predict(weights, x, generator: Optional[torch.Generator]):
        out = grouped_forward_fused(weights, x, members)
        out = out.to(stack_dtype(x.dtype)).movedim(-2, 0)  # (M, B, .., 2C)
        mu, s = torch.chunk(out, 2, dim=-1)
        eps = torch.randn((members, n_aleatoric_samples) + tuple(mu.shape[1:]),
                          generator=generator, dtype=mu.dtype,
                          device=mu.device)
        return aleatoric_softmax_samples(mu, s, eps)
    return predict
