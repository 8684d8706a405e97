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
and the norms, pools, concats, dropout masks and transposed convs stay
ordinary differentiable torch ops. :func:`ssn_train_forward` is the
SSN's (``packed_ssn_train_forward``, :992-1035).

:func:`group_member_variables` and :func:`ungroup_member_variables` move
between M flax-layout member trees and the grouped tree
(``values_tpu/models/ensemble_unet3d.py:187-256``); the joint ensemble
trainer keeps its parameters grouped. The sliding-window predictors
:func:`make_grouped_ensemble_predictor` and
:func:`make_grouped_aleatoric_predictor` run one fused forward over a
chunk of windows (``ensemble_unet3d_pallas.py:706-745``, :823-862).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels.conv3d import (concat_groups, conv3d_fused,
                                  conv3d_fused_train)
from ..ops.uncertainty import aleatoric_softmax_samples
from .ssn_unet3d import SSN_HEADS, LowRankMVN, ssn_distribution
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
    # the interleave: this reshape copies the permuted GEMM output once
    # (aten::clone of the 9-D view), as the JAX packed forward's step (3)
    # transpose does (values_tpu/models/ensemble_unet3d_pallas.py::
    # _transpose_conv_k2s2)
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
                          x: torch.Tensor, members: int,
                          apply_final: bool = True) -> torch.Tensor:
    """The deterministic grouped ensemble forward.

    Args:
        weights: ``{module: {"kernel", "bias"}}`` grouped weights, already
            in x's dtype and on x's device.
        x: (B, D, H, W, 1) input, tiled across members, or (B, D, H, W,
            M) with one channel per member. D, H and W divisible by 16.
        members: ensemble size M (the channel-group count).
        apply_final: False returns the pre-head trunk features (the SSN
            heads' input).
    Returns logits (B, D, H, W, M, C) in x's dtype (2C channels per
    member with an aleatoric head), or the features (B, D, H, W, M, F).
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

    if not apply_final:
        return e.reshape(*e.shape[:-1], members, -1)
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
                          apply_final: bool = True,
                          keep_masks: Optional[Sequence[torch.Tensor]] = None
                          ) -> torch.Tensor:
    """The differentiable grouped forward; with ``keep_masks``, the
    MC-dropout forward (``grouped_forward_packed(do_dropout=True)``,
    :498-590, which never takes the fused path either).

    Args:
        weights: grouped weights in x's dtype (``{module: {"kernel",
            "bias"}}``, the layout of :func:`grouped_forward_fused`).
        x: (B, D, H, W, 1), tiled across members, or (B, D, H, W, M).
        members: the channel-group count M.
        keep_masks: None, or the 17 boolean keep masks of one dropout
            pass in site order (:func:`dropout_site_shapes`); a kept value
            is doubled, a dropped one is 0 (``_dropout``, :172-175). Each
            group's channels have their own mask, so the members' draws
            are independent.
    Returns logits (B, D, H, W, M, C), or the pre-head features (B, D,
    H, W, M, F) with ``apply_final=False``. Norm blocks take their
    statistics from the conv's epilogue; the center and expand convs fuse
    their activation into it.
    """
    if x.shape[-1] == 1:
        x = x.expand(*x.shape[:-1], members)
    x = x.contiguous()
    masks = None if keep_masks is None else iter(keep_masks)

    def drop(v):
        if masks is None:
            return v
        return torch.where(next(masks), v * 2.0, torch.zeros_like(v))

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

    def drop_block(v, name, norm=True):
        return drop(block(v, name, norm=norm))

    def up(v, name):
        prm = weights[name]
        return (transpose_conv_k2s2(v, prm["kernel"])
                + prm["bias"].reshape(-1).to(v.dtype))

    skips = []
    v = x
    for lvl in (1, 2, 3, 4):
        v = drop_block(drop_block(v, f"contr_{lvl}_1"), f"contr_{lvl}_2")
        skips.append(v)
        v = max_pool_2x(v)
    c = block(v, "center_conv1", norm=False, act="relu")
    c = block(c, "center_conv2", norm=False, act="relu")
    e = drop(torch.relu(up(c, "center_up")))
    for lvl in (4, 3, 2, 1):
        e = concat_groups(e, skips.pop(), members)
        e = drop_block(e, f"expand_{lvl}_1", norm=False)
        e = drop_block(e, f"expand_{lvl}_2", norm=False)
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
                  apply_final: bool = True,
                  keep_masks: Optional[Sequence[torch.Tensor]] = None):
    """The differentiable single-model UNet3D forward of the training
    step (``packed_train_forward``, :942-989): flax-layout ``params`` (in
    x's dtype) and an NDHWC batch give logits (B, D, H, W, C), ``(mu, s)``
    with the aleatoric head, or the pre-head features with
    ``apply_final=False``. ``keep_masks``: a dropout model's 17 masks of
    the step (:func:`draw_keep_masks`)."""
    out = grouped_forward_train(single_member_tree(params), x, 1,
                                apply_final=apply_final,
                                keep_masks=keep_masks)
    return _split_head(out, params, apply_final)


def eval_forward(params: Mapping[str, Mapping], x: torch.Tensor,
                 apply_final: bool = True):
    """The gradient-free single-model forward of the validation step
    (``_packed_val_apply``, experiment.py:309-330): the fused inference
    pipeline at M=1, without dropout. Returns what :func:`train_forward`
    returns."""
    weights = {name: {leaf: t.detach().to(x.dtype).contiguous()
                      for leaf, t in leaves.items()}
               for name, leaves in single_member_tree(params).items()}
    with torch.no_grad():
        out = grouped_forward_fused(weights, x, 1, apply_final=apply_final)
    return _split_head(out, params, apply_final)


def ssn_heads(params: Mapping[str, Mapping], dtype: torch.dtype
              ) -> Dict[str, Tuple]:
    """The SSN's three 1x1x1 heads of a flax-layout tree as
    :func:`~values_tpu_torch.models.ssn_unet3d.ssn_distribution` takes
    them, in ``dtype`` (from the tree's own type: a bf16 step's heads are
    its bf16-rounded weights)."""
    out = {}
    for name in SSN_HEADS:
        kernel = params[name]["kernel"]
        out[name] = (kernel.reshape(kernel.shape[-2], kernel.shape[-1])
                     .to(dtype), params[name]["bias"].to(dtype))
    return out


def ssn_train_forward(params: Mapping[str, Mapping], x: torch.Tensor,
                      num_classes: int, rank: int, epsilon: float = 1e-5,
                      mean_only: bool = False,
                      keep_masks: Optional[Sequence[torch.Tensor]] = None,
                      trainable: bool = True) -> LowRankMVN:
    """The SSN's training form (``packed_ssn_train_forward``, :992-1035):
    the trunk of :func:`train_forward` without its head (K1 forward, K1b
    backward), or of the fused :func:`eval_forward` with ``trainable``
    False (the validation step's), its features cast to float32 (a
    float64 run stays in float64), then the three heads in that type;
    ``mean_only`` (pretraining) gives a zero factor."""
    features = (train_forward(params, x, apply_final=False,
                              keep_masks=keep_masks) if trainable
                else eval_forward(params, x, apply_final=False))
    dtype = torch.promote_types(features.dtype, torch.float32)
    return ssn_distribution(features.to(dtype), ssn_heads(params, dtype),
                            num_classes, rank, epsilon, mean_only)


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


def member_slice(weights: Mapping[str, Mapping[str, torch.Tensor]],
                 lo: int, hi: int, members: int
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Members [lo, hi) of M grouped ``weights`` (:func:`cast_weights`
    layout) as the grouped weights of hi - lo members: the transposed
    convs' member rows, every other leaf's member blocks of its output
    channels, contiguous (K1 takes its weights so)."""
    if (lo, hi) == (0, members):
        return {name: dict(leaves) for name, leaves in weights.items()}
    out = {}
    for name, leaves in weights.items():
        if name in TRANSPOSED:
            out[name] = {k: v[lo:hi].contiguous() for k, v in leaves.items()}
        else:
            out[name] = {k: v[..., lo * (v.shape[-1] // members):
                               hi * (v.shape[-1] // members)].contiguous()
                         for k, v in leaves.items()}
    return out


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


def grouped_aleatoric_heads(weights, x: torch.Tensor, members: int):
    """(mu, s), each (M, B, D, H, W, C) in the stacks' type: one fused
    forward of the grouped aleatoric model."""
    out = grouped_forward_fused(weights, x, members)
    out = out.to(stack_dtype(x.dtype)).movedim(-2, 0)  # (M, B, .., 2C)
    mu, s = torch.chunk(out, 2, dim=-1)
    return mu, s


def make_grouped_aleatoric_predictor(members: int,
                                     n_aleatoric_samples: int = 10):
    """``predict(weights, x, generator)`` -> ((M*S, B, D, H, W, C) softmax
    stack, sigma stack of the same shape), member-major then sample, as
    the JAX package orders its keys: one fused forward gives (mu, s) per
    member, ``eps`` (M, S, B, D, H, W, C) is drawn from ``generator`` in
    the stacks' type, and :func:`aleatoric_softmax_samples` maps them."""
    def predict(weights, x, generator: Optional[torch.Generator]):
        mu, s = grouped_aleatoric_heads(weights, x, members)
        eps = torch.randn((members, n_aleatoric_samples) + tuple(mu.shape[1:]),
                          generator=generator, dtype=mu.dtype,
                          device=mu.device)
        return aleatoric_softmax_samples(mu, s, eps)
    return predict


# -- MC dropout, TTA and SSN ---------------------------------------------------

DROPOUT_SITES = 17
# the 7 flip-axis combinations of test_3D.py:434 on the NDHWC spatial axes
# 1-3 (values_tpu/inference/predictors.py:35-36)
FLIP_COMBOS: Tuple[Tuple[int, ...], ...] = ((1,), (2,), (3,), (1, 2),
                                            (1, 3), (2, 3), (1, 2, 3))


def draw_dropout_masks(shapes: Sequence[Tuple[int, ...]],
                       generator: Optional[torch.Generator], device
                       ) -> List[torch.Tensor]:
    """The keep masks of one dropout pass, one boolean tensor per shape,
    each value kept with probability 0.5."""
    return [torch.empty(shape, dtype=torch.bool, device=device).bernoulli_(
        0.5, generator=generator) for shape in shapes]


def draw_tta_noise(generator: Optional[torch.Generator],
                   shape: Tuple[int, ...], dtype: torch.dtype, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TTA's noise draw for one input: ``variance`` ~ U(0, 0.1), a
    0-dimensional tensor, and a standard normal field of ``shape``. The
    noisy input is ``x + noise * variance``: batchgenerators draws a
    variance and passes it as the normal's scale
    (``values_tpu/inference/predictors.py:92-95``)."""
    variance = torch.rand((), generator=generator, dtype=dtype,
                          device=device) * 0.1
    noise = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
    return variance, noise


def dropout_site_shapes(weights: Mapping[str, Mapping[str, torch.Tensor]],
                        x_shape: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """The NDHWC shapes of the 17 dropout sites of a grouped forward of
    an input of ``x_shape`` (B, D, H, W, ·), in the order the forward
    drops out: the 8 contract blocks, the center, the 8 expand blocks."""
    b, d, h, w = x_shape[:4]

    def at(lvl, name):
        k = 2 ** (lvl - 1)
        return (b, d // k, h // k, w // k, weights[name]["kernel"].shape[-1])

    shapes = [at(lvl, f"contr_{lvl}_{i}") for lvl in (1, 2, 3, 4)
              for i in (1, 2)]
    up = weights["center_up"]["kernel"]
    shapes.append((b, d // 8, h // 8, w // 8, up.shape[0] * up.shape[-1]))
    shapes += [at(lvl, f"expand_{lvl}_{i}") for lvl in (4, 3, 2, 1)
               for i in (1, 2)]
    return shapes


def draw_keep_masks(weights: Mapping[str, Mapping[str, torch.Tensor]],
                    x_shape: Tuple[int, ...],
                    generator: Optional[torch.Generator], device
                    ) -> List[torch.Tensor]:
    """The 17 keep masks of one training step of the grouped ``weights``
    (:func:`single_member_tree` at M = 1) on an input of ``x_shape``:
    :func:`draw_dropout_masks` at :func:`dropout_site_shapes`. The masks
    span all M*C channels of a site, so each member's group has its own."""
    return draw_dropout_masks(dropout_site_shapes(weights, x_shape),
                              generator, device)


def dropout_forward(weights: Mapping[str, Mapping[str, torch.Tensor]],
                    x: torch.Tensor, members: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """One MC-dropout pass of the grouped ensemble, for serving: draws
    the pass's 17 keep masks (:func:`draw_dropout_masks`) and runs
    :func:`grouped_forward_train` with them under inference mode. Every
    norm conv is K1 with its statistics and no prologue, every other 3x3x3
    conv K1 with its epilogue activation: 18 launches. Returns logits
    (B, D, H, W, M, C) in x's dtype."""
    masks = draw_dropout_masks(dropout_site_shapes(weights, tuple(x.shape)),
                               generator, x.device)
    with torch.inference_mode():
        return grouped_forward_train(weights, x, members, keep_masks=masks)


def tta_inputs(x: torch.Tensor, generator: Optional[torch.Generator]):
    """The 16 TTA variants of x (B, D, H, W, 1) in the reference order
    ``[clean, clean flips..., noisy, noisy flips...]``
    (test_3D.py:427-456), each with the axes to un-flip its output
    along: a generator of ``(input, axes)``. The noise is drawn (in x's
    type) before the first variant."""
    variance, noise = draw_tta_noise(generator, tuple(x.shape), x.dtype,
                                     x.device)
    x_noise = x + noise * variance
    for base in (x, x_noise):
        for axes in ((),) + FLIP_COMBOS:
            yield (torch.flip(base, axes) if axes else base), axes


def member_heads(weights: Mapping[str, Mapping[str, torch.Tensor]],
                 member: int, members: int, dtype: torch.dtype):
    """Member ``member``'s SSN heads from the grouped weights: ``{name:
    (kernel (F, cout), bias (cout,))}`` in ``dtype``."""
    out = {}
    for name in SSN_HEADS:
        kernel, bias = weights[name]["kernel"], weights[name]["bias"]
        f = kernel.shape[3]
        out[name] = (kernel.reshape(f, members, -1)[:, member].to(dtype),
                     bias.reshape(members, -1)[member].to(dtype))
    return out


def make_grouped_dropout_predictor(members: int, n_pred: int,
                                   do_dropout: bool = True):
    """``predict(weights, x, generator)`` -> ((M*n_pred, B, D, H, W, C)
    softmax stack, None), member-major then pass, as the JAX package
    orders its samples (``predictors.py:56-75``): ``n_pred`` dropout
    passes at G = M (:func:`dropout_forward`), each drawing its own
    masks. Without ``do_dropout`` the passes are one deterministic
    forward repeated, as the JAX predictor's are."""
    def predict(weights, x, generator=None):
        if not do_dropout:
            probs, _ = make_grouped_ensemble_predictor(members)(weights, x)
            return probs.repeat_interleave(n_pred, dim=0), None
        passes = [torch.softmax(dropout_forward(weights, x, members,
                                                generator)
                                .to(stack_dtype(x.dtype)), dim=-1)
                  for _ in range(n_pred)]
        probs = torch.stack(passes, dim=-2)       # (B, .., M, n_pred, C)
        return probs.flatten(-3, -2).movedim(-2, 0), None
    return predict


def make_grouped_tta_predictor(members: int, do_dropout: bool = False):
    """``predict(weights, x, generator)`` -> ((M*16, B, D, H, W, C)
    softmax stack, None), member-major then variant
    (``values_tpu/models/ensemble_unet3d.py:389-435``): the 16 variants of
    :func:`tta_inputs` run as 16 forwards at G = M (the fused forward, or
    a dropout pass with its own masks when the model has dropout, which
    stays live per variant), each output un-flipped."""
    def predict(weights, x, generator=None):
        outs = []
        for xv, axes in tta_inputs(x, generator):
            logits = (dropout_forward(weights, xv, members, generator)
                      if do_dropout
                      else grouped_forward_fused(weights, xv, members))
            p = torch.softmax(logits.to(stack_dtype(x.dtype)), dim=-1)
            outs.append(torch.flip(p, axes) if axes else p)
        probs = torch.stack(outs, dim=-2)         # (B, .., M, 16, C)
        return probs.flatten(-3, -2).movedim(-2, 0), None
    return predict


def grouped_ssn_distributions(weights, x: torch.Tensor, members: int,
                              num_classes: int, rank: int = 10,
                              epsilon: float = 1e-5) -> List[LowRankMVN]:
    """Each member's low-rank normal over its logits: one grouped trunk
    forward, then the member's three 1x1x1 heads in the stacks' type."""
    dtype = stack_dtype(x.dtype)
    feats = grouped_forward_fused(weights, x, members, apply_final=False)
    return [ssn_distribution(feats[..., m, :].to(dtype),
                             member_heads(weights, m, members, dtype),
                             num_classes, rank, epsilon)
            for m in range(members)]


def make_grouped_ssn_predictor(members: int, num_classes: int, n_pred: int,
                               rank: int = 10, epsilon: float = 1e-5):
    """``predict(weights, x, generator)`` -> ((M*n_pred, B, D, H, W, C)
    softmax stack, None), member-major (``values_tpu/models/
    ensemble_unet3d.py:324-386``): one grouped trunk forward, each
    member's three 1x1x1 heads in the stacks' type, one low-rank normal
    over a batch of M*B (member-major) and ``n_pred`` samples of it drawn
    at once."""
    def predict(weights, x, generator=None):
        dists = grouped_ssn_distributions(weights, x, members, num_classes,
                                          rank, epsilon)
        dist = LowRankMVN(*(torch.cat(t) for t in zip(
            *((d.mean, d.cov_diag, d.cov_factor) for d in dists))))
        samples = dist.rsample(generator, n_pred)   # (S, M*B, C*V)
        b, spatial = x.shape[0], tuple(x.shape[1:4])
        logits = samples.reshape((n_pred, members, b, num_classes)
                                 + spatial).transpose(0, 1)
        logits = logits.reshape((members * n_pred, b, num_classes)
                                + spatial).movedim(2, -1)
        return torch.softmax(logits, dim=-1), None
    return predict
