"""HRNet-W48 2D backbone (C0) as a plain ``nn.Module``, NCHW.

Counterpart of ``values_tpu/models/hrnet.py:42-305``, itself the
reference's ``uncertainty_modeling/models/hrnet_module.py:44-745`` (the
public Microsoft HRNetV2): a stem of two stride-2 3x3 convs, the stage-1
bottleneck layer, three multi-branch stages of ``HighResolutionModule``s
with transition layers, a bilinear multi-scale fuse (align_corners
False), and a head that concatenates the four upsampled branches, runs a
1x1 conv + BN + ReLU + classifier and upsamples to the input size.

Submodules carry the reference's names, so the port's ``state_dict()``
keys are the reference's torch keys (``conv1``, ``layer1.0.downsample.0``,
``stage2.0.branches.1.3.conv2``, ``stage3.1.fuse_layers.2.0.1.0``,
``last_layer.3``, ``cov_factor_conv.0``, ...) and a reference ``.ckpt``
loads without a rewrite. :func:`get_seg_model` returns it in eval mode,
where BatchNorm runs on its running statistics (eps 1e-5). In training
mode (``model.train()``, the 2D trainer) BatchNorm normalizes with the
batch's statistics and updates its running ones as flax's ``BatchNorm``
does in the JAX package (:class:`BatchNorm2d`): with the *biased* batch
variance, ``r = 0.9 r + 0.1 v`` (torch's own update takes the unbiased
one; ROADMAP.md reference hazard R12). Options:

- per-branch dropout inside BasicBlocks (the configs' STAGE3/4
  ``DROPOUT``), p = 0.5 after the first ReLU: live in training mode,
  identity in eval mode. (The JAX trainer leaves these deterministic:
  its HRNet has no ``do_dropout``; the reference's torch module trains
  with them live, as here.);
- ``DROPOUT_FINAL``: p = 0.5 dropout on the four branch outputs on every
  pass, in every mode -- the 2D MC-dropout mechanism
  (hrnet_module.py:642-646). Its keep masks, and the branch dropouts',
  are drawn with ``torch.rand`` from the ``generator`` that ``forward``
  must then be given (:func:`dropout_final`);
- the SSN head: a rank-R low-rank normal
  (:class:`~values_tpu_torch.models.ssn_unet3d.LowRankMVN`) over the
  flattened (class, pixel) logits. As in the reference, ``cov_diag`` is
  the exp of the SAME ``last_layer`` output as the mean
  (hrnet_module.py:559-573).
"""
from __future__ import annotations

import contextvars
from typing import Any, Dict, List, Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..parallel.collectives import current_shard, draw_rows, global_sum
from .ssn_unet3d import LowRankMVN

BN_MOMENTUM = 0.1
DROPOUT_FINAL_RATE = 0.5


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=bias)


# the running updates a training forward defers to its end (one pair of
# foreach ops for all 306 BatchNorms instead of a few ops each)
_PENDING = contextvars.ContextVar("hrnet_pending_bn_updates", default=None)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running update is flax's:
    the batch mean and *biased* variance, computed in float32 (float64
    for float64 input), enter ``r = (1 - m) r + m s`` with m =
    ``BN_MOMENTUM`` (flax's momentum 0.9, ``values_tpu/models/hrnet.py``
    :33, :82-86); inside :class:`HighResolutionNet`'s forward the update
    waits for the forward's end (:func:`update_running_stats`). The
    normalization itself is torch's (biased variance in both). Eval mode
    is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        shard = current_shard()
        if shard is not None and shard.size > 1:
            return self._synced(x, shard)
        with torch.no_grad():
            stats = x if x.dtype == torch.float64 else x.to(torch.float32)
            var, mean = torch.var_mean(stats, dim=(0, 2, 3), unbiased=False)
        pending = _PENDING.get()
        if pending is None:
            update_running_stats([(self, mean, var)])
        else:
            pending.append((self, mean, var))
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _synced(self, x: torch.Tensor, shard) -> torch.Tensor:
        """Training mode inside a data-parallel step: the mean and biased
        variance over the global batch (two differentiable all-reduces
        over the data axis, in float32 or float64), as the JAX package's
        jit over the mesh takes them; the running update as above, with
        those statistics. Returns float32 (float64 for float64 input),
        as ``F.batch_norm`` does under autocast."""
        compute = torch.float64 if x.dtype == torch.float64 \
            else torch.float32
        xc = x.to(compute)
        count = shard.size * xc.numel() // xc.shape[1]
        mean = global_sum(xc.sum(dim=(0, 2, 3))) / count
        centred = xc - mean[None, :, None, None]
        var = global_sum((centred * centred).sum(dim=(0, 2, 3))) / count
        pending = _PENDING.get()
        stats = (self, mean.detach(), var.detach())
        if pending is None:
            update_running_stats([stats])
        else:
            pending.append(stats)
        scale = self.weight.to(compute) * torch.rsqrt(var + self.eps)
        return (centred * scale[None, :, None, None]
                + self.bias.to(compute)[None, :, None, None])


def update_running_stats(updates) -> None:
    """``r = (1 - m) r + m s`` for each (BatchNorm, batch mean, batch
    variance) of ``updates``, two foreach ops per statistic."""
    if not updates:
        return
    keep = 1.0 - BN_MOMENTUM
    with torch.no_grad():
        for index, name in ((1, "running_mean"), (2, "running_var")):
            running = [getattr(u[0], name) for u in updates]
            torch._foreach_mul_(running, keep)
            torch._foreach_add_(running, [u[index].to(r.dtype) for u, r in
                                          zip(updates, running)],
                                alpha=1.0 - keep)


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=BN_MOMENTUM)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(method="bilinear")`` for the upsamplings HRNet
    takes: ``F.interpolate`` with align_corners False."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None,
                 dropout: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.downsample = downsample
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        if self.dropout and self.training:
            out = dropout_final(out, generator)
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, **_kw):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = _bn(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _layer(block: str, inplanes: int, planes: int, n_blocks: int,
           stride: int = 1, dropout: bool = False) -> nn.Sequential:
    cls = BLOCKS[block]
    downsample = None
    if stride != 1 or inplanes != planes * cls.expansion:
        downsample = nn.Sequential(
            _conv(inplanes, planes * cls.expansion, 1, stride),
            _bn(planes * cls.expansion))
    layers = [cls(inplanes, planes, stride, downsample, dropout=dropout)]
    layers += [cls(planes * cls.expansion, planes, dropout=dropout)
               for _ in range(1, n_blocks)]
    return nn.Sequential(*layers)


def _run_layer(layer: nn.Sequential, x: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    for block in layer:
        x = block(x, generator)
    return x


class HighResolutionModule(nn.Module):
    """One multi-branch module (hrnet_module.py:122-336): a layer per
    branch, then every branch fused into every other, summed, ReLU."""

    def __init__(self, stage_cfg: Dict, inchannels: List[int]):
        super().__init__()
        block = stage_cfg["BLOCK"]
        expansion = BLOCKS[block].expansion
        n = stage_cfg["NUM_BRANCHES"]
        channels = [c * expansion for c in stage_cfg["NUM_CHANNELS"]]
        dropout = stage_cfg.get("DROPOUT", [False] * n)
        self.branches = nn.ModuleList(
            _layer(block, inchannels[b], stage_cfg["NUM_CHANNELS"][b],
                   stage_cfg["NUM_BLOCKS"][b], dropout=bool(dropout[b]))
            for b in range(n))
        self.fuse_layers = None
        if n > 1:
            self.fuse_layers = nn.ModuleList(
                nn.ModuleList(self._fuse(channels, i, j) for j in range(n))
                for i in range(n))
        self.out_channels = channels

    @staticmethod
    def _fuse(channels: List[int], i: int, j: int) -> Optional[nn.Module]:
        if j == i:
            return None
        if j > i:  # 1x1 to branch i's channels; upsampled in forward
            return nn.Sequential(_conv(channels[j], channels[i], 1),
                                 _bn(channels[i]))
        steps = []
        for k in range(i - j):
            last = k == i - j - 1
            cout = channels[i] if last else channels[j]
            step = [_conv(channels[j], cout, 3, 2), _bn(cout)]
            if not last:
                step.append(nn.ReLU())
            steps.append(nn.Sequential(*step))
        return nn.Sequential(*steps)

    def forward(self, xs: List[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        xs = [_run_layer(branch, x, generator)
              for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, fuse in enumerate(row):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = resize_bilinear(fuse(xs[j]), xs[i].shape[2:])
                else:
                    t = fuse(xs[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


def _transition(pre: List[int], cur: List[int]) -> nn.ModuleList:
    """_make_transition_layer (hrnet_module.py:457-502): a 3x3 conv where
    a kept branch changes width, stride-2 convs from the last branch for
    each new one, None where a branch passes through."""
    layers: List[Optional[nn.Module]] = []
    for i in range(len(cur)):
        if i < len(pre):
            layers.append(None if cur[i] == pre[i] else nn.Sequential(
                _conv(pre[i], cur[i], 3), _bn(cur[i]), nn.ReLU()))
            continue
        steps = []
        for j in range(i + 1 - len(pre)):
            cout = cur[i] if j == i - len(pre) else pre[-1]
            steps.append(nn.Sequential(_conv(pre[-1], cout, 3, 2), _bn(cout),
                                       nn.ReLU()))
        layers.append(nn.Sequential(*steps))
    return nn.ModuleList(layers)


def _head(cin: int, cout: int, kernel: int) -> nn.Sequential:
    """``last_layer``: 1x1 conv + BN + ReLU, then the k x k classifier
    (keys 0, 1, 3)."""
    return nn.Sequential(_conv(cin, cin, 1, bias=True), _bn(cin), nn.ReLU(),
                         _conv(cin, cout, kernel, bias=True))


class HighResolutionNet(nn.Module):
    """Config-driven HRNet. ``cfg`` follows the reference's layout:
    {MODEL: {INPUT_CHANNELS, EXTRA: {STAGE1..4, FINAL_CONV_KERNEL,
    [DROPOUT_FINAL]}, [SSN, SSN_RANK, SSN_EPS]}, DATASET: {NUM_CLASSES}}.
    ``forward(x)`` takes (B, INPUT_CHANNELS, H, W) and returns (B, C, H, W)
    logits, or a :class:`LowRankMVN` over the C*H*W logits for the SSN."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        model = cfg["MODEL"]
        extra = model["EXTRA"]
        self.num_classes = int(cfg["DATASET"]["NUM_CLASSES"])
        self.ssn = bool(model.get("SSN", False))
        self.rank = int(model.get("SSN_RANK", 10))
        self.epsilon = float(model.get("SSN_EPS", 1e-5))
        self.dropout_final = bool(extra.get("DROPOUT_FINAL", False))

        self.conv1 = _conv(int(model.get("INPUT_CHANNELS", 3)), 64, 3, 2)
        self.bn1 = _bn(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = _bn(64)
        s1 = extra["STAGE1"]
        self.layer1 = _layer(s1["BLOCK"], 64, s1["NUM_CHANNELS"][0],
                             s1["NUM_BLOCKS"][0])
        pre = [s1["NUM_CHANNELS"][0] * BLOCKS[s1["BLOCK"]].expansion]
        for n in (2, 3, 4):
            stage_cfg = extra[f"STAGE{n}"]
            cur = [c * BLOCKS[stage_cfg["BLOCK"]].expansion
                   for c in stage_cfg["NUM_CHANNELS"]]
            setattr(self, f"transition{n - 1}", _transition(pre, cur))
            modules = []
            for _ in range(stage_cfg["NUM_MODULES"]):
                modules.append(HighResolutionModule(stage_cfg, cur))
                cur = modules[-1].out_channels
            setattr(self, f"stage{n}", nn.ModuleList(modules))
            pre = cur
        last = sum(pre)
        kernel = int(extra["FINAL_CONV_KERNEL"])
        self.last_layer = _head(last, self.num_classes, kernel)
        if self.ssn:
            self.cov_factor_conv = _head(last, self.num_classes * self.rank,
                                         kernel)

    def _features(self, x: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [_run_layer(self.layer1, x, generator)]
        for n, transition in ((2, self.transition1), (3, self.transition2),
                              (4, self.transition3)):
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(transition)]
            for module in getattr(self, f"stage{n}"):
                xs = module(xs, generator)
        if self.dropout_final:
            xs = [dropout_final(t, generator) for t in xs]
        size0 = xs[0].shape[2:]
        return torch.cat([xs[0]] + [resize_bilinear(t, size0)
                                    for t in xs[1:]], dim=1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mean_only: bool = False):
        if not self.training:
            return self._forward(x, generator, mean_only)
        pending = []
        token = _PENDING.set(pending)
        try:
            out = self._forward(x, generator, mean_only)
        finally:
            _PENDING.reset(token)
        update_running_stats(pending)
        return out

    def _forward(self, x: torch.Tensor,
                 generator: Optional[torch.Generator],
                 mean_only: bool):
        x_size = x.shape[2:]
        features = self._features(x, generator)
        logits = self.last_layer(features)
        if not self.ssn:
            return resize_bilinear(logits, x_size)
        batch = x.shape[0]
        mean = resize_bilinear(logits, x_size).reshape(batch, -1)
        cov_diag = (resize_bilinear(torch.exp(logits), x_size)
                    + self.epsilon).reshape(batch, -1)
        if mean_only:
            return LowRankMVN(mean, cov_diag,
                              mean.new_zeros(mean.shape + (self.rank,)))
        raw = resize_bilinear(self.cov_factor_conv(features), x_size)
        # (B, R*C, H, W) -> (B, R, C*H*W) -> factor[b, c*H*W + p, r]
        factor = raw.reshape(batch, self.rank, -1).transpose(1, 2)
        return LowRankMVN(mean, cov_diag, factor)


def dropout_final(x: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """p = 0.5 dropout whose keep mask comes from ``generator``: a kept
    value is doubled, a dropped one is 0 (flax ``nn.Dropout``). Every
    dropout of the HRNet goes through here, in forward order: the live
    branch dropouts of a training pass, then DROPOUT_FINAL's four."""
    if generator is None:
        raise ValueError("this HRNet draws dropout masks on this pass: "
                         "forward needs a generator")
    keep = draw_rows(lambda shape: torch.rand(
        shape, generator=generator, device=x.device, dtype=torch.float32),
        x.shape) >= DROPOUT_FINAL_RATE
    return torch.where(keep, x / (1.0 - DROPOUT_FINAL_RATE),
                       torch.zeros_like(x))


def get_seg_model(cfg: Dict[str, Any], **_kwargs) -> HighResolutionNet:
    """The reference's factory (hrnet_module.py:740-745), in eval mode.
    Weights come from a checkpoint (``load_state_dict``); pretrained
    ImageNet weights would need a download and are not read."""
    return HighResolutionNet(cfg).eval()
