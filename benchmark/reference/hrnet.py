"""The plain HRNetV2 segmentation network (arXiv:1908.07919; the ValUES
reference's ``hrnet_module.py``, the public Microsoft HRNet), NCHW, with
``torch.nn`` modules only.

A stem of two stride-2 3x3 convs, the stage-1 bottleneck layer, three
multi-branch stages of modules (a residual layer per branch, then every
branch fused into every other: 1x1 conv + BN and a bilinear upsample from
lower resolutions, stride-2 3x3 convs from higher ones, summed, ReLU),
transition layers between stages, and a head that concatenates the four
branches upsampled to the first's size, runs 1x1 conv + BN + ReLU and the
classifier, and upsamples to the input (bilinear, align_corners False).
Module names are the reference's, so its state_dict keys are.
Evaluation only: no dropout, no SSN head.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn
import torch.nn.functional as F


def _conv(cin, cout, k, stride=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=bias)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _up(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3, stride), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _bn(planes)
        self.downsample = downsample

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, 4 * planes, 1), _bn(4 * planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _layer(block, cin, planes, n):
    cls = BLOCKS[block]
    down = None
    if cin != planes * cls.expansion:
        down = nn.Sequential(_conv(cin, planes * cls.expansion, 1),
                             _bn(planes * cls.expansion))
    return nn.Sequential(cls(cin, planes, 1, down),
                         *[cls(planes * cls.expansion, planes)
                           for _ in range(1, n)])


class Module(nn.Module):
    def __init__(self, cfg: Dict, cin: List[int]):
        super().__init__()
        n, block = cfg["NUM_BRANCHES"], cfg["BLOCK"]
        ch = [c * BLOCKS[block].expansion for c in cfg["NUM_CHANNELS"]]
        self.branches = nn.ModuleList(
            _layer(block, cin[b], cfg["NUM_CHANNELS"][b],
                   cfg["NUM_BLOCKS"][b]) for b in range(n))
        self.fuse_layers = None
        if n > 1:
            self.fuse_layers = nn.ModuleList(
                nn.ModuleList(self._fuse(ch, i, j) for j in range(n))
                for i in range(n))
        self.out_channels = ch

    @staticmethod
    def _fuse(ch, i, j):
        if j == i:
            return None
        if j > i:
            return nn.Sequential(_conv(ch[j], ch[i], 1), _bn(ch[i]))
        steps = []
        for k in range(i - j):
            last = k == i - j - 1
            cout = ch[i] if last else ch[j]
            step = [_conv(ch[j], cout, 3, 2), _bn(cout)]
            if not last:
                step.append(nn.ReLU())
            steps.append(nn.Sequential(*step))
        return nn.Sequential(*steps)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return xs
        out = []
        for i, row in enumerate(self.fuse_layers):
            y = 0
            for j, fuse in enumerate(row):
                if j == i:
                    y = y + xs[j]
                elif j > i:
                    y = y + _up(fuse(xs[j]), xs[i].shape[2:])
                else:
                    y = y + fuse(xs[j])
            out.append(F.relu(y))
        return out


def _transition(pre, cur):
    layers = []
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


class HRNet(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        model, extra = cfg["MODEL"], cfg["MODEL"]["EXTRA"]
        classes = int(cfg["DATASET"]["NUM_CLASSES"])
        self.conv1 = _conv(int(model.get("INPUT_CHANNELS", 3)), 64, 3, 2)
        self.bn1 = _bn(64)
        self.conv2, self.bn2 = _conv(64, 64, 3, 2), _bn(64)
        s1 = extra["STAGE1"]
        self.layer1 = _layer(s1["BLOCK"], 64, s1["NUM_CHANNELS"][0],
                             s1["NUM_BLOCKS"][0])
        pre = [s1["NUM_CHANNELS"][0] * BLOCKS[s1["BLOCK"]].expansion]
        for n in (2, 3, 4):
            scfg = extra[f"STAGE{n}"]
            cur = [c * BLOCKS[scfg["BLOCK"]].expansion
                   for c in scfg["NUM_CHANNELS"]]
            setattr(self, f"transition{n - 1}", _transition(pre, cur))
            modules = []
            for _ in range(scfg["NUM_MODULES"]):
                modules.append(Module(scfg, cur))
                cur = modules[-1].out_channels
            setattr(self, f"stage{n}", nn.ModuleList(modules))
            pre = cur
        k = int(extra["FINAL_CONV_KERNEL"])
        self.last_layer = nn.Sequential(
            _conv(sum(pre), sum(pre), 1, bias=True), _bn(sum(pre)), nn.ReLU(),
            _conv(sum(pre), classes, k, bias=True))

    def forward(self, x):
        size = x.shape[2:]
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for n in (2, 3, 4):
            transition = getattr(self, f"transition{n - 1}")
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(transition)]
            for module in getattr(self, f"stage{n}"):
                xs = module(xs)
        s0 = xs[0].shape[2:]
        feats = torch.cat([xs[0]] + [_up(t, s0) for t in xs[1:]], dim=1)
        return _up(self.last_layer(feats), size)
