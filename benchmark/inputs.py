"""Weights and inputs made from a run's seed, on the device, in a few
large calls, then handed to both the program and the reference.

- UNet3D members: reference state_dicts (torch layout), every weight
  normal with std sqrt(2 / (1 + 0.01^2) / fan_in) and every bias 0 (He
  initialization for leaky ReLU, as nnU-Net draws its weights), from one
  draw for all members, so that activations and logits keep the scale a
  trained network's have instead of shrinking through the decoder's
  unnormalized convs;
- HRNet members: the same for every conv, BatchNorm's scale 1 and shift
  0, and running statistics calibrated in training mode over a batch of
  calibration images, so that each norm sees what a trained network's
  would (random weights with unit statistics overflow through the depth);
- volumes and images whose contrast, offset and foreground share differ
  from item to item, with rater masks, or masks of 16 x 16 blocks of
  class ids and an ignored band at the top, copied to pageable host
  memory, where the traffic takes them from.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .flops import conv2d_flops_hook
from .reference import hrnet as ref_hrnet
from .reference import unet3d as ref_unet3d

LEAKY_SLOPE = 0.01


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _uniform_fan_in(shapes, fan_ins, count: int, gen, device
                    ) -> List[Dict[str, torch.Tensor]]:
    """``count`` dicts of tensors of ``shapes``, uniform in
    +-1/sqrt(fan_in), from one draw."""
    sizes = [math.prod(s) for _, s in shapes]
    flat = torch.rand(count * sum(sizes), generator=gen, device=device)
    flat = flat.mul_(2).sub_(1).split(sizes * count)
    out = []
    for m in range(count):
        part = flat[m * len(shapes):(m + 1) * len(shapes)]
        out.append({k: t.view(s).mul(1 / math.sqrt(fan_ins[k]))
                    for (k, s), t in zip(shapes, part)})
    return out


def unet3d_states(model: Dict, members: int, gen, device
                  ) -> List[Dict[str, torch.Tensor]]:
    shapes = ref_unet3d.state_shapes(model["initial_filter_size"],
                                     model["in_channels"],
                                     model["num_classes"])
    table = dict(shapes)
    weights = [(k, s) for k, s in shapes if k.endswith(".weight")]
    sizes = [math.prod(s) for _, s in weights]
    flat = torch.randn(members * sum(sizes), generator=gen, device=device)
    flat = flat.split(sizes * members)
    gain = math.sqrt(2.0 / (1.0 + LEAKY_SLOPE ** 2))
    out = []
    for m in range(members):
        part = flat[m * len(weights):(m + 1) * len(weights)]
        state = {k: t.view(s) * (gain / math.sqrt(ref_unet3d.fan_in(k, table)))
                 for (k, s), t in zip(weights, part)}
        out.append({k: state[k] if k in state
                    else torch.zeros(s, device=device) for k, s in shapes})
    return out


def hrnet_states(cfg: Dict, members: int, calib: torch.Tensor, gen
                 ) -> (List[Dict[str, torch.Tensor]], float):
    """``members`` HRNet state_dicts and the forward FLOPs of one image of
    ``calib``'s shape (counted from the convs' output shapes)."""
    with torch.device("meta"):
        skeleton = ref_hrnet.HRNet(cfg)
    convs, fan_ins = [], {}
    for name, mod in skeleton.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            for leaf in ("weight", "bias"):
                t = getattr(mod, leaf)
                if t is not None:
                    convs.append((f"{name}.{leaf}", tuple(t.shape)))
                    fan_ins[f"{name}.{leaf}"] = math.prod(
                        mod.weight.shape[1:])
    drawn = _uniform_fan_in(convs, fan_ins, members, gen, calib.device)
    states, counter = [], {"flops": 0.0}
    for m, conv_state in enumerate(drawn):
        state = {}
        for k, v in skeleton.state_dict().items():
            if k in conv_state:
                state[k] = conv_state[k]
            elif k.endswith(("weight", "running_var")):
                state[k] = torch.ones(v.shape, device=calib.device)
            elif k.endswith("num_batches_tracked"):
                state[k] = torch.zeros((), dtype=torch.long,
                                       device=calib.device)
            else:
                state[k] = torch.zeros(v.shape, device=calib.device)
        with torch.device("meta"):
            net = ref_hrnet.HRNet(cfg)
        net.load_state_dict(state, assign=True)
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.momentum = None     # the average over the calibration
        hooks = ([mod.register_forward_hook(conv2d_flops_hook(counter))
                  for mod in net.modules()
                  if isinstance(mod, torch.nn.Conv2d)] if m == 0 else [])
        with torch.no_grad():
            net.train()(calib)
        for h in hooks:
            h.remove()
        states.append({k: v.detach() for k, v in net.state_dict().items()})
    return states, counter["flops"] / calib.shape[0]


def _per_item(gen, count: int, lo: float, hi: float, device, ndim: int):
    """One value uniform in [lo, hi) per item, shaped to broadcast."""
    u = torch.rand((count,) + (1,) * (ndim - 1), generator=gen,
                   device=device)
    return lo + (hi - lo) * u


def volume_pool(gen, count: int, patch: int, raters: int, foreground,
                device):
    """(count, p, p, p, 1) float32 volumes and (count, R, p, p, p) int32
    rater masks, in host memory. Each volume has its own contrast and
    offset (x = a u + b, u uniform in [0, 1), a in [0.5, 2), b in [-0.5,
    0.5)) and its own foreground share in ``foreground`` (lo, hi), so
    that every volume's answers differ."""
    a = _per_item(gen, count, 0.5, 2.0, device, 5)
    b = _per_item(gen, count, -0.5, 0.5, device, 5)
    vols = torch.rand((count, patch, patch, patch, 1), generator=gen,
                      device=device) * a + b
    p = _per_item(gen, count, *foreground, device, 5)
    masks = (torch.rand((count, raters, patch, patch, patch), generator=gen,
                        device=device) < p).to(torch.int32)
    return vols.cpu(), masks.cpu()


def image_pool(gen, count: int, height: int, width: int, classes: int,
               ignore_index: int, device):
    """(count, H, W, 3) float32 normalized images (each its own contrast
    and offset: a n + b, n standard normal, a in [0.5, 2), b in [-0.5,
    0.5)) and (count, H, W) int64 masks of 16 x 16 blocks of class ids,
    the top 1/32 ignored, as host numpy arrays."""
    images = (torch.randn((count, height, width, 3), generator=gen,
                          device=device)
              * _per_item(gen, count, 0.5, 2.0, device, 4)
              + _per_item(gen, count, -0.5, 0.5, device, 4))
    blocks = torch.randint(0, classes, (count, -(-height // 16),
                                        -(-width // 16)),
                           generator=gen, device=device)
    masks = blocks.repeat_interleave(16, 1).repeat_interleave(16, 2)
    masks = masks[:, :height, :width].clone()
    masks[:, :height // 32] = ignore_index
    return images.cpu().numpy(), masks.cpu().numpy()


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed))
