"""Work counted from shapes: the chip's peaks, the UNet3D's convolutions,
and the least time a kernel could take.

Frozen with the benchmark, so a per-layer metric reads the same work
whatever implements it. The peaks are NVIDIA's published dense rates of
one H100 SXM; a card set below its 700 W limit runs under them, and
every run records the card's power limit beside its numbers.

Bytes of a fused 3x3x3 convolution count each input and output element
once (both inputs of a split-input conv, the output) and the weight
once; operations count 2 x 27 x Cin x Cout per output voxel and group.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
# float32 on K1's tensor-core regime: three TF32 products per product
TF32X3_PRODUCTS = 3
BYTES = {"bfloat16": 2, "float32": 4}


class Conv(NamedTuple):
    """One grouped 3x3x3 conv of the forward: cubic side ``d``, per-group
    input channels of its two inputs, output channels, group count."""
    name: str
    d: int
    cin1: int
    cin2: int
    cout: int
    groups: int


def unet3d_convs(patch: int, filters: int, in_channels: int,
                 groups: int) -> List[Conv]:
    """The UNet3D's 18 3x3x3 convs in forward order (four contract levels
    of two normed convs, the two center convs, four expand levels of a
    split-input conv and a plain one)."""
    f, convs = filters, []
    cin = in_channels
    for lvl in range(4):
        d, c = patch >> lvl, f << lvl
        convs.append(Conv(f"contr_{lvl + 1}_1", d, cin, 0, c, groups))
        convs.append(Conv(f"contr_{lvl + 1}_2", d, c, 0, c, groups))
        cin = c
    d = patch >> 4
    convs.append(Conv("center_conv1", d, 8 * f, 0, 16 * f, groups))
    convs.append(Conv("center_conv2", d, 16 * f, 0, 16 * f, groups))
    for lvl in (4, 3, 2, 1):
        d, c = patch >> (lvl - 1), f << (lvl - 1)
        convs.append(Conv(f"expand_{lvl}_1", d, c, c, c, groups))
        convs.append(Conv(f"expand_{lvl}_2", d, c, 0, c, groups))
    return convs


def conv_flops(conv: Conv, batch: int) -> float:
    vox = batch * conv.d ** 3
    return 2.0 * vox * 27 * (conv.cin1 + conv.cin2) * conv.cout * conv.groups


def conv_bytes(conv: Conv, batch: int, dtype: str) -> float:
    """Inputs and output once, the weight once."""
    vox = batch * conv.d ** 3
    g, e = conv.groups, BYTES[dtype]
    return e * (vox * g * (conv.cin1 + conv.cin2 + conv.cout)
                + 27 * (conv.cin1 + conv.cin2) * conv.cout * g)


def dx_bytes(conv: Conv, batch: int, dtype: str) -> float:
    """The input gradient of a conv as the dx entry takes it in a training
    step: dy and the forward's output y read (the activation's or the
    statistics' fold needs y), the folded cotangent dy' (what dW takes)
    and dx written, the weight read once."""
    vox = batch * conv.d ** 3
    g, e = conv.groups, BYTES[dtype]
    cin = conv.cin1 + conv.cin2
    return e * (vox * g * (3 * conv.cout + cin) + 27 * cin * conv.cout * g)


def least_seconds(bytes_moved: float, flops: float, peak_flops: float
                  ) -> float:
    """The larger of the byte and the operation bound."""
    return max(bytes_moved / PEAK_BYTES, flops / peak_flops)


def k1_least_seconds(convs: List[Conv], batch: int, dtype: str) -> float:
    """Least time of the forward's fused convs: each conv's bound, summed.
    float32 runs K1's 3xTF32 regime, three TF32 products a product."""
    peak = (PEAK_FLOPS["bfloat16"] if dtype == "bfloat16"
            else PEAK_FLOPS["tf32"] / TF32X3_PRODUCTS)
    return sum(least_seconds(conv_bytes(c, batch, dtype),
                             conv_flops(c, batch), peak) for c in convs)


def dx_least_seconds(convs: List[Conv], batch: int, dtype: str) -> float:
    """Least time of the backward's input gradients: every conv but the
    first, whose input needs none."""
    peak = (PEAK_FLOPS["bfloat16"] if dtype == "bfloat16"
            else PEAK_FLOPS["tf32"] / TF32X3_PRODUCTS)
    return sum(least_seconds(dx_bytes(c, batch, dtype),
                             conv_flops(c, batch), peak) for c in convs[1:])


def unet3d_flops(patch: int, filters: int, in_channels: int,
                 classes: int, members: int) -> float:
    """Forward operations of one volume through ``members`` UNet3Ds: the
    18 3x3x3 convs, the four k2s2 transposed convs and the 1x1x1 head."""
    total = sum(conv_flops(c, 1)
                for c in unet3d_convs(patch, filters, in_channels, members))
    f = filters
    for lvl in (4, 3, 2, 1):     # center_up, upscale4, upscale3, upscale2
        out_vox = (patch >> (lvl - 1)) ** 3
        total += 2.0 * out_vox * (2 * f << (lvl - 1)) * (f << (lvl - 1)) \
            * members
    total += 2.0 * patch ** 3 * f * classes * members
    return total


def conv2d_flops_hook(counter: Dict[str, float]):
    """A forward hook for ``nn.Conv2d`` adding 2 x MACs of its output to
    ``counter["flops"]``."""
    def hook(module, _inputs, out):
        k = (module.kernel_size[0] * module.kernel_size[1]
             * module.in_channels // module.groups)
        counter["flops"] += 2.0 * out.numel() * k
    return hook
