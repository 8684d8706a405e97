"""The plain UNet3D of the ValUES reference (``unet3D_module.py``): four
contract levels of two Conv3d(3, pad 1) -> InstanceNorm (affine-free, eps
1e-5) -> LeakyReLU(0.01) blocks with 2x2x2 max pools between them; a
center of Conv -> ReLU -> Conv -> ReLU -> ConvTranspose(2, 2) -> ReLU;
four expand levels that concatenate the skip after the upsampled tensor,
then two Conv -> LeakyReLU blocks and a ConvTranspose(2, 2) up; a 1x1x1
``final`` head.

Plain ``torch.nn.functional`` calls on NCDHW tensors, with the weights of
a reference state_dict (``contr_1_1.0.weight``, ``center.4.weight``,
``upscale4.weight``, ``final.weight``, ...). ``quantize`` rounds every
conv's input, weight and output, the logits included, as a forward
computed in a lower precision stores them (the control).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quantize = Optional[Callable[[torch.Tensor], torch.Tensor]]


def state_shapes(filters: int, in_channels: int, classes: int
                 ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every weight and bias of the state_dict, in
    module order (the unused autoencoder head left out)."""
    f, out = filters, []

    def conv(key, cin, cout, k=3):
        out.append((f"{key}.weight", (cout, cin, k, k, k)))
        out.append((f"{key}.bias", (cout,)))

    def transposed(key, cin, cout):
        out.append((f"{key}.weight", (cin, cout, 2, 2, 2)))
        out.append((f"{key}.bias", (cout,)))

    cin = in_channels
    for lvl in range(1, 5):
        c = f << (lvl - 1)
        conv(f"contr_{lvl}_1.0", cin, c)
        conv(f"contr_{lvl}_2.0", c, c)
        cin = c
    conv("center.0", 8 * f, 16 * f)
    conv("center.2", 16 * f, 16 * f)
    transposed("center.4", 16 * f, 8 * f)
    for lvl in (4, 3, 2, 1):
        c = f << (lvl - 1)
        conv(f"expand_{lvl}_1.0", 2 * c, c)
        conv(f"expand_{lvl}_2.0", c, c)
        if lvl > 1:
            transposed(f"upscale{lvl}", c, c // 2)
    conv("final", f, classes, k=1)
    return out


def fan_in(key: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """torch's default init range 1/sqrt(fan_in): the size of one slice
    along dim 0 of the module's weight (a ConvTranspose weight is (I, O,
    k, k, k), so its fan-in is O * k^3, as torch computes it)."""
    shape = shapes[key.rsplit(".", 1)[0] + ".weight"]
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor,
            quantize: Quantize = None) -> torch.Tensor:
    """Logits (B, C, D, H, W) of x (B, Cin, D, H, W)."""
    q = quantize or (lambda t: t)

    def conv(t, key, pad=1):
        return q(F.conv3d(q(t), q(sd[f"{key}.weight"]), sd[f"{key}.bias"],
                          padding=pad))

    def up(t, key):
        return q(F.conv_transpose3d(q(t), q(sd[f"{key}.weight"]),
                                    sd[f"{key}.bias"], stride=2))

    def norm_block(t, key):
        return F.leaky_relu(F.instance_norm(conv(t, key), eps=1e-5), 0.01)

    skips, t = [], x
    for lvl in range(1, 5):
        t = norm_block(norm_block(t, f"contr_{lvl}_1.0"), f"contr_{lvl}_2.0")
        skips.append(t)
        t = F.max_pool3d(t, 2)
    t = F.relu(conv(t, "center.0"))
    t = F.relu(conv(t, "center.2"))
    t = F.relu(up(t, "center.4"))
    for lvl in (4, 3, 2, 1):
        t = torch.cat([t, skips.pop()], dim=1)
        t = F.leaky_relu(conv(t, f"expand_{lvl}_1.0"), 0.01)
        t = F.leaky_relu(conv(t, f"expand_{lvl}_2.0"), 0.01)
        if lvl > 1:
            t = up(t, f"upscale{lvl}")
    return conv(t, "final", pad=0)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, back in t's type."""
    return t.to(torch.bfloat16).to(t.dtype)


def fp8_quantize(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its absolute
    maximum onto the format's largest value, 448), back in t's type."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
