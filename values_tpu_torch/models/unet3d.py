"""Per-member 3D U-Net (C0) as a plain ``nn.Module``.

Counterpart of ``values_tpu/models/unet3d.py:110-208``, with the
reference module's submodule names, so reference ``.ckpt`` state_dicts
load strictly (after :func:`values_tpu_torch.models.torch_import.
strip_model_prefix`). It is the plain specification that the grouped,
kernel-driven forward of :mod:`values_tpu_torch.models.ensemble_unet3d`
is held against.

Topology: four contract levels of two Conv3d(3, pad 1) -> affine-free
InstanceNorm (eps 1e-5) -> LeakyReLU(0.01) blocks, 2x2x2 max-pool between
levels; center Conv -> ReLU -> Conv -> ReLU -> ConvTranspose(2, 2) ->
ReLU; decoder center-crop skip concat, two Conv -> LeakyReLU blocks (no
norm) and a ConvTranspose up per level; 1x1x1 ``final`` head, or
``final_aleatoric`` emitting (mu, s). The MC-dropout variant is not
ported yet. Input and output are channels-last NDHWC, as in the JAX
package.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F


def _contract(cin: int, cout: int, instancenorm: bool) -> nn.Sequential:
    layers = [nn.Conv3d(cin, cout, 3, padding=1)]
    if instancenorm:
        layers.append(nn.InstanceNorm3d(cout, eps=1e-5))
    layers.append(nn.LeakyReLU(0.01))
    return nn.Sequential(*layers)


def _expand(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv3d(cin, cout, 3, padding=1),
                         nn.LeakyReLU(0.01))


def center_crop(x: torch.Tensor, target: Tuple[int, ...]) -> torch.Tensor:
    """Center-crop the spatial dims of an NCDHW tensor to ``target``."""
    slices = [slice(None), slice(None)]
    for dim, tgt in zip(x.shape[2:], target):
        start = (dim - tgt) // 2
        slices.append(slice(start, start + tgt))
    return x[tuple(slices)]


class UNet3D(nn.Module):
    """Reference-topology UNet3D; forward takes and returns NDHWC."""

    def __init__(self, num_classes: int, in_channels: int = 1,
                 initial_filter_size: int = 8, do_instancenorm: bool = True,
                 aleatoric_loss: bool = False):
        super().__init__()
        f = initial_filter_size
        norm = do_instancenorm
        self.aleatoric_loss = aleatoric_loss
        self.contr_1_1 = _contract(in_channels, f, norm)
        self.contr_1_2 = _contract(f, f, norm)
        self.contr_2_1 = _contract(f, 2 * f, norm)
        self.contr_2_2 = _contract(2 * f, 2 * f, norm)
        self.contr_3_1 = _contract(2 * f, 4 * f, norm)
        self.contr_3_2 = _contract(4 * f, 4 * f, norm)
        self.contr_4_1 = _contract(4 * f, 8 * f, norm)
        self.contr_4_2 = _contract(8 * f, 8 * f, norm)
        self.center = nn.Sequential(
            nn.Conv3d(8 * f, 16 * f, 3, padding=1), nn.ReLU(),
            nn.Conv3d(16 * f, 16 * f, 3, padding=1), nn.ReLU(),
            nn.ConvTranspose3d(16 * f, 8 * f, 2, stride=2), nn.ReLU())
        self.expand_4_1 = _expand(16 * f, 8 * f)
        self.expand_4_2 = _expand(8 * f, 8 * f)
        self.upscale4 = nn.ConvTranspose3d(8 * f, 4 * f, 2, stride=2)
        self.expand_3_1 = _expand(8 * f, 4 * f)
        self.expand_3_2 = _expand(4 * f, 4 * f)
        self.upscale3 = nn.ConvTranspose3d(4 * f, 2 * f, 2, stride=2)
        self.expand_2_1 = _expand(4 * f, 2 * f)
        self.expand_2_2 = _expand(2 * f, 2 * f)
        self.upscale2 = nn.ConvTranspose3d(2 * f, f, 2, stride=2)
        self.expand_1_1 = _expand(2 * f, f)
        self.expand_1_2 = _expand(f, f)
        self.final = nn.Conv3d(f, num_classes, 1)
        if aleatoric_loss:
            self.final_aleatoric = nn.Conv3d(f, 2 * num_classes, 1)
        self.output_reconstruction_map = nn.Conv3d(f, 1, 1)

    def forward(self, x: torch.Tensor, enable_concat: bool = True,
                last_layer: bool = True):
        """x (B, D, H, W, Cin) -> logits (B, D, H, W, C), or (mu, s) with
        the aleatoric head, or the pre-head features with
        ``last_layer=False``."""
        weight = 1.0 if enable_concat else 0.0
        x = x.permute(0, 4, 1, 2, 3)

        def skip(enc, dec):
            crop = center_crop(enc, dec.shape[2:])
            return torch.cat([dec, crop * weight], dim=1)

        contr_1 = self.contr_1_2(self.contr_1_1(x))
        contr_2 = self.contr_2_2(self.contr_2_1(F.max_pool3d(contr_1, 2)))
        contr_3 = self.contr_3_2(self.contr_3_1(F.max_pool3d(contr_2, 2)))
        contr_4 = self.contr_4_2(self.contr_4_1(F.max_pool3d(contr_3, 2)))
        center = self.center(F.max_pool3d(contr_4, 2))

        e = self.expand_4_2(self.expand_4_1(skip(contr_4, center)))
        e = self.expand_3_2(self.expand_3_1(skip(contr_3, self.upscale4(e))))
        e = self.expand_2_2(self.expand_2_1(skip(contr_2, self.upscale3(e))))
        e = self.expand_1_2(self.expand_1_1(skip(contr_1, self.upscale2(e))))

        def ndhwc(t):
            return t.permute(0, 2, 3, 4, 1)

        if not last_layer:
            return ndhwc(e)
        if not enable_concat:
            return ndhwc(self.output_reconstruction_map(e))
        if self.aleatoric_loss:
            mu, s = torch.chunk(self.final_aleatoric(e), 2, dim=1)
            return ndhwc(mu), ndhwc(s)
        return ndhwc(self.final(e))
