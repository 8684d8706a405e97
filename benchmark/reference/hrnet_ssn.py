"""The Stochastic Segmentation Network head of the ValUES HRNetV2
(``hrnet_module.py`` with ``configs/model/hrnet_config_ssn.yaml``;
Monteiro et al., NeurIPS 2020, arXiv:2006.06015) on the plain trunk of
:mod:`.hrnet`, and what the 2D tester makes of it: the low-rank samples,
their softmax, the uncertainty maps and GED. Plain torch only.

The head: ``last_layer`` gives the logits at the trunk's quarter size.
The mean is their bilinear upsample to the input; the diagonal is the
upsample of their exp, plus ``SSN_EPS`` (the reference takes the
diagonal from the same head as the mean); ``cov_factor_conv`` (1x1 conv
+ BN + ReLU + 1x1 conv to R x C channels) upsampled gives the factor,
(B, R*C, H, W) read as (B, R, C*H*W) and transposed to (B, C*H*W, R).
A sample is ``mean + W eps_r + sqrt(D) eps_d`` with standard normals
eps_r (R,) and eps_d (C*H*W,), as ``torch.distributions.
LowRankMultivariateNormal.rsample`` forms it. Where that distribution's
constructor fails (the Cholesky of the capacitance ``I + W^T D^-1 W``),
the reference falls back to the independent normal: a zero factor. The
maps over S samples: PE of the mean softmax, EE the samples' mean
entropy, MI = PE - EE; an SSN reports MI as its aleatoric map and EE as
its epistemic one (the swap of ValUES' ``test_2D.py``); the GED of the
samples' argmax is :func:`.measures.ged`.

Departures from the published description, all in the arithmetic:

- the samples are formed in float64 from given normals: the normals the
  program drew, redrawn here from its generator's saved state in the
  order of its draws (:func:`draw_normals`), not torch's own draws;
- the capacitance's Cholesky that decides the fallback runs in float64;
  torch's constructor runs it in the distribution's float32;
- the trunk and heads run in float32 with TF32 and cuDNN off (the
  caller's :func:`benchmark.reference.exact`), and the softmax, the maps
  and the GED in float64.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from . import hrnet, measures


class HRNetSSN(hrnet.HRNet):
    """The plain HRNet with the SSN's factor head; module names are the
    reference's, so its state_dict keys are (``cov_factor_conv.3.weight``,
    ...)."""

    def __init__(self, cfg: Dict):
        super().__init__(cfg)
        model = cfg["MODEL"]
        self.rank = int(model.get("SSN_RANK", 10))
        self.epsilon = float(model.get("SSN_EPS", 1e-5))
        classes = int(cfg["DATASET"]["NUM_CLASSES"])
        width = self.last_layer[0].in_channels
        k = int(model["EXTRA"]["FINAL_CONV_KERNEL"])
        self.cov_factor_conv = nn.Sequential(
            hrnet._conv(width, width, 1, bias=True), hrnet._bn(width),
            nn.ReLU(), hrnet._conv(width, classes * self.rank, k, bias=True))

    def distribution(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean (B, N), cov_diag (B, N), factor (B, N, R)) of x (B, 3, H,
        W), N = C*H*W in the C-contiguous (C, H, W) order."""
        got = {}

        def keep(_module, args, out):
            got["features"], got["logits"] = args[0], out

        hook = self.last_layer.register_forward_hook(keep)
        try:
            mean = super().forward(x)          # the upsampled logits
        finally:
            hook.remove()
        b, size = x.shape[0], x.shape[2:]
        cov_diag = hrnet._up(torch.exp(got["logits"]), size) + self.epsilon
        raw = hrnet._up(self.cov_factor_conv(got["features"]), size)
        factor = raw.reshape(b, self.rank, -1).transpose(1, 2)
        return mean.reshape(b, -1), cov_diag.reshape(b, -1), factor


def draw_normals(state: torch.Tensor, members: int, samples: int,
                 batch: int, rank: int, dim: int, dtype, device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The standard normals of ``members`` SSN passes over one batch, as
    the tester draws them from a generator in ``state``: for each member
    ``eps_r`` (S, B, R), then ``eps_d`` (S, B, N), by ``torch.randn``."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    out = []
    for _ in range(members):
        eps_r = torch.randn((samples, batch, rank), generator=gen,
                            dtype=dtype, device=device)
        eps_d = torch.randn((samples, batch, dim), generator=gen,
                            dtype=dtype, device=device)
        out.append((eps_r, eps_d))
    return out


def degenerate(cov_diag: torch.Tensor, factor: torch.Tensor
               ) -> torch.Tensor:
    """(B,) bool: where the Cholesky of ``I + W^T D^-1 W`` fails or is
    not finite, in float64."""
    w = factor.double()
    cap = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device) \
        + (w / cov_diag.double()[..., None]).transpose(1, 2) @ w
    chol, info = torch.linalg.cholesky_ex(cap)
    return (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))


def samples(mean: torch.Tensor, cov_diag: torch.Tensor,
            factor: torch.Tensor, eps_r: torch.Tensor, eps_d: torch.Tensor
            ) -> torch.Tensor:
    """(S, B, N) float64 samples ``mean + W eps_r + sqrt(D) eps_d``, the
    factor zero where :func:`degenerate`."""
    w = factor.double()
    w = torch.where(degenerate(cov_diag, w)[:, None, None],
                    torch.zeros_like(w), w)
    return (mean.double()[None]
            + torch.einsum("bnr,sbr->sbn", w, eps_r.double())
            + cov_diag.double().sqrt()[None] * eps_d.double())


def uncertainty_maps(probs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(S, C, H, W) softmax samples -> the SSN's maps by the tester's
    names: PE, MI as the aleatoric map, EE as the epistemic one."""
    stats = measures.sample_statistics(probs.double(), class_axis=1)
    return {"pred_entropy": stats["pred_entropy"],
            "aleatoric_uncertainty": stats["mutual_information"],
            "epistemic_uncertainty": stats["expected_entropy"]}

