"""Stochastic Segmentation Network on the 3D U-Net trunk, as a plain
``nn.Module``.

Counterpart of ``values_tpu/models/ssn_unet3d.py`` (``LowRankMVN``
:38-75, ``SsnUNet3D`` :78-121; reference:
uncertainty_modeling/models/ssn_unet3D_module.py:7-70). The trunk runs
with ``last_layer=False`` and three 1x1x1 heads give a low-rank
multivariate normal over the flattened (class, voxel) logits:

    mean        (B, C*V)
    cov_diag    (B, C*V)        = exp(log_diag) + epsilon
    cov_factor  (B, C*V, rank)

flattened in the C-contiguous (C, D, H, W) order of a torch ``view``, so
reference checkpoints sample alike. A sample is ``mean + W eps_r +
sqrt(D) eps_d`` (torch's ``LowRankMultivariateNormal.rsample``). The
reference falls back to independent normals when the distribution's
constructor fails; that is reproduced by a float32 Cholesky of the
capacitance ``I + W^T D^-1 W`` and a zero factor where it fails.

The normals come from :func:`draw_ssn_normals`, the one place the SSN
paths draw (the scorer, the predictors), with an explicit generator.
:meth:`LowRankMVN.sample_softmax` (the 2D tester's samples) runs the
check, the samples and their softmax as the hand-written kernels of
``ops/kernels/ssn_sample.py`` on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.kernels import ssn_sample
from ..parallel.collectives import draw_rows
from .unet3d import UNet3D

# the three SSN heads, in the order of the reference module
SSN_HEADS = ("mean_conv", "log_cov_diag_conv", "cov_factor_conv")


def is_ssn_target(target: str) -> bool:
    """Whether a config's model ``_target_`` names the SSN class (the
    reference's, the JAX package's or the port's)."""
    return str(target).rsplit(".", 1)[-1] == "SsnUNet3D"


def draw_ssn_normals(generator: Optional[torch.Generator], n: int,
                     batch: int, rank: int, dim: int, dtype: torch.dtype,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The standard normals of ``n`` samples of a batch of ``batch``
    low-rank normals: ``eps_r`` (n, batch, rank) and ``eps_d`` (n, batch,
    dim)."""
    eps_r = torch.randn((n, batch, rank), generator=generator, dtype=dtype,
                        device=device)
    eps_d = torch.randn((n, batch, dim), generator=generator, dtype=dtype,
                        device=device)
    return eps_r, eps_d


class LowRankMVN:
    """A batch of low-rank multivariate normals: ``mean`` and
    ``cov_diag`` (B, N), ``cov_factor`` (B, N, R)."""

    def __init__(self, mean: torch.Tensor, cov_diag: torch.Tensor,
                 cov_factor: torch.Tensor):
        self.mean, self.cov_diag, self.cov_factor = mean, cov_diag, cov_factor

    def degenerate(self) -> torch.Tensor:
        """(B,) bool: where torch's constructor would fail, i.e. where the
        float32 Cholesky of ``I + W^T D^-1 W`` fails or is not finite.
        One batched factorization, kept on the device, outside autograd."""
        return ssn_sample.cholesky_flags(ssn_sample.capacitance_reference(
            self.cov_diag, self.cov_factor))

    def sampling_terms(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(factor (B, N, R), zero where :meth:`degenerate`; sqrt(cov_diag)
        (B, N)): what every sample reuses. A degenerate member's factor
        is replaced, not scaled, so its gradient there is zero and a
        non-finite factor leaves no NaN (the JAX ``jnp.where``)."""
        factor = torch.where(self.degenerate()[:, None, None],
                             torch.zeros_like(self.cov_factor),
                             self.cov_factor)
        return factor, torch.sqrt(self.cov_diag)

    def rsample(self, generator: Optional[torch.Generator], n: int = 1,
                terms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """(n, B, N) samples, normals drawn by :func:`draw_ssn_normals`;
        ``terms`` from :meth:`sampling_terms`, if already taken."""
        terms = terms or self.sampling_terms()
        return self.samples(*self._draw(generator, n, terms[0].shape[-1]),
                            terms)

    def samples(self, eps_r: torch.Tensor, eps_d: torch.Tensor,
                terms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """(n, B, N) samples ``mean + W eps_r + sqrt(D) eps_d`` of the
        normals ``eps_r`` (n, B, R) and ``eps_d`` (n, B, N), W zero where
        :meth:`degenerate`; ``terms`` from :meth:`sampling_terms`, if
        already taken."""
        factor, sqrt_diag = terms or self.sampling_terms()
        return (self.mean[None] + torch.einsum("bnr,sbr->sbn", factor, eps_r)
                + sqrt_diag[None] * eps_d)

    def _draw(self, generator: Optional[torch.Generator], n: int, rank: int
              ) -> list:
        """[eps_r (n, B, R), eps_d (n, B, N)] from :func:`draw_ssn_normals`,
        looked up at call time; in a data-parallel step the global batch's
        normals, this rank's rows."""
        b, dim = self.mean.shape
        return draw_rows(lambda shape: list(draw_ssn_normals(
            generator, n, shape[1], rank, dim, self.mean.dtype,
            self.mean.device)), (n, b), dim=1)

    def sample_softmax(self, generator: Optional[torch.Generator], n: int,
                       shape: Tuple[int, ...]) -> torch.Tensor:
        """(n, B, *shape) softmax over ``shape[0]``, the classes, of ``n``
        samples whose N logits an image are laid out as ``shape``. On the
        card the kernels of :mod:`~values_tpu_torch.ops.kernels.ssn_sample`
        run the stage: the capacitance and its Cholesky for
        :meth:`degenerate`'s flags, then the samples and their softmax in
        one pass, on normals drawn as :meth:`rsample` draws them. The
        kernels have no backward, so a gradient raises there. On the CPU
        :meth:`rsample`, then ``torch.softmax``."""
        shape = tuple(self.mean.shape[:1]) + tuple(shape)
        if self.mean.device.type != "cuda":
            return torch.softmax(self.rsample(generator, n).reshape(
                (n,) + shape), dim=2)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (self.mean, self.cov_diag,
                                          self.cov_factor)):
            raise RuntimeError("sample_softmax's kernels have no backward; "
                               "differentiate rsample's samples instead")
        flags = ssn_sample.degenerate(self.cov_diag, self.cov_factor)
        eps_r, eps_d = self._draw(generator, n, self.cov_factor.shape[-1])
        return ssn_sample.sample_softmax(
            self.mean, self.cov_diag, self.cov_factor, flags, eps_r, eps_d,
            shape[1]).reshape((n,) + shape)


def ssn_distribution(features: torch.Tensor, heads, num_classes: int,
                     rank: int, epsilon: float,
                     mean_only: bool = False) -> LowRankMVN:
    """Trunk features (B, D, H, W, F) and the heads' 1x1x1 weights ->
    the low-rank normal, in the features' type. ``heads`` maps each name
    of :data:`SSN_HEADS` to ``(kernel (F, cout), bias (cout,))``;
    ``mean_only`` (the SSN's pretraining) gives a zero factor and leaves
    the factor head out of the graph."""
    b = features.shape[0]

    def head(name):
        kernel, bias = heads[name]
        out = features @ kernel.to(features.dtype) + bias.to(features.dtype)
        return out.movedim(-1, 1)             # (B, cout, D, H, W)

    mean = head("mean_conv").reshape(b, -1)
    cov_diag = torch.exp(head("log_cov_diag_conv").reshape(b, -1)) + epsilon
    if mean_only:
        return LowRankMVN(mean, cov_diag, mean.new_zeros(mean.shape + (rank,)))
    # torch: view(B, R, C, V) -> flatten -> transpose: factor[b, c*V+v, r]
    raw = head("cov_factor_conv").reshape(b, rank, -1)   # (B, R, C*V)
    return LowRankMVN(mean, cov_diag, raw.transpose(1, 2))


class SsnUNet3D(UNet3D):
    """The UNet3D trunk with the SSN heads; ``forward`` returns a
    :class:`LowRankMVN`. The inherited ``final`` head is unused; it is
    sized ``C*2 + C*rank``, as the reference builds it, so reference
    state_dicts load strictly."""

    def __init__(self, num_classes: int, in_channels: int = 1,
                 initial_filter_size: int = 8, kernel_size: int = 3,
                 do_instancenorm: bool = True, rank: int = 10,
                 epsilon: float = 1e-5, do_dropout: bool = False,
                 aleatoric_loss: bool = False):
        super().__init__(num_classes, in_channels, initial_filter_size,
                         do_instancenorm, aleatoric_loss=False,
                         kernel_size=kernel_size, do_dropout=do_dropout)
        f = initial_filter_size
        self.rank, self.epsilon = rank, epsilon
        self.final = nn.Conv3d(f, num_classes * 2 + num_classes * rank, 1)
        self.mean_conv = nn.Conv3d(f, num_classes, 1)
        self.log_cov_diag_conv = nn.Conv3d(f, num_classes, 1)
        self.cov_factor_conv = nn.Conv3d(f, num_classes * rank, 1)

    def forward(self, x: torch.Tensor, enable_concat: bool = True,
                keep_masks=None) -> LowRankMVN:
        features = super().forward(x, enable_concat, last_layer=False,
                                   keep_masks=keep_masks)
        heads = {name: (getattr(self, name).weight[:, :, 0, 0, 0].t(),
                        getattr(self, name).bias) for name in SSN_HEADS}
        return ssn_distribution(features, heads, self.num_classes,
                                self.rank, self.epsilon)
