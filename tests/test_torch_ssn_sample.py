"""The SSN's sampling stage (``LowRankMVN.sample_softmax`` and
``values_tpu_torch.ops.kernels.ssn_sample``): on the CPU the composition
of ``rsample`` and ``torch.softmax`` bit for bit, the plain versions, the
degenerate fallback and replayed normals; on a card the kernels, in
float32 and float64, against a float64 plain composition on the same
normals. The module imports no jax, so it collects on the card's machine
(``-m cuda``)."""
import math

import pytest
import torch

from values_tpu_torch.models import ssn_unet3d as PS
from values_tpu_torch.models.ssn_unet3d import LowRankMVN
from values_tpu_torch.ops.kernels import ssn_sample

B, C, H, W, R, S = 2, 5, 6, 7, 3, 4


def _terms(b=B, c=C, h=H, w=W, r=R, *, layout="hrnet", log_diag=(-2.0, 2.0),
           seed=0, device="cpu", dtype=torch.float32):
    """mean, cov_diag (B, N) and cov_factor (B, N, R) over N = C*H*W
    logits: the factor as the HRNet head's ``reshape(B, R, N).transpose(1,
    2)`` view of (B, R*C, H, W), or contiguous; sum_r W^2 about D, as the
    benchmark's weights set it."""
    g = torch.Generator().manual_seed(seed)
    n = c * h * w
    mean = 2.0 * torch.randn((b, n), generator=g, dtype=torch.float64)
    cov_diag = torch.exp(torch.rand((b, n), generator=g, dtype=torch.float64)
                         * (log_diag[1] - log_diag[0]) + log_diag[0]) + 1e-5
    raw = torch.randn((b, r, n), generator=g, dtype=torch.float64) \
        * (cov_diag / r).sqrt()[:, None]
    factor = raw.reshape(b, r * c, h, w).reshape(b, r, n).transpose(1, 2)
    if layout == "contiguous":
        factor = factor.contiguous()
    return tuple(t.to(device=device, dtype=dtype)
                 for t in (mean, cov_diag, factor))


def _normals(s, b, r, n, seed=1, device="cpu", dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((s, b, r), generator=g, dtype=dtype).to(device),
            torch.randn((s, b, n), generator=g, dtype=dtype).to(device))


def _replay(monkeypatch, eps_r, eps_d):
    """``draw_ssn_normals`` hands back the given normals."""
    def replayed(generator, n, batch, rank, dim, dtype, device):
        assert (n, batch, rank, dim) == tuple(eps_r.shape) + (
            eps_d.shape[-1],)
        return eps_r, eps_d
    monkeypatch.setattr(PS, "draw_ssn_normals", replayed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_sample_softmax_is_rsample_then_softmax(dtype):
    """From the same generator state, bit for bit."""
    dist = LowRankMVN(*_terms(dtype=dtype))
    got = dist.sample_softmax(torch.Generator().manual_seed(5), S, (C, H, W))
    want = torch.softmax(dist.rsample(torch.Generator().manual_seed(5), S)
                         .reshape(S, B, C, H, W), dim=2)
    assert got.shape == (S, B, C, H, W) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["hrnet", "contiguous"])
def test_replayed_normals_are_used_and_the_plain_version_agrees(
        monkeypatch, layout):
    """Normals replayed through ``draw_ssn_normals`` are the ones the
    samples take; the kernels' plain version on them (``samples``, then
    the softmax) gives the method's samples bit for bit, whatever the
    factor's strides."""
    dist = LowRankMVN(*_terms(layout=layout))
    eps_r, eps_d = _normals(S, B, R, C * H * W)
    _replay(monkeypatch, eps_r, eps_d)
    got = dist.sample_softmax(None, S, (C, H, W))
    plain = torch.softmax(dist.samples(eps_r, eps_d).reshape(S, B, C, H, W),
                          dim=2)
    assert torch.equal(got, plain)
    by_hand = torch.softmax(
        (dist.mean[None] + torch.einsum("bnr,sbr->sbn", dist.cov_factor,
                                        eps_r)
         + dist.cov_diag.sqrt()[None] * eps_d).reshape(S, B, C, H, W), dim=2)
    torch.testing.assert_close(got, by_hand, rtol=0, atol=1e-6)


def test_degenerate_member_takes_only_the_diagonal(monkeypatch):
    """A non-finite factor flags its member, which then gets mean +
    sqrt(D) eps_d alone, with no NaN; the other member keeps its low-rank
    term."""
    mean, cov_diag, factor = _terms()
    factor = factor.clone()
    factor[1, 3, 0] = float("inf")
    dist = LowRankMVN(mean, cov_diag, factor)
    assert dist.degenerate().tolist() == [False, True]
    eps_r, eps_d = _normals(S, B, R, C * H * W)
    _replay(monkeypatch, eps_r, eps_d)
    got = dist.sample_softmax(None, S, (C, H, W))
    assert torch.isfinite(got).all()
    diagonal = torch.softmax((mean[1] + cov_diag[1].sqrt() * eps_d[:, 1])
                             .reshape(S, C, H, W), dim=1)
    # (torch.softmax over another layout may round its sum otherwise)
    torch.testing.assert_close(got[:, 1], diagonal, rtol=1e-6, atol=1e-7)
    assert (got[:, 0] - torch.softmax((mean[0] + cov_diag[0].sqrt()
                                       * eps_d[:, 0]).reshape(S, C, H, W),
                                      dim=1)).abs().max() > 1e-3


def test_capacitance_plain_flags_match_degenerate():
    """The capacitance's plain version and its Cholesky rule give
    ``LowRankMVN.degenerate``'s flags: a sound member, a non-finite
    factor, and a negative diagonal whose capacitance I + W^T D^-1 W is
    not positive definite."""
    mean, cov_diag, factor = _terms(b=3)
    factor, cov_diag = factor.clone(), cov_diag.clone()
    factor[1, 0, 2] = float("nan")
    cov_diag[2] = -cov_diag[2]
    dist = LowRankMVN(mean, cov_diag, factor)
    want = dist.degenerate()
    assert want.tolist() == [False, True, True]
    assert torch.equal(ssn_sample.degenerate(cov_diag, factor), want)
    cap = ssn_sample.capacitance(cov_diag, factor)
    assert cap.shape == (3, R, R) and cap.dtype == torch.float32
    w = factor[0].double()
    torch.testing.assert_close(
        cap[0].double(), torch.eye(R, dtype=torch.float64)
        + (w / cov_diag[0].double()[:, None]).T @ w, rtol=1e-5, atol=1e-5)


def test_a_gradient_runs_through_rsample():
    """On the CPU the method is rsample's composition, so a required
    gradient reaches the heads' tensors through the samples."""
    mean, cov_diag, factor = (t.clone().requires_grad_()
                              for t in _terms())
    out = LowRankMVN(mean, cov_diag, factor).sample_softmax(
        torch.Generator().manual_seed(2), S, (C, H, W))
    (out[:, :, 0] ** 2).sum().backward()
    for t in (mean, cov_diag, factor):
        assert t.grad is not None and t.grad.abs().sum() > 0


@pytest.mark.parametrize("classes,want", [
    (1, (1, 1)), (2, (1, 2)), (8, (1, 8)), (9, (2, 5)), (16, (2, 8)),
    (17, (4, 5)), (24, (4, 6)), (32, (4, 8)), (33, (8, 5)), (256, (32, 8))])
def test_plan_takes_the_fewest_lanes(classes, want):
    assert ssn_sample.plan(classes) == want


def test_plan_and_bad_calls_raise():
    with pytest.raises(ValueError):
        ssn_sample.plan(257)
    with pytest.raises(ValueError):
        ssn_sample.plan(0)
    mean, cov_diag, factor = _terms()
    eps_r, eps_d = _normals(S, B, R, C * H * W)
    flags = torch.zeros(B, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssn_sample.sample_softmax(mean, cov_diag, factor, flags, eps_r,
                                  eps_d, C)
    with pytest.raises(ValueError, match="class maps"):
        ssn_sample.sample_softmax(mean, cov_diag, factor, flags, eps_r,
                                  eps_d, 4)
    with pytest.raises(ValueError, match="do not"):
        ssn_sample.sample_softmax(mean, cov_diag, factor, flags, eps_r[:, :1],
                                  eps_d, C)
    with pytest.raises(ValueError, match="do not match"):
        ssn_sample.capacitance(cov_diag[:1], factor)


# -- on the card ---------------------------------------------------------------

def _pe(p: torch.Tensor) -> torch.Tensor:
    """The predictive entropy map of (S, B, C, HW) samples, (B, HW)."""
    m = p.double().mean(0)
    return -torch.where(m > 0, m * m.log(), torch.zeros_like(m)).sum(1)


CUDA_CASES = {
    # name: (B, C, H, W, R, S, layout, log D range, degenerate, dtype,
    #        max |dp|)
    # |dp|: float32 logits against float64, a few ulps of the largest logit
    # (|l| ~ 10 here, ~750 where D reaches e^10); float64 kernels sum in
    # another order than the einsum, at float64's ulps
    "hrnet view": (3, 24, 37, 61, 10, 10, "hrnet", (-2.0, 2.0), False,
                   torch.float32, 1e-5),
    "contiguous": (3, 24, 37, 61, 10, 10, "contiguous", (-2.0, 2.0), False,
                   torch.float32, 1e-5),
    "degenerate": (3, 24, 37, 61, 10, 10, "hrnet", (-2.0, 2.0), True,
                   torch.float32, 1e-5),
    "wide diagonal": (3, 24, 37, 61, 10, 10, "hrnet", (-10.0, 10.0), False,
                      torch.float32, 2e-4),
    "cell shape": (2, 24, 256, 478, 10, 10, "hrnet", (-2.0, 2.0), False,
                   torch.float32, 1e-5),
    "other classes": (2, 3, 33, 17, 4, 3, "contiguous", (-2.0, 2.0), False,
                      torch.float32, 1e-5),
    "many classes": (2, 40, 17, 19, 10, 3, "hrnet", (-2.0, 2.0), False,
                     torch.float32, 1e-5),
    "many samples": (2, 24, 19, 23, 10, 37, "hrnet", (-2.0, 2.0), False,
                     torch.float32, 1e-5),
    "float64": (3, 24, 37, 61, 10, 10, "hrnet", (-2.0, 2.0), False,
                torch.float64, 1e-12),
    "float64 degenerate": (3, 24, 37, 61, 10, 10, "contiguous", (-2.0, 2.0),
                           True, torch.float64, 1e-12),
    "float64 many classes": (2, 40, 17, 19, 16, 5, "hrnet", (-10.0, 10.0),
                             False, torch.float64, 1e-10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_kernels_match_float64_on_cuda(case, monkeypatch):
    """The capacitance within float32 rounding of float64's ``W^T D^-1
    W`` and the same run to run; the flags as ``degenerate()``'s; the
    samples' softmax, in the inputs' type, against the float64 plain
    composition (``samples``, then the softmax) on the same normals: the
    largest gap as the case states, the PE map's relative gap and the
    labels' mean gap each a tenth of the SSN cell's limits (``pe_gap``
    2.8e-3, ``label_mean_gap`` 3.2e-4) or less. H*W is no multiple of a
    block's pixels but at the cell's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (b, c, h, w, r, s, layout, log_diag, degenerate, dtype,
     atol) = CUDA_CASES[case]
    mean, cov_diag, factor = _terms(b, c, h, w, r, layout=layout,
                                    log_diag=log_diag, device="cuda",
                                    dtype=dtype)
    if degenerate:
        factor[1, 5, 3] = float("inf")
    dist = LowRankMVN(mean, cov_diag, factor)
    n = c * h * w

    cap = ssn_sample.capacitance(cov_diag, factor)
    assert cap.dtype == torch.float32
    assert torch.equal(cap, ssn_sample.capacitance(cov_diag, factor))
    wd = factor.double()
    want_cap = torch.eye(r, dtype=torch.float64, device="cuda") + (
        wd / cov_diag.double()[..., None]).transpose(1, 2) @ wd
    flags = ssn_sample.cholesky_flags(cap)
    assert torch.equal(flags, dist.degenerate())
    assert flags.tolist() == [k == 1 and degenerate for k in range(b)]
    sound = ~flags
    scale = want_cap.diagonal(dim1=1, dim2=2).sqrt()
    gap = (cap.double() - want_cap).abs() / (scale[:, :, None]
                                             * scale[:, None, :])
    assert float(gap[sound].max()) < 1e-5

    eps_r, eps_d = _normals(s, b, r, n, device="cuda", dtype=dtype)
    _replay(monkeypatch, eps_r, eps_d)
    before = ssn_sample.sample_softmax.launches
    got = dist.sample_softmax(None, s, (c, h, w)).reshape(s, b, c, h * w)
    assert ssn_sample.sample_softmax.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    plain = LowRankMVN(mean.double(), cov_diag.double(), factor.double())
    want = torch.softmax(plain.samples(eps_r.double(), eps_d.double())
                         .reshape(s, b, c, h * w), dim=2)
    assert float((got.double() - want).abs().max()) <= atol
    pe, pe_ref = _pe(got), _pe(want)
    assert float((pe - pe_ref).abs().sum() / pe_ref.abs().sum()) < 2.8e-4
    for k in range(-1, s):
        p, p_ref = (got.double().mean(0), want.mean(0)) if k < 0 else (
            got[k].double(), want[k])
        chosen = p_ref.gather(1, p.argmax(1, keepdim=True))[:, 0]
        assert float((p_ref.amax(1) - chosen).mean()) < 3.2e-5
    if degenerate:
        diagonal = torch.softmax((mean[1].double() + cov_diag[1].double()
                                  .sqrt() * eps_d[:, 1].double())
                                 .reshape(s, c, -1), dim=1)
        assert float((got[:, 1].double() - diagonal).abs().max()) <= atol
    with pytest.raises(TypeError):
        ssn_sample.sample_softmax(mean.half(), cov_diag.half(),
                                  factor.half(), flags, eps_r.half(),
                                  eps_d.half(), c)


@pytest.mark.cuda
def test_a_gradient_raises_on_cuda():
    """The kernels have no backward: on the card a required gradient
    raises, and no composition stands in for them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mean, cov_diag, factor = (t.clone().requires_grad_()
                              for t in _terms(device="cuda"))
    before = ssn_sample.sample_softmax.launches
    with pytest.raises(RuntimeError, match="no backward"):
        LowRankMVN(mean, cov_diag, factor).sample_softmax(
            torch.Generator(device="cuda").manual_seed(2), S, (C, H, W))
    assert ssn_sample.sample_softmax.launches == before
    with torch.no_grad():
        out = LowRankMVN(mean, cov_diag, factor).sample_softmax(
            torch.Generator(device="cuda").manual_seed(2), S, (C, H, W))
    assert ssn_sample.sample_softmax.launches == before + 1
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_sample_softmax_on_cuda_draws_from_the_generator():
    """Without replayed normals the method draws eps_r, then eps_d, from
    the generator it is given, as ``rsample`` does; the samples are the
    kernel's on those normals, and the same from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mean, cov_diag, factor = _terms(device="cuda")
    dist = LowRankMVN(mean, cov_diag, factor)
    gen = torch.Generator(device="cuda").manual_seed(9)
    state = gen.get_state()
    got = dist.sample_softmax(gen, S, (C, H, W))
    again = torch.Generator(device="cuda")
    again.set_state(state)
    assert torch.equal(got, dist.sample_softmax(again, S, (C, H, W)))
    again.set_state(state)
    eps_r, eps_d = PS.draw_ssn_normals(again, S, B, R, C * H * W,
                                       torch.float32, "cuda")
    want = ssn_sample.sample_softmax(mean, cov_diag, factor,
                                     dist.degenerate(), eps_r, eps_d, C)
    assert torch.equal(got.reshape(want.shape), want)
    assert math.isclose(float(got.sum()), S * B * H * W, rel_tol=1e-5)
