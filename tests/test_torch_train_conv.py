"""K1b of the port (values_tpu_torch.ops.kernels.conv3d.conv3d_fused_train):
its gradients against jax.grad through the JAX package's custom VJP
(conv3d_banded_packed_ad / _ad_stats, Pallas in interpret mode), against
finite differences (gradcheck at float64), and, where a card is present,
the CUDA path against autograd through the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.ops.pallas.conv3d import (conv3d_banded_packed_ad,
                                          conv3d_banded_packed_ad_stats,
                                          pack_ndhwc, unpack_ndhwc)
from values_tpu_torch.ops.kernels.conv3d import (conv3d_fused,
                                                 conv3d_fused_reference,
                                                 conv3d_fused_train,
                                                 flip_transpose_weight)

G, CIN, COUT, P, B = 2, 8, 8, 16, 2
BP = 128 // P                       # the JAX side's items per 128 lanes
CASES = ("none", "leaky", "relu", "stats")


def _inputs(seed=0):
    """x (B, P, P, P, G*CIN), weight, bias, and the cotangents of out
    and of the two statistics, as numpy float32."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, P, P, P, G * CIN).astype(np.float32)
    weight = (rs.randn(3, 3, 3, CIN, G * COUT) * 0.1).astype(np.float32)
    bias = rs.randn(G * COUT).astype(np.float32)
    gy = rs.randn(B, P, P, P, G * COUT).astype(np.float32)
    g1, g2 = (rs.randn(2, B, G * COUT) * 0.1).astype(np.float32)
    # no cotangent within 1e-3 of the activations' kink, where two
    # forwards that round apart may take different branches
    pre = conv3d_fused_reference(torch.tensor(x), torch.tensor(weight),
                                 torch.tensor(bias), G).numpy()
    gy[np.abs(pre) < 1e-3 * np.abs(pre).max()] = 0.0
    return x, weight, bias, gy, g1, g2


def _pad(a):
    """Zero items up to one pack of BP (padded items get zero
    cotangents, so they add nothing to dk and db)."""
    return np.concatenate([a, np.zeros((BP - B,) + a.shape[1:], a.dtype)])


def _lanes(m):
    """(B, C) per-item values -> the packed (1, C, 128) lane layout."""
    out = np.zeros((1, m.shape[1], 128), np.float32)
    for item in range(B):
        out[0, :, item * P:(item + 1) * P] = m[item][:, None]
    return jnp.asarray(out)


def _jax_grads(case):
    x, weight, bias, gy, g1, g2 = _inputs()
    xp = pack_ndhwc(jnp.asarray(_pad(x)), BP)
    gyp = pack_ndhwc(jnp.asarray(_pad(gy)), BP)

    def f(xp_, k_, b_):
        if case == "stats":
            y, (s1, s2) = conv3d_banded_packed_ad_stats(
                xp_, k_, b_, G, w_item=P, interpret=True)
            return (jnp.sum(y * gyp) + jnp.sum(s1 * _lanes(g1))
                    + jnp.sum(s2 * _lanes(g2)))
        y = conv3d_banded_packed_ad(xp_, k_, b_, G, w_item=P,
                                    activation=case, interpret=True)
        return jnp.sum(y * gyp)

    dx, dk, db = jax.grad(f, argnums=(0, 1, 2))(xp, jnp.asarray(weight),
                                                 jnp.asarray(bias))
    return (np.asarray(unpack_ndhwc(dx, BP))[:B], np.asarray(dk),
            np.asarray(db))


def _torch_grads(case, fn=conv3d_fused_train, dtype=torch.float32,
                 device="cpu"):
    x, weight, bias, gy, g1, g2 = (torch.tensor(a, device=device)
                                   for a in _inputs())
    x = x.to(dtype).requires_grad_(True)
    weight = weight.to(dtype).requires_grad_(True)
    bias = bias.requires_grad_(True)
    if case == "stats":
        y, (s1, s2) = fn(x, weight, bias, G, emit_stats=True)
        total = ((y.float() * gy).sum() + (s1 * g1).sum()
                 + (s2 * g2).sum())
    else:
        y = fn(x, weight, bias, G, activation=case)
        total = (y.float() * gy).sum()
    return torch.autograd.grad(total, (x, weight, bias))


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad through the JAX package's custom VJPs, once per file."""
    return {case: _jax_grads(case) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_k1b_matches_jax_custom_vjp(jax_grads, case):
    """dx, dk, db at G=2 against jax.grad of the Pallas custom VJP:
    atol 2e-5 max|g| without an activation, 1e-3 max|g| with one (the
    bounds of tests/test_packed_training.py: where the two forwards round
    a pre-activation near 0 apart, the activation's derivative takes the
    other branch)."""
    tol = 2e-5 if case in ("none", "stats") else 1e-3
    got = _torch_grads(case)
    for name, g, w in zip(("dx", "dk", "db"), got, jax_grads[case]):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=tol * scale, rtol=0,
                                   err_msg=f"{case} {name}")


def test_flipped_weight_is_the_adjoint_at_g2():
    """<conv(x, W), y> = <x, conv(y, flip_transpose(W))> per group, f64:
    the group transpose is what a G=1 check cannot see."""
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(1, 5, 4, 6, G * 3))
    y = torch.tensor(rs.randn(1, 5, 4, 6, G * 2))
    w = torch.tensor(rs.randn(3, 3, 3, 3, G * 2))
    lhs = (conv3d_fused_reference(x, w, None, G) * y).sum()
    rhs = (x * conv3d_fused_reference(y, flip_transpose_weight(w, G), None,
                                      G)).sum()
    assert abs(float(lhs - rhs)) < 1e-10 * float(abs(lhs))


@pytest.mark.parametrize("case", CASES)
def test_gradcheck_float64(case):
    """Finite differences at float64 on a tiny G=2 shape; the stats case
    checks both statistics' cotangents and the output's. ``fast_mode``
    holds the analytical against the numerical Jacobian along random
    directions of the inputs and outputs, so a wrong derivative still
    fails, in about a second instead of a minute."""
    rs = np.random.RandomState(1)
    x = torch.tensor(rs.randn(2, 3, 4, 3, 2 * 2), requires_grad=True)
    w = torch.tensor(rs.randn(3, 3, 3, 2, 2 * 3) * 0.3, requires_grad=True)
    b = torch.tensor(rs.randn(2 * 3), requires_grad=True)

    def f(x_, w_, b_):
        if case == "stats":
            y, (s1, s2) = conv3d_fused_train(x_, w_, b_, 2, emit_stats=True)
            return y, s1, s2
        return conv3d_fused_train(x_, w_, b_, 2, activation=case)

    assert torch.autograd.gradcheck(f, (x, w, b), eps=1e-6, atol=1e-7,
                                    fast_mode=True)


def test_backward_wiring_on_cpu():
    """On CPU tensors K1b counts no launch; dx is skipped where x needs
    no gradient; a statistic left unused arrives as None; statistics of
    an activated output are refused."""
    rs = np.random.RandomState(2)
    x = torch.tensor(rs.randn(1, 4, 4, 4, 2), dtype=torch.float32)
    w = torch.tensor(rs.randn(3, 3, 3, 2, 2), dtype=torch.float32,
                     requires_grad=True)
    before = (conv3d_fused.launches, conv3d_fused_train.launches)
    y, (s1, _) = conv3d_fused_train(x, w, None, 1, emit_stats=True)
    (y.sum() + s1.sum()).backward()
    assert (conv3d_fused.launches, conv3d_fused_train.launches) == before
    assert x.grad is None
    y, (s1, _) = conv3d_fused_reference(x, w, None, 1, emit_stats=True)
    want, = torch.autograd.grad(y.sum() + s1.sum(), w)
    torch.testing.assert_close(w.grad, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="emit_stats"):
        conv3d_fused_train(x, w, None, 1, activation="relu", emit_stats=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1b_matches_plain_on_cuda(dtype):
    """On the card: dx, dW, db of K1b against autograd through the plain
    version. float32: atol 1e-4 max|g| (summation orders; TF32 off);
    bfloat16: 2**-7 relative + 2e-3 max|g|, K1's bf16 rule. The dx of
    each backward launches K1 once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    for case in CASES:
        before = (conv3d_fused.launches, conv3d_fused_train.launches)
        got = _torch_grads(case, dtype=dtype, device="cuda")
        assert (conv3d_fused.launches, conv3d_fused_train.launches) == (
            before[0] + 2, before[1] + 1), case
        want = _torch_grads(case, fn=lambda *a, **k: conv3d_fused_reference(
            *a, **k), dtype=dtype, device="cuda")
        for name, g, w in zip(("dx", "dW", "db"), got, want):
            g, w = g.float().cpu(), w.float().cpu()
            scale = float(w.abs().max())
            if dtype == torch.float32:
                np.testing.assert_allclose(g, w, atol=1e-4 * scale, rtol=0,
                                           err_msg=f"{case} {name}")
            else:
                np.testing.assert_allclose(g, w, rtol=2 ** -7,
                                           atol=2e-3 * scale,
                                           err_msg=f"{case} {name}")


def test_bf16_stats_fold_rounds_away_a_small_shift():
    """Fault R5 (ROADMAP.md Queue 3), kept from the JAX package
    (conv3d.py:1164-1168): in bfloat16 the statistics' cotangents are
    folded into dy and the sum is rounded to bfloat16 before dx, dW and
    db are taken, so a per-channel ds1 below half a bf16 ulp of dy is
    lost. With dy = 1 and ds1 = 1e-3 (half an ulp at 1 is 2**-8), db is
    n where float32 gives n (1 + 1e-3)."""
    rs = np.random.RandomState(4)
    n = 4 * 4 * 4
    db = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(rs.randn(1, 4, 4, 4, 1)).to(dtype)
        w = torch.tensor(rs.randn(3, 3, 3, 1, 1)).to(dtype)
        b = torch.zeros(1, requires_grad=True)
        y, (s1, _) = conv3d_fused_train(x, w, b, 1, emit_stats=True)
        (y.float().sum() + 1e-3 * s1.sum()).backward()
        db[dtype] = float(b.grad)
    assert db[torch.bfloat16] == n
    assert db[torch.float32] == pytest.approx(n * (1 + 1e-3), rel=1e-6)
