"""K1 of the port (values_tpu_torch.ops.kernels.conv3d): the plain
version against the Pallas kernel it replaces, run in interpret mode, and
against F.conv3d with the fusions written out; the CUDA kernel against
the plain version where a card is present."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from values_tpu.ops.pallas.conv3d import (conv3d_banded_packed, pack_ndhwc,
                                          unpack_ndhwc)
from values_tpu_torch.ops.kernels.conv3d import (concat_groups,
                                                 conv3d_fused,
                                                 conv3d_fused_reference)

G, C, P, B = 2, 8, 16, 8
BP = 128 // P                       # the JAX side's packed items per 128 lanes

CASES = {
    "plain": dict(),
    "x2": dict(x2=True),
    "prologue": dict(prologue=True),
    "leaky": dict(activation="leaky"),
    "relu_stats": dict(activation="relu", emit_stats=True),
    "x2_prologue_leaky_stats": dict(x2=True, prologue=True,
                                    activation="leaky", emit_stats=True),
}


def _inputs(case, seed=0):
    """numpy inputs of one case: x, x2 (or None), weight, bias, maps."""
    rs = np.random.RandomState(seed)
    cin2 = C if case.get("x2") else 0
    x = rs.rand(B, P, P, P, G * C)
    x2 = rs.rand(B, P, P, P, G * cin2) if cin2 else None
    # a positive mean keeps the stats' sums free of cancellation
    weight = (rs.rand(3, 3, 3, C + cin2, G * C) - 0.3) * 0.2
    bias = rs.rand(G * C) * 0.1
    maps = None
    if case.get("prologue"):
        n = G * (C + cin2)
        slope = rs.choice([1.0, 0.01, 0.0], size=(B, n))
        maps = (rs.rand(B, n) + 0.5, rs.rand(B, n) - 0.5, slope)
    return x, x2, weight, bias, maps


def _lane_maps(m):
    """(B, C) per-item maps -> the JAX kernel's (B/bp, C, 128) lanes."""
    out = np.zeros((B // BP, m.shape[1], 128), np.float32)
    for item in range(B):
        blk = item % BP
        out[item // BP, :, blk * P:(blk + 1) * P] = m[item][:, None]
    return jnp.asarray(out)


def _item_stats(s):
    """The JAX kernel's lane-resolved (B/bp, C, 128) sums -> (B, C)."""
    s = np.asarray(s)
    nb, c, _ = s.shape
    return s.reshape(nb, c, BP, P).sum(-1).transpose(0, 2, 1).reshape(-1, c)


def _jax_conv(case):
    x, x2, weight, bias, maps = _inputs(case)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    res = conv3d_banded_packed(
        pack_ndhwc(f32(x), BP), f32(weight), f32(bias), G, w_item=P,
        x2=None if x2 is None else pack_ndhwc(f32(x2), BP),
        prologue=None if maps is None else tuple(_lane_maps(m)
                                                  for m in maps),
        activation=case.get("activation", "none"),
        emit_stats=case.get("emit_stats", False), interpret=True)
    if case.get("emit_stats"):
        out, (ssum, ssq) = res
        return (np.asarray(unpack_ndhwc(out, BP)),
                (_item_stats(ssum), _item_stats(ssq)))
    return np.asarray(unpack_ndhwc(res, BP)), None


def _torch_conv(case, fn, dtype=torch.float32, device="cpu"):
    """Run ``fn`` on one case's inputs; bias and prologue maps are
    float32 as the kernel takes them (float64 for a float64 run)."""
    x, x2, weight, bias, maps = _inputs(case)
    aux = torch.float64 if dtype == torch.float64 else torch.float32

    def t(a, dt=dtype):
        return None if a is None else torch.tensor(a, dtype=dt,
                                                   device=device)

    res = fn(t(x), t(weight), t(bias, aux), G, x2=t(x2),
             prologue=None if maps is None else tuple(t(m, aux)
                                                      for m in maps),
             activation=case.get("activation", "none"),
             emit_stats=case.get("emit_stats", False))
    return res if case.get("emit_stats") else (res, None)


@pytest.fixture(scope="module")
def jax_outputs():
    """The Pallas kernel's outputs, computed once for the whole file."""
    return {name: _jax_conv(case) for name, case in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernel(jax_outputs, name):
    """f32: atol 1e-4 on outputs, rtol 1e-5 on stats -- the two sides
    add at most 27*16 products per output, and 16^3 outputs per stat,
    in different orders."""
    want, want_stats = jax_outputs[name]
    got, got_stats = _torch_conv(CASES[name], conv3d_fused)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if want_stats is not None:
        for g, w in zip(got_stats, want_stats):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-3)


def _spelled_out(x, weight, bias, groups, *, x2=None, prologue=None,
                 activation="none", emit_stats=False):
    """The contract written with stock ops, NCDHW: concat, prologue,
    zero-padded grouped conv, bias, stats, activation."""
    v = x if x2 is None else concat_groups(x, x2, groups)
    v = v.permute(0, 4, 1, 2, 3)
    if prologue is not None:
        sc, sh, sl = (m[:, :, None, None, None] for m in prologue)
        u = v * sc - sh
        v = torch.where(u * sl > u, u * sl, u)
    y = F.conv3d(v, weight.permute(4, 3, 0, 1, 2), bias, padding=1,
                 groups=groups)
    stats = (y.sum(dim=(2, 3, 4)), (y ** 2).sum(dim=(2, 3, 4)))
    if activation == "leaky":
        y = F.leaky_relu(y, 0.01)
    elif activation == "relu":
        y = F.relu(y)
    y = y.permute(0, 2, 3, 4, 1)
    return (y, stats) if emit_stats else y


@pytest.mark.parametrize("name", ["plain", "x2_prologue_leaky_stats",
                                  "relu_stats"])
def test_plain_f64_matches_spelled_out_conv(name):
    """f64: the plain version equals F.conv3d(groups=G) with the fusions
    written out, to 1e-12."""
    got, got_stats = _torch_conv(CASES[name], conv3d_fused_reference,
                                 dtype=torch.float64)
    x, x2, weight, bias, maps = _inputs(CASES[name])
    t = lambda a: None if a is None else torch.tensor(a)  # noqa: E731
    want = _spelled_out(t(x), t(weight), t(bias), G, x2=t(x2),
                        prologue=None if maps is None else tuple(
                            t(m) for m in maps),
                        activation=CASES[name].get("activation", "none"),
                        emit_stats=got_stats is not None)
    if got_stats is not None:
        want, want_stats = want
        for g, w in zip(got_stats, want_stats):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


def test_cpu_tensors_take_the_plain_version():
    before = conv3d_fused.launches
    got, _ = _torch_conv(CASES["plain"], conv3d_fused)
    want, _ = _torch_conv(CASES["plain"], conv3d_fused_reference)
    assert conv3d_fused.launches == before
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        _torch_conv(dict(activation="gelu"), conv3d_fused)


# one shape per regime of conv3d.plan (bf16; float32 always runs "f32"):
# (regime, B, (D, H, W), G, Cin1, Cin2, Cout)
REGIME_CASES = [
    ("cin1", 2, (16, 12, 20), 5, 1, 0, 8),
    ("shallow", 2, (16, 16, 16), 2, 8, 8, 16),
    ("tile16", 2, (16, 16, 16), 2, 16, 16, 32),
    ("tile8", 2, (9, 12, 10), 2, 32, 0, 32),
    ("tile4", 2, (4, 4, 4), 2, 64, 0, 64),
]


def _regime_case(regime, b, dims, groups, cin1, cin2, cout):
    """numpy-seeded inputs of a regime case, with x2, prologue and stats
    where the shape has them: (x, weight, bias, x2, maps)."""
    rs = np.random.RandomState(len(regime) + cin1 + cout)
    x = rs.rand(b, *dims, groups * cin1)
    x2 = rs.rand(b, *dims, groups * cin2) if cin2 else None
    cin = cin1 + cin2
    weight = (rs.rand(3, 3, 3, cin, groups * cout) - 0.3) * 2 / \
        np.sqrt(27 * cin)
    bias = rs.rand(groups * cout) * 0.1
    n = groups * cin
    maps = (rs.rand(b, n) + 0.5, rs.rand(b, n) - 0.5,
            rs.choice([1.0, 0.01, 0.0], size=(b, n)))
    return x, weight, bias, x2, maps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(dtype):
    """The CUDA kernel against the plain version on the card: f32 atol
    1e-4 (summation order; TF32 off on the plain side); bf16 one output
    ulp (2**-7 relative) plus 2e-3 of the range, for roundings to the
    neighbouring bf16 value. The cases of the file, then one per regime
    of ``plan``, each checked to launch that regime."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False

    def compare(got, want, got_stats, want_stats, name):
        got, want = got.float().cpu(), want.float().cpu()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
        else:
            atol = 2e-3 * float(want.abs().max())
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=atol,
                                       err_msg=name)
        if want_stats is not None:
            for g, w in zip(got_stats, want_stats):
                np.testing.assert_allclose(g.cpu(), w.cpu(), rtol=1e-3,
                                           atol=1e-2, err_msg=name)

    for name, case in CASES.items():
        before = conv3d_fused.launches
        got, got_stats = _torch_conv(case, conv3d_fused, dtype, "cuda")
        want, want_stats = _torch_conv(case, conv3d_fused_reference, dtype,
                                       "cuda")
        assert conv3d_fused.launches == before + 1, name
        compare(got, want, got_stats, want_stats, name)

    for regime, *shape in REGIME_CASES:
        x, weight, bias, x2, maps = _regime_case(regime, *shape)
        t = lambda a, dt=dtype: None if a is None else torch.tensor(  # noqa
            a, dtype=dt, device="cuda")
        args = (t(x), t(weight), t(bias, torch.float32), shape[2])
        kw = dict(x2=t(x2), prologue=tuple(t(m, torch.float32)
                                           for m in maps),
                  activation="leaky", emit_stats=False)
        stats = dict(kw, activation="none", emit_stats=True)
        want_regime = "f32" if dtype == torch.float32 else regime
        for options in (kw, stats):
            before = dict(conv3d_fused.regime_launches)
            got = conv3d_fused(*args, **options)
            ran = {k: v - before[k] for k, v in
                   conv3d_fused.regime_launches.items() if v != before[k]}
            assert ran == {want_regime: 1}, (regime, ran)
            want = conv3d_fused_reference(*args, **options)
            if options["emit_stats"]:
                compare(got[0], want[0], got[1], want[1], regime)
            else:
                compare(got, want, None, None, regime)
