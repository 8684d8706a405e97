"""K1's bfloat16 channel padding (values_tpu_torch.ops.kernels.conv3d::
run_padded, run_padded_dx), on the CPU: the padded operands through the
plain version, sliced back, equal the plain version on the unpadded
operands (forward with x2, prologue, activation and statistics; the dx
entry with each fold), and the padded shapes are ones ``plan`` and
``plan_dx`` take. The card's check of the same cases against the kernels
is chip_smoke.py::check_k1 and check_k1b."""
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu_torch.ops.kernels.conv3d import (
    SMEM_LIMIT, conv3d_fused_dx_reference, conv3d_fused_reference,
    dx_padded_channels, padded_channels, plan, plan_dx, run_padded,
    run_padded_dx)

# (Cin1, Cin2, Cout) a group, with the padded counts K1 runs them at
SHAPES = [((4, 0, 6), (8, 0, 8)), ((12, 0, 12), (16, 0, 16)),
          ((6, 6, 12), (8, 8, 16)), ((1, 0, 6), (1, 0, 8)),
          ((12, 0, 6), (16, 0, 8)), ((24, 0, 8), (32, 0, 8))]


def _operands(groups, cin1, cin2, cout, seed=0, prologue=True):
    rng = np.random.RandomState(seed)
    shape = (2, 4, 5, 6)

    def t(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64)

    x = t(*shape, groups * cin1)
    x2 = t(*shape, groups * cin2) if cin2 else None
    weight = t(3, 3, 3, cin1 + cin2, groups * cout)
    bias = t(groups * cout)
    maps = None
    if prologue:
        maps = (t(2, groups * (cin1 + cin2)), t(2, groups * (cin1 + cin2)),
                torch.full((2, groups * (cin1 + cin2)), 0.01,
                            dtype=torch.float64))
    return x, x2, weight, bias, maps


@pytest.mark.parametrize("shape,padded", SHAPES,
                         ids=[f"{a}+{b}->{c}" for (a, b, c), _ in SHAPES])
def test_padded_channels_are_planned(shape, padded):
    assert padded_channels(torch.bfloat16, *shape) == padded
    assert padded_channels(torch.float32, *shape) == shape
    plan(torch.bfloat16, 8, 8, 16, 2, *padded)
    if shape[0] != 1:
        cout_p, cin_p = dx_padded_channels(torch.bfloat16, shape[2],
                                           shape[0] + shape[1])
        plan_dx(torch.bfloat16, 8, 8, 16, 2, cout_p, cin_p)


def test_a_tile_too_large_for_shared_memory_gives_way_to_a_smaller():
    """UNet3D f 12's expand_4_1 (8^3, 96 + 96 -> 96) pads to 128 + 128,
    whose 4x8x8 haloed tile exceeds shared memory: plan takes 4x4x4,
    forward and dx; shapes that fit keep their tile."""
    assert padded_channels(torch.bfloat16, 96, 96, 96) == (128, 128, 96)
    launch = plan(torch.bfloat16, 8, 8, 8, 1, 128, 128, 96)
    assert launch.regime == "tile4" and launch.smem_bytes <= SMEM_LIMIT
    assert plan(torch.bfloat16, 8, 8, 8, 1, 64, 64, 64).regime == "tile8"
    assert plan_dx(torch.bfloat16, 8, 8, 8, 1,
                   *dx_padded_channels(torch.bfloat16, 96, 192)).smem_bytes \
        <= SMEM_LIMIT


def test_a_shape_no_regime_takes_after_padding_still_raises():
    assert padded_channels(torch.bfloat16, 16, 8, 8) == (16, 8, 8)
    with pytest.raises(ValueError):
        plan(torch.bfloat16, 8, 8, 16, 2, 16, 8, 8)


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("activation,stats", [("leaky", False),
                                              ("none", True)])
@pytest.mark.parametrize("shape,padded", SHAPES,
                         ids=[f"{a}+{b}->{c}" for (a, b, c), _ in SHAPES])
def test_padded_forward_equals_plain(shape, padded, groups, activation,
                                     stats):
    x, x2, weight, bias, maps = _operands(groups, *shape)
    kw = dict(x2=x2, prologue=maps, activation=activation, emit_stats=stats)
    want = conv3d_fused_reference(x, weight, bias, groups, **kw)
    got = run_padded(conv3d_fused_reference, x, weight, bias, groups,
                     padded, **kw)
    if stats:
        (want, want_s), (got, got_s) = want, got
        for g, w in zip(got_s, want_s):
            torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-10)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("fold", ["none", "leaky", "stats"])
@pytest.mark.parametrize("cin,cout", [(4, 6), (12, 12), (12, 6), (6, 12)])
def test_padded_dx_equals_plain(cin, cout, fold, groups):
    rng = np.random.RandomState(1)

    def t(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64)

    dy, y = t(2, 4, 5, 6, groups * cout), t(2, 4, 5, 6, groups * cout)
    weight = t(3, 3, 3, cin, groups * cout)
    ds1, ds2 = t(2, groups * cout), t(2, groups * cout)
    kw = dict(y=y, fold=fold, ds1=ds1 if fold == "stats" else None,
              ds2=ds2 if fold == "stats" else None, cotangent=True,
              bias_grad=True)
    want = conv3d_fused_dx_reference(dy, weight, groups, **kw)
    channels = dx_padded_channels(torch.bfloat16, cout, cin)
    assert channels[0] % 8 == 0 and channels[1] % 8 == 0
    got = run_padded_dx(conv3d_fused_dx_reference, dy, weight, groups,
                        channels, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-10)
