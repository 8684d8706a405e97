"""What surrounds K1's CUDA kernels (values_tpu_torch.ops.kernels.conv3d),
on the CPU: the regime and tile that ``plan`` picks for every conv of the
scoring and training paths, the shared memory each takes, the shapes no
regime takes, and the K order the tensor-core kernels read the weight in
(an im2col product in float64 against the plain version)."""
import numpy as np
import pytest
import torch

from values_tpu_torch.ops.kernels.conv3d import (SMEM_LIMIT, _row_stride,
                                                 concat_groups,
                                                 conv3d_fused_reference,
                                                 flip_transpose_weight, plan)

F = 8  # the UNet3D's initial filter size
# (name, volume, Cin1, Cin2, Cout) of the 18 3x3x3 convs of the fused
# forward (models/ensemble_unet3d.py::grouped_forward_fused), in order
CONVS = [
    ("contr_1_1", 64, 1, 0, F), ("contr_1_2", 64, F, 0, F),
    ("contr_2_1", 32, F, 0, 2 * F), ("contr_2_2", 32, 2 * F, 0, 2 * F),
    ("contr_3_1", 16, 2 * F, 0, 4 * F), ("contr_3_2", 16, 4 * F, 0, 4 * F),
    ("contr_4_1", 8, 4 * F, 0, 8 * F), ("contr_4_2", 8, 8 * F, 0, 8 * F),
    ("center_conv1", 4, 8 * F, 0, 16 * F),
    ("center_conv2", 4, 16 * F, 0, 16 * F),
    ("expand_4_1", 8, 8 * F, 8 * F, 8 * F), ("expand_4_2", 8, 8 * F, 0, 8 * F),
    ("expand_3_1", 16, 4 * F, 4 * F, 4 * F),
    ("expand_3_2", 16, 4 * F, 0, 4 * F),
    ("expand_2_1", 32, 2 * F, 2 * F, 2 * F),
    ("expand_2_2", 32, 2 * F, 0, 2 * F),
    ("expand_1_1", 64, F, F, F), ("expand_1_2", 64, F, 0, F),
]
# the regime of each, at G 5 (scoring) and G 1 (training, forward and dx)
REGIME = {
    "contr_1_1": "cin1", "contr_1_2": "shallow", "contr_2_1": "shallow",
    "contr_2_2": "shallow", "contr_3_1": "tile16", "contr_3_2": "tile16",
    "contr_4_1": "tile8", "contr_4_2": "tile8", "center_conv1": "tile4",
    "center_conv2": "tile4", "expand_4_1": "tile8", "expand_4_2": "tile8",
    "expand_3_1": "tile16", "expand_3_2": "tile16", "expand_2_1": "tile16",
    "expand_2_2": "shallow", "expand_1_1": "shallow", "expand_1_2": "shallow",
}
TILES = {"cin1": (8, 8, 32), "tile16": (2, 8, 16), "tile8": (4, 8, 8),
         "tile4": (4, 4, 4)}


def _check(launch, regime):
    assert launch.regime == regime
    assert 0 < launch.smem_bytes <= SMEM_LIMIT
    if regime == "shallow":
        assert launch.tile == ((4, 8, 16) if launch.block_n == 8
                               else (2, 8, 16))
    else:
        assert launch.tile == TILES[regime]


@pytest.mark.parametrize("name,size,cin1,cin2,cout", CONVS,
                         ids=[c[0] for c in CONVS])
def test_scoring_conv_plan(name, size, cin1, cin2, cout):
    """G 5 (the ensemble's members), x2 as the decoder's skip input."""
    launch = plan(torch.bfloat16, size, size, size, 5, cin1, cin2, cout)
    _check(launch, REGIME[name])
    assert cout % launch.block_n == 0


TRAIN = ([("fwd " + c[0], c[1], c[2] + c[3], c[4], REGIME[c[0]])
          for c in CONVS]
         + [("dx " + c[0], c[1], c[4], c[2] + c[3], REGIME[c[0]])
            for c in CONVS[1:]])


@pytest.mark.parametrize("name,size,cin,cout,regime", TRAIN,
                         ids=[t[0] for t in TRAIN])
def test_training_shape_plan(name, size, cin, cout, regime):
    """G 1: the training forward takes the concat as one input; dx is K1
    with Cin and Cout swapped (the first conv's dx is never taken)."""
    _check(plan(torch.bfloat16, size, size, size, 1, cin, 0, cout), regime)


def test_training_has_35_convs():
    assert len(TRAIN) == 35


@pytest.mark.parametrize("dims,groups,cin1,cin2,cout", [
    ((20, 12, 28), 5, 8, 0, 8), ((9, 12, 10), 5, 64, 0, 32),
    ((6, 7, 5), 5, 32, 32, 64), ((16, 16, 16), 5, 32, 32, 32)])
def test_ragged_and_odd_volumes_plan(dims, groups, cin1, cin2, cout):
    launch = plan(torch.bfloat16, *dims, groups, cin1, cin2, cout)
    assert launch.smem_bytes <= SMEM_LIMIT
    assert launch.regime in ("shallow", "tile16", "tile8", "tile4")


@pytest.mark.parametrize("dtype,cin1,cin2,cout", [
    (torch.bfloat16, 24, 0, 8),     # Cin / 8 not a power of two
    (torch.bfloat16, 8, 0, 12),     # Cout not a multiple of 8
    (torch.bfloat16, 4, 0, 8),      # Cin neither 1 nor a multiple of 8
    (torch.bfloat16, 8, 4, 8),      # Cin2 not a multiple of 8
    (torch.float16, 8, 0, 8)])      # no float16 kernel
def test_plan_raises_where_no_regime_takes_the_shape(dtype, cin1, cin2,
                                                     cout):
    with pytest.raises(ValueError):
        plan(dtype, 16, 16, 16, 2, cin1, cin2, cout)


def test_float32_always_takes_the_cuda_core_kernel():
    for cin1, cin2, cout in ((1, 0, 8), (24, 0, 12), (8, 8, 8)):
        assert plan(torch.float32, 8, 8, 8, 2, cin1, cin2, cout).regime \
            == "f32"


@pytest.mark.parametrize("tile,stride", [((4, 8, 16), 24), ((2, 8, 16), 24),
                                         ((4, 8, 8), 12), ((4, 4, 4), 8)])
def test_row_stride_keeps_fragment_rows_in_phase(tile, stride):
    """The padded row stride of each tile (conv3d_fused.cu::row_stride):
    tile rows 16 apart lie a multiple of 8 stored voxels apart, and no
    smaller stride does that."""
    td, th, tw = tile

    def stored(m, hwd):
        return (m // (tw * th) * (th + 2) + m // tw % th) * hwd + m % tw

    assert _row_stride(*tile) == stride
    for hwd in range(tw + 2, stride + 1):
        ok = all((stored(m, hwd) - stored(m % 16, hwd)) % 8 == 0
                 for m in range(16, td * th * tw))
        assert ok == (hwd == stride)


def _im2col_conv(v, weight, bias, groups, k_pad):
    """The tensor-core kernels' GEMM written out in float64: per group,
    rows of 27 Cin values in (tap, channel) order (taps kd, kh, kw, the
    SAME padding as zeros), zero-padded to k_pad, times the weight's
    DHWIO rows (3*3*3*Cin, Cout) of that group padded alike, plus bias."""
    b, d, h, w, gc = v.shape
    cin, cout = gc // groups, weight.shape[-1] // groups
    vp = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1, 1, 1))
    taps = [vp[:, kd:kd + d, kh:kh + h, kw:kw + w]
            for kd in range(3) for kh in range(3) for kw in range(3)]
    cols = torch.stack(taps, dim=-2)                   # (..., 27, G*Cin)
    out = []
    for g in range(groups):
        a = cols[..., g * cin:(g + 1) * cin].reshape(-1, 27 * cin)
        wg = weight[..., g * cout:(g + 1) * cout].reshape(27 * cin, cout)
        a = torch.nn.functional.pad(a, (0, k_pad - 27 * cin))
        wg = torch.nn.functional.pad(wg, (0, 0, 0, k_pad - 27 * cin))
        out.append(a @ wg + bias[g * cout:(g + 1) * cout])
    return torch.cat(out, dim=-1).reshape(b, d, h, w, groups * cout)


@pytest.mark.parametrize("groups", [1, 2, 5])
@pytest.mark.parametrize("cin,x2", [(1, False), (8, False), (16, False),
                                    (8, True), (16, True)])
def test_k_order_im2col_equals_the_plain_version(groups, cin, x2):
    """The weight rows the kernels read, (tap, channel) with x's block g
    before x2's, padded to the plan's K, give the plain version's conv to
    1e-12 in float64."""
    rs = np.random.RandomState(groups * 100 + cin + x2)
    b, d, h, w, cout = 2, 5, 6, 7, 8
    x = torch.tensor(rs.rand(b, d, h, w, groups * cin))
    xb = torch.tensor(rs.rand(b, d, h, w, groups * cin)) if x2 else None
    cin_all = 2 * cin if x2 else cin
    weight = torch.tensor(rs.randn(3, 3, 3, cin_all, groups * cout))
    bias = torch.tensor(rs.rand(groups * cout))
    v = x if xb is None else concat_groups(x, xb, groups)
    launch = plan(torch.bfloat16, d, h, w, groups, cin, cin if x2 else 0,
                  cout)
    k_pad = -(-27 * cin_all // launch.k_chunk) * launch.k_chunk
    got = _im2col_conv(v, weight, bias, groups, k_pad)
    want = conv3d_fused_reference(x, weight, bias, groups, x2=xb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)


@pytest.mark.parametrize("groups", [1, 2, 5])
def test_k_order_of_the_dx_weight(groups):
    """dx runs K1 on the flipped, group-transposed weight: its (tap,
    channel) rows through the im2col product equal the plain version."""
    rs = np.random.RandomState(7 + groups)
    cin, cout = 16, 8
    dy = torch.tensor(rs.rand(2, 4, 5, 6, groups * cout))
    weight = torch.tensor(rs.randn(3, 3, 3, cin, groups * cout))
    wt = flip_transpose_weight(weight, groups)
    zero = torch.zeros(groups * cin, dtype=torch.float64)
    launch = plan(torch.bfloat16, 4, 5, 6, groups, cout, 0, cin)
    k_pad = -(-27 * cout // launch.k_chunk) * launch.k_chunk
    got = _im2col_conv(dy, wt, zero, groups, k_pad)
    want = conv3d_fused_reference(dy, wt, None, groups)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-12)
