"""K1b's dx entry and K1's tf32x3 regime (values_tpu_torch.ops.kernels.
conv3d), on the CPU: the 3xTF32 split written in torch with the kernel's
rounding, the index through which the dx entry reads the forward's weight
against ``flip_transpose_weight``, the regime and shared memory of every
dx of the training path, and the entry's plain version against autograd
through K1's plain version and the JAX package's fold. Where a card is
present, the entry and the tf32x3 regime against their plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.ops.pallas.conv3d import conv3d_banded_packed_ad
from values_tpu_torch.ops.kernels.conv3d import (SMEM_LIMIT, FOLDS,
                                                 conv3d_fused,
                                                 conv3d_fused_dx,
                                                 conv3d_fused_dx_reference,
                                                 conv3d_fused_reference,
                                                 flip_transpose_weight,
                                                 fold_cotangent, plan,
                                                 plan_dx)

F = 8  # the UNet3D's initial filter size
# (volume, forward Cin, forward Cout) of the 17 convs whose dx a training
# step takes (the first conv, Cin 1, has none); the forward takes the
# decoder's concat as one input
DX_CONVS = [
    (64, F, F), (32, F, 2 * F), (32, 2 * F, 2 * F), (16, 2 * F, 4 * F),
    (16, 4 * F, 4 * F), (8, 4 * F, 8 * F), (8, 8 * F, 8 * F),
    (4, 8 * F, 16 * F), (4, 16 * F, 16 * F), (8, 16 * F, 8 * F),
    (8, 8 * F, 8 * F), (16, 8 * F, 4 * F), (16, 4 * F, 4 * F),
    (32, 4 * F, 2 * F), (32, 2 * F, 2 * F), (64, 2 * F, F), (64, F, F)]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (on the sign-magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """The kernel's split_tf32: big = tf32(x), small = tf32(x - big)."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def test_tf32_split_reconstructs_float32():
    """big and small are TF32 values (13 low bits zero), and big + small
    is x to 2**-22 of |x|: the first rounding leaves at most 2**-11 |x|,
    the second at most 2**-11 of that."""
    rs = np.random.RandomState(0)
    x = torch.tensor(np.concatenate([
        rs.randn(4096), rs.randn(1024) * 1e-3, rs.randn(1024) * 1e3,
        [1.0, -1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12, 0.0]]),
        dtype=torch.float32)
    big, small = split_tf32(x)
    for part in (big, small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (x.double() - big.double() - small.double()).abs()
    assert bool((err <= 2 ** -22 * x.double().abs()).all())
    assert float(big[-3]) == 1 + 2 ** -10   # a tie rounds away from zero


def _mma_order_sum(parts, k_step=8, k_chunk=64):
    """sum_k of the products in parts (each (M, K, N) float64, exact
    products of TF32 values) in the kernel's order: per K step of 8, the
    8-deep dots of the parts (small.big, big.small, big.big) added into a
    float32 partial of the step's chunk of 64 K rows, which is added to
    the float32 sum when the chunk ends. Each addition rounds to nearest
    here; the tensor cores truncate into the partial, which the card's
    tests hold."""
    m, k, n = parts[0].shape
    acc = torch.zeros(m, n, dtype=torch.float32)
    for c0 in range(0, k, k_chunk):
        part = torch.zeros(m, n, dtype=torch.float32)
        for k0 in range(c0, min(c0 + k_chunk, k), k_step):
            for p in parts:
                part = (part.double() + p[:, k0:k0 + k_step].sum(dim=1)
                        ).float()
        acc = acc + part
    return acc


def test_tf32x3_product_keeps_float32_accuracy():
    """At expand_1_1's K depth (27 x 16 = 432), the 3xTF32 product with
    float32 accumulation in the kernel's mma order is within 2**-20 of
    the float64 product, relative to the float64 sum of the products'
    magnitudes; one TF32 pass is not."""
    rs = np.random.RandomState(1)
    k = 27 * 16
    a = torch.tensor(rs.randn(32, k), dtype=torch.float32)
    b = torch.tensor(rs.randn(k, 8) / np.sqrt(k), dtype=torch.float32)
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)

    def prod(x, y):
        return x.double()[:, :, None] * y.double()[None, :, :]

    three = _mma_order_sum([prod(as_, bb), prod(ab, bs), prod(ab, bb)])
    one = _mma_order_sum([prod(ab, bb)])
    err3 = float(((three.double() - want).abs() / scale).max())
    err1 = float(((one.double() - want).abs() / scale).max())
    assert err3 <= 2 ** -20
    assert err1 > 2 ** -16


def _dx_weight_index(cin, cout, groups):
    """conv3d_fused.cu::stage_weights_flip's read: element (tap, c,
    g Cin + n) of the dx weight (3, 3, 3, Cout, G*Cin) is the forward
    weight's (3, 3, 3, Cin, G*Cout) flat element ((26 - tap) Cin + n)
    G Cout + g Cout + c."""
    tap, c, g, n = torch.meshgrid(torch.arange(27), torch.arange(cout),
                                  torch.arange(groups), torch.arange(cin),
                                  indexing="ij")
    flat = ((26 - tap) * cin + n) * groups * cout + g * cout + c
    return flat.reshape(3, 3, 3, cout, groups * cin)


@pytest.mark.parametrize("groups", [1, 2, 5])
@pytest.mark.parametrize("cin,cout", [(16, 8), (8, 16), (32, 64)])
def test_dx_weight_index_is_flip_transpose(groups, cin, cout):
    """The flipped, group-transposed weight the dx entry stages, read
    straight from the forward's weight, is flip_transpose_weight's,
    element for element."""
    rs = np.random.RandomState(groups * 10 + cin)
    weight = torch.tensor(rs.randn(3, 3, 3, cin, groups * cout))
    got = weight.flatten()[_dx_weight_index(cin, cout, groups)]
    assert torch.equal(got, flip_transpose_weight(weight, groups))


@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_training_dx_has_a_launch(dtype, groups):
    """Each of the 17 dx convs of a training step (G 1) and of a joint
    step (G 5) has a dx launch that fits shared memory: tf32x3 in
    float32, a bf16 tensor-core regime in bfloat16, never cin1."""
    for size, cin, cout in DX_CONVS:
        launch = plan_dx(dtype, size, size, size, groups, cout, cin)
        assert 0 < launch.smem_bytes <= SMEM_LIMIT
        if dtype == torch.float32:
            assert launch.regime == "tf32x3"
        else:
            assert launch.regime in ("shallow", "tile16", "tile8", "tile4")
        assert cin % launch.block_n == 0


def test_dx_entry_memory_beside_the_forward():
    """The dx entry stages y beside dy in ``shallow`` and keeps db sums:
    at a shape both take, its launch needs more shared memory than K1's;
    where the second box does not let two blocks share an SM (32^3, 16
    channels), it takes ``tile16``."""
    fwd = plan(torch.bfloat16, 64, 64, 64, 1, 8, 0, 16)
    dx = plan_dx(torch.bfloat16, 64, 64, 64, 1, 8, 16)
    assert (fwd.regime, dx.regime) == ("shallow", "shallow")
    assert dx.smem_bytes > fwd.smem_bytes
    assert plan(torch.bfloat16, 32, 32, 32, 1, 16, 0, 16).regime == "shallow"
    assert plan_dx(torch.bfloat16, 32, 32, 32, 1, 16, 16).regime == "tile16"


def _dx_inputs(seed, groups, cin, cout, dtype=torch.float64):
    """A forward conv's x and weight, a cotangent dy of its output, and
    the statistics' cotangents ds1, ds2."""
    rs = np.random.RandomState(seed)
    b, d, h, w = 2, 5, 6, 7
    x = torch.tensor(rs.randn(b, d, h, w, groups * cin), dtype=dtype)
    weight = torch.tensor(rs.randn(3, 3, 3, cin, groups * cout) * 0.1,
                          dtype=dtype)
    dy = torch.tensor(rs.randn(b, d, h, w, groups * cout), dtype=dtype)
    ds1, ds2 = torch.tensor(rs.randn(2, b, groups * cout), dtype=dtype)
    return x, weight, dy, ds1, ds2


@pytest.mark.parametrize("groups", [1, 2, 5])
@pytest.mark.parametrize("fold", list(FOLDS))
def test_dx_entry_plain_version_is_autograd(fold, groups):
    """On CPU tensors the entry runs its plain version: dx is the input
    gradient of K1's plain version (float64, 1e-10), the cotangent is
    the fold (the activation derivative from y, or the statistics'
    cotangents through y), and db its per-channel sum."""
    x, weight, dy, ds1, ds2 = _dx_inputs(3 + groups, groups, 8, 16)
    x.requires_grad_(True)
    act = fold if fold in ("leaky", "relu") else "none"
    stats = fold == "stats"
    res = conv3d_fused_reference(x, weight, None, groups, activation=act,
                                 emit_stats=stats)
    y, (s1, s2) = res if stats else (res, (None, None))
    total = (y * dy).sum()
    if stats:
        total = total + (s1 * ds1).sum() + (s2 * ds2).sum()
    want_dx, = torch.autograd.grad(total, x)
    kw = dict(ds1=ds1, ds2=ds2) if stats else {}
    dx, g, db = conv3d_fused_dx(dy, weight, groups, y=y.detach(), fold=fold,
                                cotangent=True, bias_grad=True, **kw)
    np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), atol=1e-10)
    want_g = fold_cotangent(dy, y.detach(), fold, ds1, ds2)
    assert torch.equal(g, want_g)
    np.testing.assert_allclose(db.numpy(), want_g.sum(dim=(0, 1, 2, 3)),
                               atol=1e-10)
    none = conv3d_fused_dx(dy, weight, groups, y=y.detach(), fold=fold, **kw)
    assert none[1] is None and none[2] is None
    assert torch.equal(none[0], dx)


def test_leaky_fold_matches_the_jax_vjp():
    """The leaky fold and dx on the flipped weight against jax.vjp of the
    JAX package's custom VJP (Pallas in interpret mode), float32, 1e-5:
    the same slope, applied to dy where the output is not positive."""
    from values_tpu.ops.pallas.conv3d import pack_ndhwc, unpack_ndhwc
    import jax
    groups, cin, cout, p, b = 2, 8, 8, 16, 2
    bp = 128 // p
    rs = np.random.RandomState(11)
    x = rs.randn(b, p, p, p, groups * cin).astype(np.float32)
    weight = (rs.randn(3, 3, 3, cin, groups * cout) * 0.1).astype(np.float32)
    dy = rs.randn(b, p, p, p, groups * cout).astype(np.float32)

    def pad(a):
        return np.concatenate([a, np.zeros((bp - b,) + a.shape[1:],
                                           a.dtype)])

    y, vjp = jax.vjp(lambda xp: conv3d_banded_packed_ad(
        xp, jnp.asarray(weight), jnp.zeros(groups * cout), groups,
        w_item=p, activation="leaky", interpret=True),
        pack_ndhwc(jnp.asarray(pad(x)), bp))
    want, = vjp(pack_ndhwc(jnp.asarray(pad(dy)), bp))
    want = np.asarray(unpack_ndhwc(want, bp))[:b]
    y_t = torch.tensor(np.asarray(unpack_ndhwc(y, bp))[:b])
    got, _, _ = conv3d_fused_dx(torch.tensor(dy), torch.tensor(weight),
                                groups, y=y_t, fold="leaky")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_dx_entry_refuses_what_it_does_not_take():
    x, weight, dy, _, _ = _dx_inputs(9, 1, 8, 8)
    with pytest.raises(ValueError, match="fold"):
        conv3d_fused_dx(dy, weight, 1, y=dy, fold="gelu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv3d_fused_dx(dy.to("meta"), weight.to("meta"), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cin,cout,regime", [
    (torch.float32, 16, 8, "tf32x3"), (torch.bfloat16, 16, 8, "tile4"),
    # float32 shapes that tf32x3 does not take (forward Cout 12): the
    # CUDA-core kernel's dx instance
    (torch.float32, 24, 12, "f32"), (torch.float32, 8, 12, "f32")])
def test_dx_entry_matches_plain_on_cuda(dtype, cin, cout, regime):
    """On the card: the dx entry against its plain version for each fold
    at G 1, 2, 5, one launch each in plan_dx's regime (forward cin ->
    cout on a 5x6x7 volume). dx: float32 atol 1e-4 max|dx| (3xTF32 and
    the CUDA cores keep float32's accuracy; summation orders), bfloat16
    2**-7 relative + 2e-3 max|dx| (K1's rule); the folded cotangent
    exactly (the same float32 operations, each rounded); db 1e-5 of
    sum|g| (float32 atomics in a varying order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    for groups in (1, 2, 5):
        x, weight, dy, ds1, ds2 = (t.float().cuda() for t in _dx_inputs(
            20 + groups, groups, cin, cout, torch.float32))
        x, weight, dy = x.to(dtype), weight.to(dtype), dy.to(dtype)
        assert plan_dx(dtype, *dy.shape[1:4], groups, cout,
                       cin).regime == regime
        for fold in FOLDS:
            act = fold if fold in ("leaky", "relu") else "none"
            y = conv3d_fused_reference(x, weight, None, groups,
                                       activation=act)
            kw = dict(y=y, fold=fold, cotangent=True, bias_grad=True)
            if fold == "stats":
                kw.update(ds1=ds1, ds2=ds2)
            before = (conv3d_fused_dx.launches,
                      dict(conv3d_fused.regime_launches))
            got = conv3d_fused_dx(dy, weight, groups, **kw)
            assert conv3d_fused_dx.launches == before[0] + 1
            assert conv3d_fused.regime_launches[regime] == \
                before[1][regime] + 1
            want = conv3d_fused_dx_reference(dy, weight, groups, **kw)
            torch.cuda.synchronize()
            dx, g, db = (t.float().cpu() for t in got)
            wdx, wg, wdb = (t.float().cpu() for t in want)
            scale = float(wdx.abs().max())
            if dtype == torch.float32:
                np.testing.assert_allclose(dx, wdx, atol=1e-4 * scale,
                                           rtol=0, err_msg=fold)
            else:
                np.testing.assert_allclose(dx, wdx, rtol=2 ** -7,
                                           atol=2e-3 * scale, err_msg=fold)
            assert torch.equal(g, wg), fold
            np.testing.assert_allclose(
                db, wdb, atol=1e-5 * float(wg.abs().sum(dim=(0, 1, 2, 3))
                                           .max()), rtol=0, err_msg=fold)


@pytest.mark.cuda
def test_tf32x3_matches_plain_on_cuda():
    """On the card: K1's tf32x3 regime against the plain version (TF32
    off) at atol 1e-4, the float32 limit, with x2, prologue, bias and
    leaky epilogue, and with statistics (1e-5 of sum|y|), at each tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(5)
    for dims, cin, cout in (((16, 16, 16), 8, 8), ((8, 8, 8), 32, 64),
                            ((4, 4, 4), 64, 128)):
        groups, b = 2, 2
        t = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                   device="cuda")
        x = t(rs.uniform(-1, 1, (b, *dims, groups * cin)))
        x2 = t(rs.uniform(-1, 1, (b, *dims, groups * cin)))
        weight = t(rs.uniform(-1, 1, (3, 3, 3, 2 * cin, groups * cout))
                   / np.sqrt(54 * cin))
        bias = t(rs.uniform(-0.1, 0.1, groups * cout))
        maps = (t(rs.uniform(0.5, 2, (b, groups * 2 * cin))),
                t(rs.uniform(-0.5, 0.5, (b, groups * 2 * cin))),
                t(rs.choice([1.0, 0.01, 0.0], (b, groups * 2 * cin))))
        assert plan(torch.float32, *dims, groups, cin, cin,
                    cout).regime == "tf32x3"
        for kw in (dict(activation="leaky"), dict(emit_stats=True)):
            before = conv3d_fused.regime_launches["tf32x3"]
            got = conv3d_fused(x, weight, bias, groups, x2=x2,
                               prologue=maps, **kw)
            assert conv3d_fused.regime_launches["tf32x3"] == before + 1
            want = conv3d_fused_reference(x, weight, bias, groups, x2=x2,
                                          prologue=maps, **kw)
            if "emit_stats" in kw:
                (got, gs), (want, ws) = got, want
                for a, w in zip(gs, ws):
                    np.testing.assert_allclose(
                        a.cpu(), w.cpu(), rtol=0,
                        atol=1e-5 * float(want.abs().sum(dim=(1, 2, 3)).max()
                                          if w is ws[0] else w.abs().max()))
            np.testing.assert_allclose(got.cpu(), want.cpu(), atol=1e-4,
                                       rtol=0)



@pytest.mark.parametrize("precision", ["32", "bf16"])
def test_smoke_counts_the_torch_ops_around_the_dx_entry(monkeypatch,
                                                        precision):
    """chip_smoke.py's check of a profiled training step on a 16^3 CPU
    step: with a dx entry that, like the kernel, runs no torch op, K1b's
    backward nodes show only the first conv's fold (which has no dx) over
    volumes; the plain path, which folds, flips and sums in torch at
    every conv, fails the check."""
    import chip_smoke
    from values_tpu_torch.config import compose
    from values_tpu_torch.ops.kernels import conv3d
    from values_tpu_torch.training.experiment import Experiment
    from values_tpu_torch.training.main import DEFAULT_CONFIG_DIR
    monkeypatch.setattr(chip_smoke, "PATCH", 16)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    overrides = ["data_input_dir=unused", "save_dir=unused", "batch_size=2",
                 "datamodule.patch_size=16", "model.initial_filter_size=8"]
    if precision == "bf16":
        overrides.append("+precision=bf16")
    cfg = compose(DEFAULT_CONFIG_DIR, "softmax_config", overrides)
    exp = Experiment(cfg, "cpu")
    state = exp.init_state(cfg.seed, 16)
    rs = np.random.RandomState(4)
    batch = {"data": torch.tensor(rs.randn(2, 16, 16, 16, 1),
                                  dtype=torch.float32),
             "seg": torch.tensor(rs.randint(0, 2, (2, 16, 16, 16)))}

    def step():
        exp.train_step(state, batch)

    with pytest.raises(AssertionError, match="outside the dx entry"):
        chip_smoke.k1b_backward_ops(step, precision == "bf16")

    def kernel_like(dy, weight, groups=1, *, y=None, fold="none", ds1=None,
                    ds2=None, cotangent=False, bias_grad=False):
        dx = dy.new_empty((*dy.shape[:4], groups * weight.shape[3]))
        return (dx, dy.new_empty(dy.shape) if cotangent else None,
                dy.new_zeros(dy.shape[-1], dtype=torch.float32)
                if bias_grad else None)

    monkeypatch.setattr(conv3d, "conv3d_fused_dx", kernel_like)
    fold = {"aten::add": 2, "aten::mul": 2, "aten::sum": 1}
    if precision == "bf16":
        fold["aten::_to_copy"] = 4
    assert chip_smoke.k1b_backward_ops(step, precision == "bf16") == fold
