"""The port's MC-dropout path against the JAX package's, given the same
keep masks: the grouped dropout forward (K1's unfused form) against
``grouped_forward_packed(do_dropout=True, interpret=True)``, the
dropout scorer against ``make_packed_dropout_scorer``, the plain UNet3D
against the flax UNet3D in float64; and the port's own draws checked
statistically.

The JAX side's masks are replayed, not monkeypatched: its scorer draws
pass j's 17 masks as ``bernoulli(split(fold_in(rng, j), 17)[k], 0.5,
packed_shape_k)`` (``ensemble_unet3d_pallas.py:172-175``, :498-503;
``scoring.py:405-408``). The test records the packed shapes once, draws
the same bits, unpacks them to NDHWC (``bp = B_padded // nb``) and hands
them to the port through its one draw function,
``values_tpu_torch.models.ensemble_unet3d.draw_dropout_masks``."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
import values_tpu.models.ensemble_unet3d_pallas as jpallas
from values_tpu.inference import scoring as jscoring
from values_tpu.models.ensemble_unet3d import group_member_variables
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.ops.pallas.conv3d import pack_ndhwc, unpack_ndhwc
from values_tpu_torch.inference.scoring import make_dropout_scorer
from values_tpu_torch.models import ensemble_unet3d as E
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_from_torch,
                                                  unet3d_params_to_torch)
from values_tpu_torch.models.unet3d import UNet3D

M, P, B, BP, AGG, N_PRED, RATERS = 2, 16, 4, 8, 4, 2, 3


def _replay(key, packed_shapes, b=B):
    """The 17 NDHWC keep masks (numpy bool, the first ``b`` items) that
    the JAX forward draws from ``key``."""
    masks = []
    for k, shape in zip(jax.random.split(key, 17), packed_shapes):
        keep = jax.random.bernoulli(k, 0.5, shape)
        masks.append(np.asarray(unpack_ndhwc(keep, BP // shape[0]))[:b])
    return masks


class _Masks:
    """A stand-in for ``draw_dropout_masks``: pass i's masks, in call
    order, checked against the shapes the port asks for."""

    def __init__(self, passes):
        self.passes, self.calls = passes, 0

    def __call__(self, shapes, generator, device):
        masks = self.passes[self.calls]
        self.calls += 1
        assert [tuple(s) for s in shapes] == [m.shape for m in masks]
        return [torch.from_numpy(m.copy()).to(device) for m in masks]


@pytest.fixture(scope="module")
def case():
    """Members, inputs, the packed shapes of the 17 sites, and the JAX
    forward's and scorer's outputs, computed once (float32, interpret
    mode; VALUES_TPU_AGG_LINEAR=0 set before the scorer is traced, fault
    R1)."""
    model = JaxUNet3D(num_classes=2, initial_filter_size=8)
    variables = [flax_init(model, 30 + m, jnp.zeros((1, P, P, P, 1)))
                 for m in range(M)]
    grouped = jax.tree_util.tree_map(jnp.asarray,
                                     group_member_variables(variables))
    rs = np.random.RandomState(0)
    vols = rs.rand(B, P, P, P, 1).astype(np.float32)
    gt = (rs.rand(B, RATERS, P, P, P) > 0.7).astype(np.int32)
    padded = np.concatenate([vols, np.zeros_like(vols)])
    shapes = []
    orig = jpallas._dropout

    def recording(x, rng, rate=0.5):
        shapes.append(tuple(x.shape))
        return orig(x, rng, rate)

    key = jax.random.PRNGKey(11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpallas, "_dropout", recording)
        out = jax.jit(lambda g, x, k: jpallas.grouped_forward_packed(
            g, x, M, P, do_dropout=True, rng=k, interpret=True))(
                grouped, pack_ndhwc(jnp.asarray(padded), BP), key)
    assert len(shapes) == 17
    nb, d, h, m, c, lanes = out.shape
    logits = np.asarray(unpack_ndhwc(out.reshape(nb, d, h, m * c, lanes),
                                     BP)).reshape(BP, P, P, P, m, c)[:B]
    rng = jax.random.PRNGKey(5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")
        score, _ = jscoring.make_packed_dropout_scorer(
            M, P, n_pred=N_PRED, agg_patch=AGG, dtype=jnp.float32,
            interpret=True)
        scores = np.asarray(jax.jit(score)(
            group_member_variables(variables), jnp.asarray(vols),
            jnp.asarray(gt), rng))
    weights = group_member_state_dicts(
        [unet3d_params_to_torch(v) for v in variables])
    return dict(weights=weights, vols=vols, gt=gt, shapes=shapes,
                forward=(key, logits), scorer=(rng, scores))


def test_dropout_forward_matches_packed_forward(case, monkeypatch):
    """float32, atol 1e-4 (as the fused forward's test): the same 17
    masks, the norms from each conv's statistics, other summation
    orders."""
    key, want = case["forward"]
    monkeypatch.setattr(E, "draw_dropout_masks",
                        _Masks([_replay(key, case["shapes"])]))
    got = E.dropout_forward(case["weights"], torch.from_numpy(case["vols"]),
                            M, None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_dropout_scorer_matches_packed_dropout_scorer(case, monkeypatch):
    """Pass j replays ``fold_in(rng, j)``'s masks; atol = rtol = 5e-3, as
    the other scorer tests."""
    rng, want = case["scorer"]
    masks = _Masks([_replay(jax.random.fold_in(rng, j), case["shapes"])
                    for j in range(N_PRED)])
    monkeypatch.setattr(E, "draw_dropout_masks", masks)
    score, _ = make_dropout_scorer(M, P, n_pred=N_PRED, agg_patch=AGG,
                                   dtype=torch.float32, device="cpu")
    got = score(case["weights"], torch.from_numpy(case["vols"]),
                torch.from_numpy(case["gt"]), 0)
    assert masks.calls == N_PRED and got.shape == (10, B)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


def test_plain_unet3d_dropout_matches_flax_f64(monkeypatch):
    """The plain module's 17 sites, given the masks, against the flax
    UNet3D with ``nn.Dropout`` fed the same masks in call order: float64
    at atol 1e-10."""
    rs = np.random.RandomState(2)
    x = rs.rand(2, P, P, P, 1)
    net = UNet3D(2, initial_filter_size=4, do_dropout=True).double()
    shapes = E.dropout_site_shapes(
        group_member_state_dicts([net.state_dict()], torch.float64),
        x.shape)
    masks = [rs.rand(*s) > 0.5 for s in shapes]
    calls = iter(masks)

    def dropout(self, inputs, deterministic=None, rng=None):
        return jnp.where(next(calls), inputs / 0.5, 0.0)

    monkeypatch.setattr(fnn.Dropout, "__call__", dropout)
    variables = unet3d_params_from_torch(net.state_dict(), np.float64)
    with jax.enable_x64(True):
        model = JaxUNet3D(num_classes=2, initial_filter_size=4,
                          do_dropout=True, dtype=jnp.float64,
                          param_dtype=jnp.float64)
        want = np.asarray(jax.jit(lambda v, xx: model.apply(
            v, xx, deterministic=False))(variables, jnp.asarray(x)))
    got = net(torch.from_numpy(x),
              keep_masks=[torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-10,
                               rtol=0)


def _keep_rate_ok(masks) -> bool:
    n = sum(m.numel() for m in masks)
    rate = sum(int(m.sum()) for m in masks) / n
    return abs(rate - 0.5) < 4 * (0.25 / n) ** 0.5


def test_masks_keep_half_each_member_on_its_own(case):
    """The port's own draws: the keep rate is 0.5 within 4 sigma over
    all 17 sites, and so is the rate at which the two members' masks
    agree (independent members)."""
    shapes = E.dropout_site_shapes(case["weights"], (B, P, P, P, 1))
    masks = E.draw_dropout_masks(shapes, torch.Generator().manual_seed(0),
                                 "cpu")
    assert [tuple(m.shape) for m in masks] == shapes and len(shapes) == 17
    assert _keep_rate_ok(masks)
    agree = [(m[..., :m.shape[-1] // M] == m[..., m.shape[-1] // M:])
             for m in masks]
    assert _keep_rate_ok(agree)


def test_same_seed_same_scores_and_passes_differ(case, monkeypatch):
    """The same seed gives the same scores, another seed others; the two
    passes of one call draw different masks (they agree at a rate of 0.5
    within 4 sigma)."""
    drawn = []
    orig = E.draw_dropout_masks

    def recording(shapes, generator, device):
        drawn.append(orig(shapes, generator, device))
        return drawn[-1]

    monkeypatch.setattr(E, "draw_dropout_masks", recording)
    score, _ = make_dropout_scorer(M, P, n_pred=N_PRED, agg_patch=AGG,
                                   dtype=torch.float32, device="cpu")
    args = (case["weights"], torch.from_numpy(case["vols"][:2]),
            torch.from_numpy(case["gt"][:2]))
    first = score(*args, 7)
    assert len(drawn) == N_PRED
    assert _keep_rate_ok([a == b for a, b in zip(*drawn)])
    assert torch.equal(score(*args, 7), first)
    assert not torch.equal(score(*args, 8), first)
    assert bool(torch.isfinite(first).all())


def test_dropout_scorer_refuses_an_aleatoric_tree(case):
    score, _ = make_dropout_scorer(M, P, n_pred=2, agg_patch=AGG,
                                   device="cpu")
    ale = {k: v for k, v in case["weights"].items() if k != "final"}
    ale["final_aleatoric"] = case["weights"]["final"]
    with pytest.raises(ValueError, match="make_aleatoric_scorer"):
        score(ale, torch.from_numpy(case["vols"][:1]),
              torch.from_numpy(case["gt"][:1]), 0)


def test_engine_mc_dropout_matches_jax_engine(monkeypatch):
    """The engine's default mode on a dropout model with ``n_pred`` 2, one
    member: the JAX engine's grouped lowering tiles the member to G = 2
    and draws both passes' masks in flax's ``nn.Dropout``
    (``values_tpu/models/ensemble_unet3d.py:105-109``, :149-150), here fed
    numpy masks in call order (one window chunk, so one trace); the port
    runs its two passes at G = 1, pass j given group j's channels of the
    same masks. Softmax sums, counts and data sums, float64 at 1e-10."""
    from values_tpu.inference.engine import SlidingWindowEngine as JaxEngine
    from values_tpu_torch.inference.engine import SlidingWindowEngine
    variables = [flax_init(JaxUNet3D(num_classes=2, initial_filter_size=2),
                           1, jnp.zeros((1, P, P, P, 1)))]
    rs = np.random.RandomState(6)
    vol = rs.rand(16, 32, 16)
    drawn = []

    def dropout(self, inputs, deterministic=None, rng=None):
        drawn.append(rs.rand(*inputs.shape) > 0.5)
        return jnp.where(drawn[-1], inputs / 0.5, 0.0)

    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__", dropout)
            want = JaxEngine(
                JaxUNet3D(num_classes=2, initial_filter_size=2,
                          do_dropout=True), variables, n_pred=2,
                patch_size=P, dtype=jnp.float64,
                use_grouped_ensemble=True).run_volume(vol)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert len(drawn) == 17
    passes = [[m[..., j * (m.shape[-1] // 2):(j + 1) * (m.shape[-1] // 2)]
               for m in drawn] for j in range(2)]
    masks = _Masks(passes)
    monkeypatch.setattr(E, "draw_dropout_masks", masks)
    engine = SlidingWindowEngine(UNet3D(2, initial_filter_size=2,
                                        do_dropout=True), variables,
                                 n_pred=2, patch_size=P,
                                 dtype=torch.float64, device="cpu")
    assert engine.total_samples == 2
    got = engine.run_volume(vol)
    assert masks.calls == 2
    for name, g, w in zip(("softmax", "counts", "data"), got, want):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-10, rtol=0,
                                   err_msg=name)
