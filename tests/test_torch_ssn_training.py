"""The port's SSN training (values_tpu_torch.training with an SsnUNet3D)
against the JAX package's, at 16^3 patches on the CPU: the Monte-Carlo
log-likelihood loss, the loss and every parameter gradient at float64
against jax.grad of the flax model, a pretraining step (the factor head
moved by Adam's weight decay alone) and three mixed steps against
``Experiment(train_backend="xla")``, the validation step, and the training
CLI (pretraining switched off at ``pretrain_epochs``, the checkpoint read
by the JAX package and scored by the port's score CLI).

The JAX side's normals are replayed through the port's one draw
function, ``values_tpu_torch.models.ssn_unet3d.draw_ssn_normals``:
``LowRankMVN.rsample`` draws ``normal(k1, (n, B, R))`` and ``normal(k2,
(n, B, C*V))`` with ``k1, k2 = split(key)``, the step's key itself on the
XLA backend (``values_tpu/training/experiment.py:257-265``)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.config import make_config as jax_make_config
from values_tpu.models.ssn_unet3d import SsnUNet3D as JaxSsnUNet3D
from values_tpu.ops import losses as JL
from values_tpu.training.checkpoint import load_checkpoint as jax_load
from values_tpu.training.experiment import Experiment as JaxExperiment
from values_tpu_torch.config import make_config
from values_tpu_torch.inference.score import run_score, score_cli
from values_tpu_torch.inference.scoring import score_rows
from values_tpu_torch.models import ssn_unet3d as S
from values_tpu_torch.models.ensemble_unet3d import ssn_train_forward
from values_tpu_torch.ops import losses as L
from values_tpu_torch.training import experiment as X
from values_tpu_torch.training.experiment import Experiment, tree_map
from values_tpu_torch.training.main import main

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_score_cli import _toy_data  # noqa: E402

P, B, F, RANK, C, N = 16, 2, 4, 3, 2, 3
MODEL = {"_target_": "values_tpu.models.ssn_unet3d.SsnUNet3D",
         "num_classes": C, "initial_filter_size": F, "rank": RANK}


def _cfg(**extra):
    return {"model": dict(MODEL), "datamodule": {"ignore_index": 0},
            "learning_rate": 3e-4, "weight_decay": 1e-5, "seed": 7,
            "n_aleatoric_samples": N, "pretrain_epochs": 1, **extra}


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, P, P, P, 1).astype(np.float32),
            (rs.rand(B, P, P, P) > 0.6).astype(np.int32))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _normals(key, dtype=jnp.float32):
    """What ``LowRankMVN.rsample(key, (N,))`` draws for a batch of B."""
    k1, k2 = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.normal(
                k1, (N, B, RANK), dtype))),
            torch.from_numpy(np.array(jax.random.normal(
                k2, (N, B, C * P ** 3), dtype))))


class _Normals:
    """A stand-in for ``draw_ssn_normals``: call i gets ``draws[i]``."""

    def __init__(self, draws):
        self.draws, self.calls = draws, 0

    def __call__(self, generator, n, batch, rank, dim, dtype, device):
        eps_r, eps_d = self.draws[self.calls]
        self.calls += 1
        assert eps_r.shape == (n, batch, rank) and eps_d.shape == (n, batch,
                                                                   dim)
        return eps_r.to(dtype), eps_d.to(dtype)


@pytest.fixture(scope="module")
def params():
    """The port's initial SSN tree (torch's init) as numpy: the flax
    tree of SsnUNet3D.init, without the unused ``final`` head."""
    return tree_map(lambda t: t.detach().numpy(),
                    Experiment(make_config(_cfg()), "cpu")
                    .init_state(3, P).params)


@pytest.mark.parametrize("ignore_index", [0, 255])
def test_ssn_loss_matches_jax(ignore_index):
    """Both branches (CE without ignore_index at 0, with it otherwise),
    float32, rtol 1e-6."""
    rs = np.random.RandomState(1)
    samples = rs.randn(4, 2, 3, 5, 6, 7).astype(np.float32)
    target = rs.randint(0, 3, (2, 5, 6, 7))
    if ignore_index:
        target = np.where(rs.rand(*target.shape) < 0.2, 255, target)
    got = L.ssn_mc_loglikelihood_loss(torch.tensor(samples),
                                      torch.tensor(target), ignore_index)
    want = JL.ssn_mc_loglikelihood_loss(jnp.asarray(samples),
                                        jnp.asarray(target), ignore_index)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("pretrain", [True, False],
                         ids=["pretrain", "sample"])
def test_loss_and_gradients_match_flax_float64(params, monkeypatch,
                                               pretrain):
    """The SSN objective and its gradient on every leaf against jax.grad
    of the flax SsnUNet3D (``mean_only`` while pretraining) given the same
    normals, float64: the loss at rtol 1e-10, each leaf at rtol 1e-8 and
    atol 1e-10 of the largest gradient (the biases of convs feeding an
    instance norm have a true gradient of 0); the factor head's gradient
    is 0 while pretraining on both sides."""
    x, seg = _batch(2)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        model = JaxSsnUNet3D(num_classes=C, initial_filter_size=F,
                             rank=RANK, dtype=jnp.float64,
                             param_dtype=jnp.float64)
        xj, tj = jnp.asarray(x, jnp.float64), jnp.asarray(seg)

        def jax_loss(p):
            dist = model.apply({"params": p}, xj, mean_only=pretrain)
            samples = dist.rsample(key, (N,)).reshape(
                (N, B, C) + (P,) * 3)
            return JL.ssn_mc_loglikelihood_loss(samples, tj)

        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    params)
        want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(jp)
        normals = _normals(key, jnp.float64)
    monkeypatch.setattr(S, "draw_ssn_normals", _Normals([normals]))
    tp = tree_map(lambda a: torch.tensor(a, dtype=torch.float64)
                  .requires_grad_(True), params)
    dist = ssn_train_forward(tp, torch.tensor(x, dtype=torch.float64), C,
                             RANK, mean_only=pretrain)
    samples = dist.rsample(None, N).reshape((N, B, C) + (P,) * 3)
    loss = L.ssn_mc_loglikelihood_loss(samples, torch.tensor(seg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-10)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, want)))
    got = {name: (t.grad.numpy() if t.grad is not None
                  else np.zeros(t.shape))
           for name, t in _leaves(tp)}
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-8,
                                   atol=1e-10 * scale, err_msg=name)
    if pretrain:
        assert not np.abs(want["cov_factor_conv/kernel"]).any()
        assert tp["cov_factor_conv"]["kernel"].grad is None


@pytest.fixture(scope="module")
def jax_run(params):
    """The JAX Experiment's (XLA backend) four steps, pretrain flags
    (True, True, False, False), from the port's initial tree, with the
    parameters after the first and the last step; and its val_step on
    the final parameters."""
    jexp = JaxExperiment(jax_make_config(_cfg(train_backend="xla")))
    state = jexp.state_from_variables(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)})
    losses, after = [], []
    for step, pretrain in enumerate(PRETRAIN):
        x, seg = _batch(10 + step)
        state, loss = jexp.train_step(
            state, {"data": jnp.asarray(x), "seg": jnp.asarray(seg)},
            jax.random.PRNGKey(step), pretrain)
        losses.append(float(loss))
        if step in (0, len(PRETRAIN) - 1):
            after.append(dict(_leaves(jax.tree_util.tree_map(
                np.asarray, state.params))))
    x, seg = _batch(20)
    val = jexp.val_step(state.params, None, {"data": jnp.asarray(x),
                                             "seg": jnp.asarray(seg)},
                        jax.random.PRNGKey(9))
    return losses, after, {k: float(v) for k, v in val.items()}


PRETRAIN = (True, True, False, False)


def _close_trees(got, want, what, rtol):
    """Every leaf within ``rtol`` of its norm, the biases of the convs
    feeding an instance norm aside (their true gradient is 0, so Adam
    turns either side's roundoff into lr-sized steps)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name.startswith("contr_") and name.endswith("bias"):
            continue
        err = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
        assert err <= rtol, (what, name, err)


def test_steps_match_jax_experiment(params, jax_run, monkeypatch):
    """A pretraining step, then three more (one pretraining, two
    sampling), f32, the same batches and normals: losses at rtol 2e-4;
    after the first step every leaf, the factor head included (moved by
    Adam on a zero gradient plus weight decay, as optax moves it, and
    not left where it was) within 1e-4 of its norm, and after the last
    step within 1e-3: the SSN loss sums ~8e3 voxels' log-likelihoods, so
    the two convolutions' float32 roundoff moves its gradient's small
    components, which Adam's normalized steps (lr 3e-4) carry over at
    full size. Then the val_step: loss at rtol 2e-4, the mean Dice over
    the samples' argmax at 1e-6."""
    want_losses, want_after, want_val = jax_run
    draws = [_normals(jax.random.PRNGKey(step))
             for step in range(len(PRETRAIN))]
    draws.append(_normals(jax.random.PRNGKey(9)))
    normals = _Normals(draws)
    monkeypatch.setattr(S, "draw_ssn_normals", normals)
    exp = Experiment(make_config(_cfg()), "cpu")
    state = exp.state_from_variables({"params": params})
    losses = []
    for step, pretrain in enumerate(PRETRAIN):
        x, seg = _batch(10 + step)
        state, loss = exp.train_step(
            state, {"data": torch.tensor(x), "seg": torch.tensor(seg)},
            None, pretrain)
        losses.append(float(loss))
        got = dict(_leaves(tree_map(lambda t: t.detach().numpy(),
                                    state.params)))
        if step == 0:
            moved = np.abs(got["cov_factor_conv/kernel"]
                           - params["cov_factor_conv"]["kernel"]).max()
            assert 0.5 * 3e-4 < moved <= 1.01 * 3e-4, moved
            _close_trees(got, want_after[0], "after the pretraining step",
                         1e-4)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    _close_trees(got, want_after[1], "after four steps", 1e-3)
    x, seg = _batch(20)
    val = exp.val_step(state.params, {"data": torch.tensor(x),
                                      "seg": torch.tensor(seg)})
    assert normals.calls == len(draws)
    np.testing.assert_allclose(float(val["val_loss"]), want_val["val_loss"],
                               rtol=2e-4)
    assert float(val["val_dice"]) == pytest.approx(want_val["val_dice"],
                                                   abs=1e-6)


def test_bf16_step_keeps_f32_heads_and_masters():
    """precision=bf16: the trunk in bfloat16, the heads and the
    distribution in float32 (on the bf16-rounded head weights), the
    update on float32 leaves; the loss finite."""
    exp = Experiment(make_config(_cfg(precision="bf16")), "cpu")
    state = exp.init_state(3, P)
    p, data = exp._cast(state.params, torch.tensor(_batch(0)[0]))
    dist = exp.forward(p, data)
    assert dist.mean.dtype == torch.float32
    assert dist.cov_factor.dtype == torch.float32
    x, seg = _batch(1)
    state, loss = exp.train_step(state, {"data": torch.tensor(x),
                                         "seg": torch.tensor(seg)},
                                 torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(loss))
    assert all(t.dtype == torch.float32 for _, t in _leaves(state.params))


def test_degenerate_member_gets_a_zero_factor_and_gradient():
    """rsample replaces a degenerate member's factor (a non-finite one
    included) by zeros, so its samples stay finite and the factor's
    gradient there is 0, as ``jnp.where`` gives; the other member's
    factor gets its gradient."""
    rs = np.random.RandomState(0)
    mean = torch.tensor(rs.randn(2, 6), requires_grad=True)
    diag = torch.ones(2, 6, dtype=torch.float64)
    factor = torch.tensor(rs.randn(2, 6, 2), requires_grad=True)
    with torch.no_grad():
        factor[0, 0, 0] = float("inf")
    dist = S.LowRankMVN(mean, diag, factor)
    assert dist.degenerate().tolist() == [True, False]
    samples = dist.rsample(torch.Generator().manual_seed(1), 3)
    assert bool(torch.isfinite(samples).all())
    samples.sum().backward()
    assert not factor.grad[0].any() and factor.grad[1].abs().sum() > 0


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("PortSsnToy")
    _toy_data(root)
    return root


def test_cli_pretrains_then_samples_and_serves(toy, tmp_path, monkeypatch):
    """The training CLI on ssn_config (tiny): the first pretrain_epochs
    epochs step with ``pretrain`` and the rest without; the native
    checkpoint holds SsnUNet3D.init's flax tree and hparams with the
    model target, pretrain_epochs and n_aleatoric_samples, which the JAX
    loader reads as it is; the port's score CLI scores it with finite
    rows."""
    flags = []
    real = X.Experiment.train_step

    def recording(self, state, batch, generator=None, pretrain=False):
        flags.append(pretrain)
        return real(self, state, batch, generator, pretrain)

    monkeypatch.setattr(X.Experiment, "train_step", recording)
    ckpt = main(["--device", "cpu", "--config-name", "ssn_config",
                 f"data_input_dir={toy}", f"save_dir={tmp_path / 'exp'}",
                 "max_epochs=3", "pretrain_epochs=2", "batch_size=2",
                 "datamodule.patch_size=16", "datamodule.batch_size=2",
                 "datamodule.data_num_folds=3",
                 "model.initial_filter_size=2", "model.rank=2",
                 "n_aleatoric_samples=2", "version=0"])
    assert flags == [True] * 4 + [False] * 2
    payload = jax_load(ckpt)
    hparams = payload["hyper_parameters"]
    assert hparams["model"]["_target_"] == MODEL["_target_"]
    assert (hparams["pretrain_epochs"], hparams["n_aleatoric_samples"]) == (
        2, 2)
    init = jax.eval_shape(JaxSsnUNet3D(num_classes=2, initial_filter_size=2,
                                       rank=2).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, P, P, P, 1)))
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shapes(payload["state_dict"]) == shapes(init)
    scores = run_score(score_cli([
        "--checkpoint_paths", ckpt, "-i", str(toy), "--test_split", "val",
        "--dtype", "float32", "--out", str(tmp_path / "s.json"),
        "--device", "cpu"]))
    assert len(scores) == 2
    for row in scores.values():
        assert list(row) == score_rows()
        assert np.isfinite(list(row.values())).all()
