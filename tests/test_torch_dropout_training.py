"""The port's MC-dropout training (values_tpu_torch.training with a
``do_dropout`` UNet3D) against the JAX package's, at 16^3 patches on the
CPU: the loss and every parameter gradient at float64 against jax.grad
of the flax model, three steps and a validation step against
``Experiment(train_backend="xla")``, the joint ``EnsembleTrainer`` at
M = 2 against the JAX ``EnsembleTrainer`` (the Pallas pipeline in
interpret mode), the order of a step's draws, and the training CLI on
``dropout_config`` (the checkpoint read by the JAX package and scored by
the port's score CLI with MC dropout).

The masks are replayed, as in tests/test_torch_dropout.py: the flax model
gets numpy masks through a patched ``flax.linen.Dropout.__call__`` (in
call order, which is the port's site order), and the JAX trainer's
packed masks, ``bernoulli(split(drop_key, 17)[k], 0.5, packed_shape_k)``
with ``drop_key = split(step_key)[1]`` (``values_tpu/training/
ensemble.py:178-181``), are drawn again, unpacked and handed to the port
through its one draw function, ``draw_dropout_masks``."""
import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
import values_tpu.models.ensemble_unet3d_pallas as jpallas
from values_tpu.config import make_config as jax_make_config
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.ops import losses as JL
from values_tpu.ops.pallas.conv3d import unpack_ndhwc
from values_tpu.training.checkpoint import load_checkpoint as jax_load
from values_tpu.training.ensemble import EnsembleTrainer as JaxTrainer
from values_tpu.training.ensemble import EnsembleTrainState
from values_tpu.training.experiment import Experiment as JaxExperiment
from values_tpu_torch.config import make_config
from values_tpu_torch.inference.score import run_score, score_cli
from values_tpu_torch.inference.scoring import score_rows
from values_tpu_torch.models import ensemble_unet3d as E
from values_tpu_torch.models.ensemble_unet3d import (single_member_tree,
                                                     train_forward)
from values_tpu_torch.ops import losses as L
from values_tpu_torch.training.ensemble import EnsembleTrainer
from values_tpu_torch.training.experiment import (Experiment, tree_leaves,
                                                  tree_map)
from values_tpu_torch.training.main import main

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_score_cli import _toy_data  # noqa: E402

P, B, F, M, BP = 16, 2, 4, 2, 8
MODEL = {"_target_": "values_tpu.models.unet3d.UNet3D", "num_classes": 2,
         "initial_filter_size": F, "do_dropout": True}


def _cfg(**extra):
    model = dict(MODEL, **extra.pop("model", {}))
    return {"model": model, "datamodule": {"ignore_index": 0},
            "learning_rate": 3e-4, "weight_decay": 1e-5, "seed": 7,
            **extra}


def _batch(seed, members=None):
    rs = np.random.RandomState(seed)
    lead = (members, B) if members else (B,)
    return (rs.randn(*lead, P, P, P, 1).astype(np.float32),
            (rs.rand(*lead, P, P, P) > 0.6).astype(np.int32))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _site_masks(params, seed):
    """The 17 NDHWC keep masks (numpy bool) of one step of a B-batch."""
    weights = {k: {leaf: torch.from_numpy(np.asarray(v))
                   for leaf, v in leaves.items()}
               for k, leaves in single_member_tree(params).items()}
    rs = np.random.RandomState(seed)
    return [rs.rand(*s) > 0.5
            for s in E.dropout_site_shapes(weights, (B, P, P, P, 1))]


class _Masks:
    """A stand-in for ``draw_dropout_masks``: call i gets ``masks[i]``,
    checked against the shapes the port asks for."""

    def __init__(self, masks):
        self.masks, self.calls = masks, 0

    def __call__(self, shapes, generator, device):
        masks = self.masks[self.calls]
        self.calls += 1
        assert [tuple(s) for s in shapes] == [m.shape for m in masks]
        return [torch.from_numpy(np.ascontiguousarray(m)).to(device)
                for m in masks]


def _feed_flax(monkeypatch):
    """Patch flax's Dropout to apply the masks put in the list it returns,
    in call order (and to pass its input through where it is
    deterministic); a jitted function takes them when it is traced."""
    feed = []

    def dropout(self, inputs, deterministic=None, rng=None):
        if deterministic:
            return inputs
        return jnp.where(feed.pop(0), inputs / 0.5, 0.0)

    monkeypatch.setattr(fnn.Dropout, "__call__", dropout)
    return feed


@pytest.fixture(scope="module")
def params():
    """The port's initial tree of the dropout UNet3D (torch's init)."""
    return tree_map(lambda t: t.detach().numpy(),
                    Experiment(make_config(_cfg()), "cpu")
                    .init_state(3, P).params)


def test_loss_and_gradients_match_flax_float64(params, monkeypatch):
    """Dice+CE through the 17 masked sites and its gradient on every leaf
    against jax.grad of the flax UNet3D given the same masks, float64:
    the loss at rtol 1e-12, each leaf at rtol 1e-8 and atol 1e-10 of the
    largest gradient (the biases of convs feeding an instance norm have a
    true gradient of 0)."""
    x, seg = _batch(2)
    masks = _site_masks(params, 0)
    feed = _feed_flax(monkeypatch)
    feed.extend(masks)
    with jax.enable_x64(True):
        model = JaxUNet3D(num_classes=2, initial_filter_size=F,
                          do_dropout=True, dtype=jnp.float64,
                          param_dtype=jnp.float64)
        xj, tj = jnp.asarray(x, jnp.float64), jnp.asarray(seg)

        def jax_loss(p):
            out = model.apply({"params": p}, xj, deterministic=False)
            return JL.dice_ce_loss(jnp.moveaxis(out, -1, 1), tj)

        want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   params))
    assert not feed
    tp = tree_map(lambda a: torch.tensor(a, dtype=torch.float64)
                  .requires_grad_(True), params)
    out = train_forward(tp, torch.tensor(x, dtype=torch.float64),
                        keep_masks=[torch.from_numpy(m) for m in masks])
    loss = L.dice_ce_loss(out.movedim(-1, 1), torch.tensor(seg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-12)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(_leaves(tree_map(lambda t: t.grad.numpy(), tp)))
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-8,
                                   atol=1e-10 * scale, err_msg=name)


def _close_trees(got, want, rtol):
    """Every leaf within ``rtol`` of its norm, the biases of the convs
    feeding an instance norm aside (their true gradient is 0, so Adam
    turns either side's roundoff into lr-sized steps)."""
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name.startswith("contr_") and name.endswith("bias"):
            continue
        err = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
        assert err <= rtol, (name, err)


def test_steps_match_jax_experiment(params, monkeypatch):
    """Three steps from the same init on the same batches and masks (the
    JAX step jitted with its masks as arguments, so each step's forward
    reads its own masks),
    f32: losses at rtol 2e-4, every leaf after 3 steps within 1e-4 of its
    norm; then the deterministic val_step (no dropout on either side):
    loss at rtol 2e-4, Dice at 1e-6."""
    steps = [_site_masks(params, 10 + i) for i in range(3)]
    feed = _feed_flax(monkeypatch)
    monkeypatch.setattr(E, "draw_dropout_masks", _Masks(steps))
    port = Experiment(make_config(_cfg()), "cpu")
    state = port.state_from_variables({"params": params})
    jexp = JaxExperiment(jax_make_config(_cfg(train_backend="xla")))
    jstate = jexp.state_from_variables(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)})

    @jax.jit
    def jax_step(jstate, batch, key, masks):
        feed.extend(masks)
        return jexp.train_step_fn(jstate, batch, key)

    got, want = [], []
    for step in range(3):
        x, seg = _batch(10 + step)
        state, loss = port.train_step(
            state, {"data": torch.tensor(x), "seg": torch.tensor(seg)},
            torch.Generator().manual_seed(step))
        jstate, jloss = jax_step(
            jstate, {"data": jnp.asarray(x), "seg": jnp.asarray(seg)},
            jax.random.PRNGKey(step), steps[step])
        got.append(float(loss))
        want.append(float(jloss))
    assert not feed
    np.testing.assert_allclose(got, want, rtol=2e-4)
    _close_trees(dict(_leaves(tree_map(lambda t: t.detach().numpy(),
                                       state.params))),
                 dict(_leaves(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))), 1e-4)
    x, seg = _batch(20)
    val = port.val_step(state.params, {"data": torch.tensor(x),
                                       "seg": torch.tensor(seg)})
    jval = jexp.val_step(jstate.params, None,
                         {"data": jnp.asarray(x), "seg": jnp.asarray(seg)},
                         jax.random.PRNGKey(9))
    np.testing.assert_allclose(float(val["val_loss"]),
                               float(jval["val_loss"]), rtol=2e-4)
    assert float(val["val_dice"]) == pytest.approx(float(jval["val_dice"]),
                                                   abs=1e-6)


@pytest.fixture(scope="module")
def jax_joint():
    """Two steps of the JAX EnsembleTrainer (M = 2, dropout, interpret
    mode) from the port trainer's initial grouped tree: the per-member
    losses, the final grouped tree, and each step's 17 masks over the
    grouped channels, replayed from the step keys on the packed shapes
    recorded in its trace."""
    cfg = _cfg()
    trainer = EnsembleTrainer(make_config(cfg), M, "cpu")
    init = tree_map(lambda t: t.detach().numpy(),
                    trainer.init_state(cfg["seed"], P).params)
    jtr = JaxTrainer(jax_make_config(cfg), M)
    gparams = jax.tree_util.tree_map(jnp.asarray, init)
    state = EnsembleTrainState(gparams, jtr.optimizer.init(gparams),
                               jnp.zeros((), jnp.int32))
    shapes, orig = [], jpallas._dropout

    def recording(x, rng, rate=0.5):
        shapes.append(tuple(x.shape))
        return orig(x, rng, rate)

    losses, masks = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpallas, "_dropout", recording)
        for step in range(2):
            x, seg = _batch(30 + step, M)
            key = jax.random.PRNGKey(40 + step)
            state, loss = jtr.train_step(
                state, {"data": jnp.asarray(x), "seg": jnp.asarray(seg)},
                key)
            losses.append(np.asarray(loss))
            drop_key = jax.random.split(key)[1]
            masks.append([
                np.asarray(unpack_ndhwc(jax.random.bernoulli(k, 0.5, s),
                                        BP // s[0]))[:B]
                for k, s in zip(jax.random.split(drop_key, 17),
                                shapes[:17])])
    return init, losses, jax.tree_util.tree_map(np.asarray,
                                                state.params), masks


def test_joint_dropout_steps_match_jax_trainer(jax_joint, monkeypatch):
    """Two joint M = 2 steps against the JAX EnsembleTrainer given the
    same masks (member m drawing its channel group's share), f32: the
    per-member losses at rtol 2e-4, every parameter after 2 steps within
    atol 5e-4 (tests/test_torch_ensemble_training.py's bound against
    independent Experiments), the biases of convs feeding an instance
    norm aside."""
    init, want_losses, want_params, masks = jax_joint
    member_masks = [[m[..., k * (m.shape[-1] // M):(k + 1)
                       * (m.shape[-1] // M)] for m in step]
                    for step in masks for k in range(M)]
    stand_in = _Masks(member_masks)
    monkeypatch.setattr(E, "draw_dropout_masks", stand_in)
    trainer = EnsembleTrainer(make_config(_cfg()), M, "cpu")
    state = trainer.init_state(7, P)
    assert all(np.array_equal(t.detach().numpy(), w) for t, w in
               zip(tree_leaves(state.params), tree_leaves(init)))
    for step in range(2):
        x, seg = _batch(30 + step, M)
        state, losses = trainer.train_step(
            state, {"data": torch.tensor(x), "seg": torch.tensor(seg)})
        np.testing.assert_allclose(losses.numpy(), want_losses[step],
                                   rtol=2e-4)
    assert stand_in.calls == 2 * M
    got = dict(_leaves(tree_map(lambda t: t.detach().numpy(),
                                state.params)))
    for name, w in _leaves(want_params):
        if name.startswith("contr_") and name.endswith("bias"):
            continue
        np.testing.assert_allclose(got[name], w, atol=5e-4, rtol=0,
                                   err_msg=name)


def test_joint_step_is_member_experiment_steps():
    """Member m of a joint step draws from ``generators[m]`` what an
    Experiment step draws from the same generator: its keep masks, then
    the aleatoric normals. So the joint per-member losses and gradients
    are those of M Experiments given same-seeded generators (f32, rtol
    1e-5; atol 1e-5 of the largest gradient)."""
    cfg = make_config(_cfg(aleatoric_loss=True, n_aleatoric_samples=2))
    trainer = EnsembleTrainer(cfg, M, "cpu")
    state = trainer.init_state(7, P)
    x, seg = _batch(5, M)
    losses = trainer.loss(state.params, {"data": torch.tensor(x),
                                         "seg": torch.tensor(seg)},
                          [torch.Generator().manual_seed(m)
                           for m in range(M)])
    grads = torch.autograd.grad(losses.sum(), tree_leaves(state.params))
    grouped = {}
    for (name, _), g in zip(_leaves(state.params), grads):
        module, leaf = name.split("/")
        grouped.setdefault(module, {})[leaf] = g.numpy()
    split = E.ungroup_member_variables(grouped, M)
    for m, variables in enumerate(trainer.member_variables(state)):
        exp = Experiment(cfg, "cpu")
        est = exp.state_from_variables(variables)
        loss = exp.loss(est.params, {"data": torch.tensor(x[m]),
                                     "seg": torch.tensor(seg[m])},
                        torch.Generator().manual_seed(m))
        want = dict(zip((n for n, _ in _leaves(est.params)),
                        torch.autograd.grad(loss, tree_leaves(est.params))))
        np.testing.assert_allclose(losses[m].item(), loss.item(), rtol=1e-5)
        scale = max(float(w.abs().max()) for w in want.values())
        for name, g in _leaves(split[m]["params"]):
            np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)


def test_step_draws_masks_then_normals():
    """A dropout step with the aleatoric objective draws its 17 keep
    masks from the step's generator first, then the normals: the loss
    equals the one computed from those draws made by hand."""
    cfg = make_config(_cfg(aleatoric_loss=True, n_aleatoric_samples=2))
    exp = Experiment(cfg, "cpu")
    state = exp.init_state(3, P)
    x, seg = (torch.tensor(a) for a in _batch(6))
    got = exp.loss(state.params, {"data": x, "seg": seg},
                   torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    masks = E.draw_dropout_masks(E.dropout_site_shapes(
        single_member_tree(state.params), tuple(x.shape)), gen, "cpu")
    mu, s = train_forward(state.params, x, keep_masks=masks)
    eps = torch.randn((2, B, 2, P, P, P), generator=gen)
    want = L.aleatoric_sampling_loss(mu.movedim(-1, 1), s.movedim(-1, 1),
                                     seg.long(), eps=eps)
    assert got.item() == want.item()


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("PortDropoutToy")
    _toy_data(root)
    return root


@pytest.mark.parametrize("precision", ["32", "bf16"])
def test_cli_trains_and_serves(toy, tmp_path, precision):
    """The training CLI on dropout_config (tiny), f32 and bf16: the native
    checkpoint holds the flax tree of UNet3D(do_dropout=True).init (every
    leaf float32 and finite) with the model target in its hparams, read
    by the JAX loader as it is; the port's score CLI scores it with MC
    dropout (``--n_pred 2``), every row finite."""
    ckpt = main(["--device", "cpu", "--config-name", "dropout_config",
                 f"data_input_dir={toy}", f"save_dir={tmp_path / 'exp'}",
                 "max_epochs=1", "batch_size=2", "datamodule.patch_size=16",
                 "datamodule.batch_size=2", "datamodule.data_num_folds=3",
                 "model.initial_filter_size=2", "version=0",
                 f"+precision={precision}"])
    payload = jax_load(ckpt)
    assert payload["hyper_parameters"]["model"]["do_dropout"] is True
    init = jax.eval_shape(JaxUNet3D(num_classes=2, initial_filter_size=2,
                                    do_dropout=True).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, P, P, P, 1)))
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shapes(payload["state_dict"]) == shapes(init)
    for name, leaf in _leaves(payload["state_dict"]["params"]):
        assert leaf.dtype == np.float32 and np.isfinite(leaf).all(), name
    scores = run_score(score_cli([
        "--checkpoint_paths", ckpt, "-i", str(toy), "--test_split", "val",
        "--dtype", "float32", "--n_pred", "2", "--out",
        str(tmp_path / "s.json"), "--device", "cpu"]))
    assert len(scores) == 2
    for row in scores.values():
        assert list(row) == score_rows()
        assert np.isfinite(list(row.values())).all()
