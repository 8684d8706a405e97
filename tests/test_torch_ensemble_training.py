"""The port's joint deep-ensemble training (values_tpu_torch.training.
ensemble.EnsembleTrainer) and its checkpoints, at 16^3 patches and initial
filter size 2, on the CPU: the grouping against the JAX package's numpy
functions, the joint step against the port's own Experiment (which
tests/test_torch_training.py holds against the JAX package), and the
checkpoints read back by both packages. No test here steps the JAX
EnsembleTrainer: it runs the Pallas pipeline in interpret mode on the
CPU, far too slow for these tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from values_tpu.models.ensemble_unet3d import \
    group_member_variables as jax_group
from values_tpu.models.ensemble_unet3d import \
    ungroup_member_variables as jax_ungroup
from values_tpu.models.torch_import import \
    export_reference_checkpoint as jax_export
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.ops.losses import dice_ce_loss as jax_dice_ce_loss
from values_tpu.models.torch_import import \
    load_reference_checkpoint as jax_load_reference
from values_tpu.training.checkpoint import \
    load_any_checkpoint as jax_load_any_checkpoint
from values_tpu_torch.config import make_config
from values_tpu_torch.models.ensemble_unet3d import (
    group_member_variables, ungroup_member_variables)
from values_tpu_torch.models.torch_import import (
    export_reference_checkpoint, load_reference_checkpoint,
    unet3d_params_to_torch)
from values_tpu_torch.training.checkpoint import load_checkpoint
from values_tpu_torch.training.ensemble import EnsembleTrainer
from values_tpu_torch.training.experiment import (Experiment, tree_leaves,
                                                  tree_map)

P, B, F, M = 16, 2, 2, 2
NOT_PORTED = "The MC-dropout, TTA and SSN scorers"


def _cfg(**extra):
    model = {"_target_": "values_tpu.models.unet3d.UNet3D",
             "num_classes": 2, "initial_filter_size": F}
    model.update(extra.pop("model", {}))
    return make_config({"model": model, "datamodule": {"ignore_index": 0},
                        "learning_rate": 3e-4, "weight_decay": 1e-5,
                        "seed": 7, **extra})


def _flat(tree, prefix=""):
    """{"module/leaf": array} of a (possibly ``params``-wrapped) tree."""
    tree = tree.get("params", tree)
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.fixture(scope="module")
def members():
    """Three flax-layout member trees of the port's torch init, plain and
    with the aleatoric head."""
    return {aleatoric: [{"params": Experiment(
        _cfg(aleatoric_loss=aleatoric), "cpu").initial_params(seed)}
        for seed in (1, 2, 3)] for aleatoric in (False, True)}


@pytest.mark.parametrize("aleatoric", [False, True])
def test_grouping_matches_jax(members, aleatoric):
    """group_member_variables and ungroup_member_variables give exactly
    the JAX package's trees, the conv level of the contr_*/expand_*
    blocks and the member axis of the transposed convs included, and the
    round trip is exact."""
    trees = members[aleatoric]
    grouped = group_member_variables(trees)
    _assert_trees_equal(grouped, jax_group(trees))
    assert grouped["params"]["center_up"]["kernel"].shape[0] == 3
    split = ungroup_member_variables(grouped, 3)
    want = jax_ungroup(jax_group(trees), 3)
    for got_m, want_m, tree in zip(split, want, trees):
        _assert_trees_equal(got_m, want_m)
        _assert_trees_equal(got_m, tree)
        assert set(got_m["params"]["contr_1_1"]) == {"conv"}


def _stream(seed):
    """One joint batch: member m's own (B, P, P, P, 1) volumes and labels
    in row m."""
    rs = np.random.RandomState(seed)
    return (rs.randn(M, B, P, P, P, 1).astype(np.float32),
            (rs.rand(M, B, P, P, P) > 0.6).astype(np.int64))


@pytest.mark.parametrize("aleatoric", [False, True])
def test_three_joint_steps_match_independent_experiments(aleatoric):
    """Three joint M = 2 steps against two port Experiments on the same
    initial weights, batches and generators, f32: per-member losses at
    rtol 2e-4; every parameter after 3 steps within atol 5e-4, the
    contr_* biases aside (they feed instance norms, so their true
    gradient is 0 and Adam turns roundoff into lr-sized steps), as
    tests/test_ensemble_training.py holds the JAX trainer."""
    cfg = _cfg(aleatoric_loss=aleatoric, n_aleatoric_samples=3)
    trainer = EnsembleTrainer(cfg, M, "cpu")
    state = trainer.init_state(cfg.seed, P)
    # K1 takes its weights contiguous
    assert all(t.is_contiguous() for t in tree_leaves(state.params))
    exps = [Experiment(cfg, "cpu") for _ in range(M)]
    states = [e.init_state(cfg.seed + m, P) for m, e in enumerate(exps)]
    gens = [torch.Generator().manual_seed(100 + m) for m in range(M)]
    exp_gens = [torch.Generator().manual_seed(100 + m) for m in range(M)]
    for step in range(3):
        x, seg = _stream(10 + step)
        state, losses = trainer.train_step(
            state, {"data": torch.tensor(x), "seg": torch.tensor(seg)}, gens)
        want = [float(e.train_step(s, {"data": torch.tensor(x[m]),
                                       "seg": torch.tensor(seg[m])},
                                   exp_gens[m])[1])
                for m, (e, s) in enumerate(zip(exps, states))]
        np.testing.assert_allclose(losses.numpy(), want, rtol=2e-4)
    assert state.step == 3
    for m, variables in enumerate(trainer.member_variables(state)):
        got = _flat(variables)
        want = _flat(tree_map(lambda t: t.detach().numpy(),
                              states[m].params))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            if key.startswith("contr_") and key.endswith("bias"):
                continue
            np.testing.assert_allclose(got[key], w, atol=5e-4, rtol=0,
                                       err_msg=key)


def test_first_joint_losses_match_jax():
    """The joint M = 2 step's per-member Dice+CE losses at the initial
    weights against the JAX package's flax UNet3D and dice_ce_loss on
    each member's own batch and ungrouped weights, f32: rtol 2e-4, as
    the joint steps are held against the port's Experiments."""
    trainer = EnsembleTrainer(_cfg(), M, "cpu")
    state = trainer.init_state(7, P)
    x, seg = _stream(10)
    with torch.no_grad():
        got = trainer.loss(state.params, {"data": torch.tensor(x),
                                          "seg": torch.tensor(seg)})
    model = JaxUNet3D(num_classes=2, initial_filter_size=F)
    want = [float(jax_dice_ce_loss(
        jnp.moveaxis(model.apply(variables, jnp.asarray(x[m])), -1, 1),
        jnp.asarray(seg[m])))
        for m, variables in enumerate(trainer.member_variables(state))]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4)


def test_bf16_joint_step_is_finite_and_keeps_f32_masters():
    """precision=bf16: the forward and backward in bfloat16, the update
    on the float32 leaves."""
    trainer = EnsembleTrainer(_cfg(precision="bf16"), M, "cpu")
    state = trainer.init_state(7, P)
    x, seg = _stream(3)
    state, losses = trainer.train_step(
        state, {"data": torch.tensor(x), "seg": torch.tensor(seg)})
    assert losses.shape == (M,) and bool(torch.isfinite(losses).all())
    assert all(t.dtype == torch.float32 for leaves in state.params.values()
               for t in leaves.values())


def test_member_checkpoints_read_by_jax(tmp_path):
    """save_member_checkpoints writes member_{m}.ckpt, which the JAX
    package's load_any_checkpoint reads into the trees its own ungrouping
    gives; hparams carry ensemble_member m."""
    cfg = _cfg()
    trainer = EnsembleTrainer(cfg, M, "cpu")
    state = trainer.init_state(cfg.seed, P)
    x, seg = _stream(4)
    trainer.train_step(state, {"data": torch.tensor(x),
                               "seg": torch.tensor(seg)})
    paths = trainer.save_member_checkpoints(state, str(tmp_path), epoch=2)
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["member_0.ckpt",
                                                     "member_1.ckpt"]
    grouped = tree_map(lambda t: t.detach().numpy(), state.params)
    for m, (path, want) in enumerate(zip(paths, jax_ungroup(grouped, M))):
        hparams, variables = jax_load_any_checkpoint(path)
        assert hparams["ensemble_member"] == m
        assert hparams["model"] == cfg.to_container()["model"]
        _assert_trees_equal(variables, want)
        payload = load_checkpoint(path)
        assert (payload["epoch"], payload["global_step"]) == (2, 1)


def test_export_reference_checkpoint_read_by_both(members, tmp_path):
    """A reference .ckpt written by the port reads back through both
    packages' load_reference_checkpoint: the port's state_dict exactly
    that of unet3d_params_to_torch, the JAX package's flax tree exactly
    the member's (its unused heads aside); and the JAX export reads back
    in the port."""
    tree = members[False][0]
    hparams = {"model": {"_target_": "values_tpu.models.unet3d.UNet3D"},
               "seed": 5}
    path = str(tmp_path / "port.ckpt")
    export_reference_checkpoint(path, tree, hparams)
    got_hp, state = load_reference_checkpoint(path)
    assert got_hp == hparams
    want = unet3d_params_to_torch(tree)
    assert sorted(state) == sorted(want)
    for key in want:
        assert torch.equal(state[key], want[key]), key
    jax_hp, variables = jax_load_reference(path)
    assert jax_hp == hparams
    flat = _flat(variables)
    for key, w in _flat(tree).items():
        np.testing.assert_array_equal(flat[key], w, err_msg=key)
    jax_path = str(tmp_path / "jax.ckpt")
    jax_export(jax_path, tree, hparams)
    _, jax_state = load_reference_checkpoint(jax_path)
    for key in want:
        assert torch.equal(jax_state[key], want[key]), key


def test_init_state_starts_member_m_from_seed_plus_m():
    cfg = _cfg()
    trainer = EnsembleTrainer(cfg, M, "cpu")
    state = trainer.init_state(11, P)
    for m, variables in enumerate(trainer.member_variables(state)):
        _assert_trees_equal(variables, {"params": Experiment(
            cfg, "cpu").initial_params(11 + m)})


@pytest.mark.parametrize("case", ["members", "ssn", "hrnet", "clip",
                                  "dropout", "patch"])
def test_refusals(case):
    """As the JAX trainer: members < 1, a model outside the UNet3D
    family and gradient_clip_val raise ValueError; a dropout model raises
    NotImplementedError naming its ROADMAP item; a patch that four 2x
    pools do not divide raises ValueError."""
    if case == "dropout":
        with pytest.raises(NotImplementedError, match=NOT_PORTED):
            EnsembleTrainer(_cfg(model={"do_dropout": True}), M, "cpu")
        return
    if case == "patch":
        with pytest.raises(ValueError, match="multiple of 16"):
            EnsembleTrainer(_cfg(), M, "cpu").init_state(0, 24)
        return
    cfg, members = {
        "members": (_cfg(), 0),
        "ssn": (_cfg(model={
            "_target_": "values_tpu.models.ssn_unet3d.SsnUNet3D"}), M),
        "hrnet": (_cfg(model={
            "_target_": "values_tpu.models.hrnet.get_seg_model"}), M),
        "clip": (_cfg(gradient_clip_val=1.0), M),
    }[case]
    with pytest.raises(ValueError):
        EnsembleTrainer(cfg, members, "cpu")


def test_orbax_refusal_points_to_the_jax_package(tmp_path):
    """Orbax stays unsupported for good; the message names the JAX
    package's conversion and promises no port."""
    orbax = tmp_path / "orbax.ckpt"
    orbax.mkdir()
    (orbax / "values_tpu_meta.pkl").write_bytes(b"")
    with pytest.raises(NotImplementedError,
                       match="values_tpu.training.checkpoint") as err:
        load_checkpoint(str(orbax))
    assert "Joint ensemble" not in str(err.value)
