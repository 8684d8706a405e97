"""2D training in the port (values_tpu_torch.training.experiment, the
HRNet's training mode, optim, torch_import) against the JAX package's
``Experiment`` step by step (never its ``fit``), on
tests/test_hrnet.py::small_cfg with 5 classes, flax-initialised weights
carried across, the same batches (a 255 region in every target) and, for
DROPOUT_FINAL, the JAX step's own keep masks (flax's ``nn.Dropout``
recorded, replayed through ``values_tpu_torch.models.hrnet.dropout_final``).

Size: 64x64 crops, batch 2. At 32x32 the deepest branch is 1x1, and its
BatchNorm over 2 values leaves the gradients of everything that feeds it
at float32 noise.

Precision: the parameters and BatchNorm statistics are held in float64 on
both sides (the JAX model built with float64 dtypes under ``enable_x64``,
and its experiment's float32 cast of the loss made a float64 one by a
stand-in ``jnp`` in that module): float32 runs of either package miss
float64's gradient of this small HRNet by ~1.5% in some leaves (its
narrow BatchNorm layers amplify rounding), so float32 steps cannot be
held to each other leaf by leaf. In float32 the first step's loss is
held (1e-5 relative), and a bf16 step's loss against the float32 one
(1e-2).

Limits (float64): loss 1e-5 relative; every parameter leaf within 1e-5
of its largest magnitude (the conv biases in front of a BatchNorm,
``last_layer_0/bias`` and the SSN's ``cov_factor_conv_0/bias``, have no
gradient in exact arithmetic, so both packages move them by rounding
noise: both stay below 1e-3);
every ``batch_stats`` leaf within 1e-6 of its largest magnitude, a limit
torch's own running update (the unbiased variance) misses
(``test_batch_stats_need_flax_update``).
"""
import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_hrnet import small_cfg
from test_torch_unet3d import flax_init
from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.config import make_config as jax_make_config
from values_tpu.models.hrnet import HighResolutionNet as JaxHRNet
from values_tpu.models import torch_import as JI
from values_tpu.training import optim as JO
from values_tpu.training.experiment import Experiment as JaxExperiment
from values_tpu_torch.config import make_config
from values_tpu_torch.models import hrnet as PH
from values_tpu_torch.models import torch_import as PI
from values_tpu_torch.training import optim as PO
from values_tpu_torch.training.experiment import Experiment

H = W = 64
B = 2
CLASSES = 5
# conv biases in front of a BatchNorm: no gradient in exact arithmetic,
# rounding noise in both packages (which RMSprop scales up to ~lr |g| /
# eps); held below 1e-3, not to each other
ZERO_GRAD = {("last_layer_0", "bias"), ("cov_factor_conv_0", "bias")}


def config(optimizer="sgd", precision="32", **cfg_kw):
    opt = ({"_target_": "torch.optim.SGD", "lr": 0.01, "momentum": 0.9,
            "weight_decay": 0.0005} if optimizer == "sgd" else
           {"_target_": "torch.optim.RMSprop", "lr": 0.01,
            "weight_decay": 0.0005})
    return {"exp_name": "gta-test", "seed": 1, "precision": precision,
            "learning_rate": 0.01, "weight_decay": 0.0005,
            "pretrain_epochs": 1, "n_aleatoric_samples": 2,
            "datamodule": {"ignore_index": 255, "num_classes": CLASSES},
            "model": {"_target_": "values_tpu.models.hrnet.get_seg_model",
                      "cfg": small_cfg(num_classes=CLASSES, **cfg_kw)},
            "optimizer": opt,
            "lr_scheduler": {"_target_":
                             "torch.optim.lr_scheduler.PolynomialLR",
                             "power": 0.9, "total_iters": 10}}


def batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        seg = rng.randint(0, CLASSES, (B, H, W))
        seg[:, :6] = 255
        out.append({"data": rng.rand(B, H, W, 3), "seg": seg})
    return out


def jax_variables(seed=0, **cfg_kw):
    model = JaxHRNet(cfg=small_cfg(num_classes=CLASSES, **cfg_kw))
    return flax_init(model, seed, jnp.zeros((1, H, W, 3)))


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` meaning float64: installed as the JAX
    experiment module's ``jnp`` so that its losses, which it casts to
    float32, reduce in float64 in the float64 runs."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _float64_losses():
    import values_tpu.training.experiment as module
    orig, module.jnp = module.jnp, _Float64Numpy()
    try:
        yield
    finally:
        module.jnp = orig


def mask_recorder(exp):
    """A jitted function of (params, model_state, batch, rng, pretrain)
    that runs the JAX step's loss with flax's ``nn.Dropout`` recording its
    keep masks (drawn as flax draws them) and returns them, as NCHW
    torch booleans: the masks the train step draws from the same key."""
    import flax.linen as nn

    def run(params, model_state, batch, rng, pretrain):
        orig, masks = nn.Dropout.__call__, []

        def call(module, inputs, deterministic=None, rng=None):
            if nn.merge_param("deterministic", module.deterministic,
                              deterministic):
                return inputs
            keep = 1.0 - module.rate
            mask = jax.random.bernoulli(module.make_rng("dropout"), keep,
                                        inputs.shape)
            masks.append(mask)
            return jax.lax.select(mask, inputs / keep,
                                  jnp.zeros_like(inputs))
        nn.Dropout.__call__ = call
        try:
            exp._loss(params, model_state, batch, rng, pretrain)
        finally:
            nn.Dropout.__call__ = orig
        return masks

    jitted = jax.jit(run, static_argnums=(4,))
    return lambda *args: [torch.from_numpy(np.array(m)).permute(0, 3, 1, 2)
                          for m in jitted(*args)]


def jax_steps(cfg, variables, data, pretrain=(), record_masks=False,
              normals=None, **cfg_kw):
    """The JAX Experiment's train steps in float64; the learning rate set
    before each from the polynomial schedule, as its ``fit`` does. Returns
    the losses, the variables after each step, the recorded keep masks
    and the SSN normals each step drew."""
    masks, draws = [], []
    with jax.enable_x64(), _float64_losses():
        exp = JaxExperiment(jax_make_config(cfg))
        exp.model = JaxHRNet(cfg=small_cfg(num_classes=CLASSES, **cfg_kw),
                             dtype=jnp.float64, param_dtype=jnp.float64)
        state = exp.state_from_variables(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), variables))
        step = jax.jit(exp.train_step_fn, static_argnums=(3,))
        record = mask_recorder(exp) if record_masks else None
        losses, snaps = [], []
        for i, batch in enumerate(data):
            pre = i in pretrain
            state = state._replace(opt_state=JO.set_learning_rate(
                state.opt_state, exp.lr_schedule.value(i)))
            rng = jax.random.PRNGKey(100 + i)
            jb = {"data": jnp.asarray(batch["data"]),
                  "seg": jnp.asarray(batch["seg"])}
            if record is not None:
                masks.extend(record(state.params, state.model_state, jb,
                                    rng, pre))
            if normals is not None:
                draws.append(normals(rng, exp))
            state, loss = step(state, jb, rng, pre)
            losses.append(float(loss))
            snaps.append(numpy_tree({"params": state.params,
                                     **state.model_state}))
    return losses, snaps, masks, draws


def port_steps(cfg, variables, data, pretrain=(), dtype=torch.float64):
    exp = Experiment(make_config(cfg), "cpu")
    state = exp.state_from_variables(variables)
    state.params.to(dtype)
    losses, snaps = [], []
    generator = torch.Generator().manual_seed(0)
    for i, batch in enumerate(data):
        PO.set_learning_rate(state.optimizer, exp.lr_schedule.value(i))
        tb = {"data": torch.tensor(batch["data"], dtype=dtype),
              "seg": torch.tensor(batch["seg"])}
        state, loss = exp.train_step(state, tb, generator, i in pretrain)
        losses.append(float(loss))
        snaps.append(exp.variables(state))
    return losses, snaps, exp, state


def worst(got, want, collection):
    """The largest leaf error of a collection over the leaf's largest
    magnitude, and the leaf."""
    out = (0.0, None)
    for module, leaves in want[collection].items():
        for leaf, w in leaves.items():
            g = np.asarray(got[collection][module][leaf], np.float64)
            if (module, leaf) in ZERO_GRAD:
                assert max(np.abs(g).max(), np.abs(w).max()) < 1e-3
                continue
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-300)
            out = max(out, (float(err), f"{module}/{leaf}"))
    return out


def check_steps(got, want, losses_got, losses_want):
    for g, w in zip(losses_got, losses_want):
        assert g == pytest.approx(w, rel=1e-5)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["batch_stats", "params"]
        err, leaf = worst(g, w, "params")
        assert err < 1e-5, leaf
        err, leaf = worst(g, w, "batch_stats")
        assert err < 1e-6, leaf


@pytest.fixture(scope="module")
def softmax_run():
    v0 = jax_variables()
    data = batches(3)
    return v0, data, jax_steps(config(), v0, data)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_softmax_steps_match_jax(softmax_run, n_steps):
    """SGD (momentum 0.9, weight decay) under the polynomial rate, CE
    with ignore_index 255: losses, parameters and running statistics
    after one and after three steps."""
    v0, data, (losses, snaps, _, _) = softmax_run
    got_losses, got, _, _ = port_steps(config(), v0, data[:n_steps])
    check_steps(got, snaps[:n_steps], got_losses, losses[:n_steps])


def test_first_float32_step_loss_matches_jax(softmax_run):
    v0, data, (losses, _, _, _) = softmax_run
    got, _, _, _ = port_steps(config(), v0, data[:1], dtype=torch.float32)
    assert got[0] == pytest.approx(losses[0], rel=1e-5)


def test_batch_stats_need_flax_update(softmax_run, monkeypatch):
    """Torch's own running update (the unbiased batch variance) misses the
    batch_stats limit by orders of magnitude: the limit tests flax's."""
    v0, data, (_, snaps, _, _) = softmax_run
    _, got, _, _ = port_steps(config(), v0, data[:1])
    assert worst(got[0], snaps[0], "batch_stats")[0] < 1e-6
    monkeypatch.setattr(PH.BatchNorm2d, "forward",
                        torch.nn.BatchNorm2d.forward)
    _, got, _, _ = port_steps(config(), v0, data[:1])
    assert worst(got[0], snaps[0], "batch_stats")[0] > 1e-3


def test_dropout_final_steps_match_jax(monkeypatch):
    """DROPOUT_FINAL in training: the JAX step's four keep masks a step,
    replayed; two steps."""
    v0 = jax_variables(dropout_final=True)
    data = batches(2, seed=1)
    losses, snaps, masks, _ = jax_steps(config(dropout_final=True), v0,
                                        data, record_masks=True,
                                        dropout_final=True)
    assert len(masks) == 8
    queue = collections.deque(masks)

    def replayed(t, generator):
        keep = queue.popleft()
        assert keep.shape == t.shape
        return torch.where(keep, t / 0.5, torch.zeros_like(t))

    monkeypatch.setattr(PH, "dropout_final", replayed)
    got_losses, got, _, _ = port_steps(config(dropout_final=True), v0,
                                       data)
    assert not queue
    check_steps(got, snaps, got_losses, losses)


def test_bf16_step_loss_near_float32(softmax_run):
    """precision=bf16: autocast to bfloat16, float32 weights, statistics
    and loss; the first loss within 1e-2 of float32's, weights still
    float32 after the step."""
    v0, data, _ = softmax_run
    f32, _, _, _ = port_steps(config(), v0, data[:1], dtype=torch.float32)
    bf16, _, exp, state = port_steps(config(precision="bf16"), v0,
                                     data[:1], dtype=torch.float32)
    assert exp.mixed_bf16
    assert bf16[0] == pytest.approx(f32[0], rel=1e-2)
    assert all(p.dtype == torch.float32 for p in state.params.parameters())
    assert state.params.bn1.running_var.dtype == torch.float32


def test_val_step_runs_on_the_running_statistics(softmax_run):
    """val_step: eval mode on the running statistics (the logits of a
    plain eval-mode module given the same variables), CE with 255 and the
    micro Dice; the module goes back to training mode."""
    from values_tpu_torch.ops import losses as PL
    from values_tpu_torch.ops import metrics as PM
    v0, data, (_, snaps, _, _) = softmax_run
    exp = Experiment(make_config(config()), "cpu")
    state = exp.state_from_variables(snaps[0])
    batch = {"data": torch.tensor(data[1]["data"], dtype=torch.float32),
             "seg": torch.tensor(data[1]["seg"])}
    got = exp.val_step(state.params, batch)
    assert state.params.training
    plain = PH.get_seg_model(small_cfg(num_classes=CLASSES))
    plain.load_state_dict(PI.strip_model_prefix(PI.hrnet_params_to_torch(
        snaps[0], small_cfg(num_classes=CLASSES))))
    with torch.no_grad():
        logits = plain.float()(batch["data"].permute(0, 3, 1, 2))
    target = batch["seg"].long()
    assert float(got["val_loss"]) == pytest.approx(float(
        PL.dice_ce_loss(logits, target, ignore_index=255)), rel=1e-6)
    assert float(got["val_dice"]) == pytest.approx(float(
        PM.dice_score(logits, target, ignore_index=255)), abs=1e-7)


def test_init_state_2d_has_the_flax_tree(softmax_run):
    """The port's initialisation gives the flax init's tree: the same
    modules, leaves and shapes, running statistics 0 and 1; the variables
    round-trip through the two converters."""
    want = softmax_run[0]
    exp = Experiment(make_config(config()), "cpu")
    got = exp.variables(exp.init_state_2d(1, H, W, 3))
    for collection in ("params", "batch_stats"):
        assert sorted(got[collection]) == sorted(want[collection])
        for module, leaves in want[collection].items():
            for leaf, arr in leaves.items():
                assert got[collection][module][leaf].shape == arr.shape
    assert all(np.all(s["var"] == 1) and np.all(s["mean"] == 0)
               for s in got["batch_stats"].values())
    back = PI.hrnet_params_from_torch(PI.hrnet_params_to_torch(
        want, small_cfg(num_classes=CLASSES)))
    for collection in ("params", "batch_stats"):
        for module, leaves in want[collection].items():
            for leaf, arr in leaves.items():
                np.testing.assert_array_equal(back[collection][module][leaf],
                                              arr)


def test_pretrained_weights_merge_as_jax(tmp_path):
    """MODEL.PRETRAINED naming a torch .pth: matching leaves are taken,
    a leaf of another shape and a module the model lacks are skipped, as
    the JAX package's merge does; ``true`` is a no-op."""
    cfg = config()
    exp = Experiment(make_config(cfg), "cpu")
    init = exp.variables(exp.init_state_2d(1, H, W, 3))
    model = PH.HighResolutionNet(small_cfg(num_classes=CLASSES))
    state = {k: torch.full_like(v, 0.5) for k, v in
             model.state_dict().items()}
    state["last_layer.3.weight"] = torch.zeros(7, 60, 1, 1)  # other shape
    state["extra.0.weight"] = torch.zeros(4, 4, 1, 1)
    torch.save({"state_dict": state}, tmp_path / "w.pth")
    pretrained = PI.hrnet_params_from_torch(state)
    want = JI.merge_pretrained_hrnet(init, pretrained)
    got = PI.merge_pretrained_hrnet(init, pretrained)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), got,
        want))
    cfg["MODEL"] = {"PRETRAINED": str(tmp_path / "w.pth")}
    merged = Experiment(make_config(cfg), "cpu")
    variables = merged.variables(merged.init_state_2d(1, H, W, 3))
    assert np.all(variables["params"]["conv1"]["kernel"] == 0.5)
    np.testing.assert_array_equal(variables["params"]["last_layer_3"][
        "kernel"], init["params"]["last_layer_3"]["kernel"])
    cfg["MODEL"] = {"PRETRAINED": True}
    plain = Experiment(make_config(cfg), "cpu")
    np.testing.assert_array_equal(
        plain.variables(plain.init_state_2d(1, H, W, 3))["params"]["conv1"][
            "kernel"], init["params"]["conv1"]["kernel"])


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"momentum": 0.9, "weight_decay": 5e-4}),
    ("sgd", {"momentum": 0.9, "weight_decay": 5e-4, "nesterov": True}),
    ("rmsprop", {"weight_decay": 5e-4}),
    ("adam", {"weight_decay": 1e-6})])
def test_optimizers_step_as_optax(name, kw):
    """torch's SGD (momentum, Nesterov), RMSprop and Adam take the JAX
    module's optax steps, with the rate changed between steps."""
    import optax
    rng = np.random.RandomState(5)
    params = {"a": rng.randn(4, 3), "b": rng.randn(5)}
    grads = [{k: rng.randn(*v.shape) for k, v in params.items()}
             for _ in range(4)]
    rates = [0.01, 0.008, 0.005, 0.002]
    with jax.enable_x64():
        tx = getattr(JO, name)(lr=rates[0], **kw)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        opt_state = tx.init(jp)
        for g, lr in zip(grads, rates):
            opt_state = JO.set_learning_rate(opt_state, lr)
            upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                                              g),
                                       opt_state, jp)
            jp = optax.apply_updates(jp, upd)
        want = numpy_tree(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = getattr(PO, name)(lr=rates[0], **kw)(list(tp.values()))
    for g, lr in zip(grads, rates):
        PO.set_learning_rate(opt, lr)
        for k, t in tp.items():
            t.grad = torch.tensor(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), want[k],
                                   rtol=1e-12, atol=1e-12)
