"""The port's 3D training path (values_tpu_torch.training) against the JAX
package's: the training forward and its gradients, three Experiment steps
against Experiment(train_backend="packed"), the losses, the loader, the
config composition, the training CLI end to end, and the refusals."""
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.config import compose as jax_compose
from values_tpu.config import make_config as jax_make_config
from values_tpu.data.pipeline import NumpyBatchLoader as JaxLoader
from values_tpu.data.samples import (get_train_data_samples,
                                     get_val_test_data_samples)
from values_tpu.inference.score import run_score as jax_run_score
from values_tpu.inference.score import score_cli as jax_score_cli
from values_tpu.models.ensemble_unet3d_pallas import packed_train_forward
from values_tpu.models.unet3d import UNet3D as JaxUNet3D
from values_tpu.ops import losses as JL
from values_tpu.ops import metrics as JM
from values_tpu.training import optim as jax_optim
from values_tpu.training.checkpoint import load_checkpoint as jax_load
from values_tpu.training.experiment import Experiment as JaxExperiment
from values_tpu_torch.config import compose, make_config
from values_tpu_torch.config.instantiate import locate
from values_tpu_torch.data.pipeline import NumpyBatchLoader
from values_tpu_torch.data.preprocess3d import kfold_indices
from values_tpu_torch.inference.score import run_score, score_cli
from values_tpu_torch.inference.scoring import score_rows
from values_tpu_torch.models.ensemble_unet3d import train_forward
from values_tpu_torch.ops import losses as L
from values_tpu_torch.ops import metrics as M
from values_tpu_torch.training import optim
from values_tpu_torch.training.checkpoint import (TORCH_OPTIMIZER_KEY,
                                                  CheckpointRetention)
from values_tpu_torch.training.experiment import (Experiment, tree_leaves,
                                                  tree_map)
from values_tpu_torch.training.loops import fit
from values_tpu_torch.training.main import main
from values_tpu_torch.training.tb_logging import TensorBoardLogger

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_score_cli import _toy_data  # noqa: E402

P, B, F = 16, 2, 8
MODEL = {"_target_": "values_tpu.models.unet3d.UNet3D", "num_classes": 2,
         "initial_filter_size": F}


def _cfg(**extra):
    return {"model": dict(MODEL), "datamodule": {"ignore_index": 0},
            "learning_rate": 3e-4, "weight_decay": 1e-5, "seed": 7,
            **extra}


def _init_params(aleatoric=False, seed=3):
    """The port's initial flax-layout tree (torch's init) as numpy."""
    exp = Experiment(make_config(_cfg(aleatoric_loss=aleatoric)), "cpu")
    state = exp.init_state(seed, P)
    return tree_map(lambda t: t.detach().numpy(), state.params)


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, P, P, P, 1).astype(np.float32),
            (rs.rand(B, P, P, P) > 0.6).astype(np.int32))


def _torch_tree(params, dtype=torch.float32):
    return tree_map(lambda a: torch.tensor(a, dtype=dtype), params)


@pytest.mark.parametrize("aleatoric", [False, True])
def test_train_forward_matches_packed_train_forward(aleatoric):
    """f32 against the JAX training forward (Pallas in interpret mode):
    atol 2e-5, the bound of tests/test_packed_training.py between the
    packed forward and flax's."""
    params = _init_params(aleatoric)
    x, _ = _batch(0)
    want = jax.jit(lambda p, xx: packed_train_forward(p, xx, interpret=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    got = train_forward(_torch_tree(params), torch.tensor(x))
    if not aleatoric:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def flax64():
    """``flax64(aleatoric)``: the initial tree and batch 2, and the flax
    UNet3D's float64 outputs, objective (Dice+CE, or the aleatoric one on
    the JAX draw of its normals) and gradients there, from one jitted
    program a head, run once for the forward and the gradient test."""
    runs = {}

    def run(aleatoric):
        if aleatoric not in runs:
            runs[aleatoric] = _flax64(aleatoric)
        return runs[aleatoric]
    return run


def _flax64(aleatoric):
    params = _init_params(aleatoric)
    x, seg = _batch(2)
    rng = jax.random.PRNGKey(5)
    cf = lambda t: jnp.moveaxis(t, -1, 1)  # noqa: E731
    with jax.enable_x64(True):
        model = JaxUNet3D(num_classes=2, initial_filter_size=F,
                          aleatoric_loss=aleatoric, dtype=jnp.float64,
                          param_dtype=jnp.float64)
        xj, tj = jnp.asarray(x, jnp.float64), jnp.asarray(seg)

        def jax_loss(p):
            out = model.apply({"params": p}, xj)
            if aleatoric:
                return JL.aleatoric_sampling_loss(
                    cf(out[0]), cf(out[1]), tj, rng, n_samples=3), out
            return JL.dice_ce_loss(cf(out), tj), out

        jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    params)
        (loss, out), grads = jax.jit(jax.value_and_grad(
            jax_loss, has_aux=True))(jp)
        eps = (np.asarray(jax.random.normal(rng, (3, B, 2, P, P, P),
                                            jnp.float64))
               if aleatoric else None)
    return dict(params=params, x=x, seg=seg, eps=eps, loss=float(loss),
                out=jax.tree_util.tree_map(np.asarray, out),
                grads=jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("aleatoric", [False, True])
def test_train_forward_matches_flax_float64(flax64, aleatoric):
    """f64 against flax UNet3D.apply: atol 1e-10 (PARITY.md's UNet3D
    bound)."""
    run = flax64(aleatoric)
    got = train_forward(_torch_tree(run["params"], torch.float64),
                        torch.tensor(run["x"], dtype=torch.float64))
    want = run["out"]
    if not aleatoric:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-10,
                                   rtol=0)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("aleatoric", [False, True])
def test_parameter_gradients_match_flax_float64(flax64, aleatoric):
    """Dice+CE (or the aleatoric objective, on the JAX draw of its
    normals) and its gradient on every leaf against jax.grad of the flax
    model, f64: rtol 1e-8, atol 1e-10 of the largest gradient (the
    biases of convs feeding an instance norm have a true gradient of 0,
    and both sides give roundoff there)."""
    run = flax64(aleatoric)
    tp = tree_map(lambda t: t.requires_grad_(True),
                  _torch_tree(run["params"], torch.float64))
    out = train_forward(tp, torch.tensor(run["x"], dtype=torch.float64))
    tt = torch.tensor(run["seg"])
    if aleatoric:
        loss = L.aleatoric_sampling_loss(
            out[0].movedim(-1, 1), out[1].movedim(-1, 1), tt,
            eps=torch.tensor(run["eps"]))
    else:
        loss = L.dice_ce_loss(out.movedim(-1, 1), tt)
    loss.backward()
    np.testing.assert_allclose(loss.item(), run["loss"], rtol=1e-12)
    want = dict(_leaves(run["grads"]))
    got = dict(_leaves(tree_map(lambda t: t.grad.numpy(), tp)))
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-8,
                                   atol=1e-10 * scale, err_msg=name)


def test_three_steps_match_jax_packed_experiment():
    """Three Experiment.train_steps from the same init on the same
    batches, f32: losses at rtol 2e-4 (ROADMAP item 3's bound); every
    leaf after 3 steps within 1e-4 of its norm. The biases of the
    contr_* convs, which feed instance norms, are left out: their true
    gradient is 0, so Adam turns either side's roundoff into lr-sized
    steps (tests/test_ensemble_training.py leaves them out too). Then
    one val_step on the trained parameters: loss rtol 2e-4, Dice
    exactly."""
    params = _init_params()
    port = Experiment(make_config(_cfg()), "cpu")
    state = port.state_from_variables({"params": params})
    assert all(t.is_contiguous() for t in tree_leaves(state.params))
    jexp = JaxExperiment(jax_make_config(_cfg(train_backend="packed")))
    jstate = jexp.state_from_variables(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)})
    got, want = [], []
    for step in range(3):
        x, seg = _batch(10 + step)
        state, loss = port.train_step(
            state, {"data": torch.tensor(x), "seg": torch.tensor(seg)})
        jstate, jloss = jexp.train_step(
            jstate, {"data": jnp.asarray(x), "seg": jnp.asarray(seg)},
            jax.random.PRNGKey(step))
        got.append(float(loss))
        want.append(float(jloss))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert state.step == 3
    final = dict(_leaves(tree_map(lambda t: t.detach().numpy(),
                                  state.params)))
    jfinal = dict(_leaves(jax.tree_util.tree_map(np.asarray,
                                                 jstate.params)))
    assert sorted(final) == sorted(jfinal)
    for name, w in jfinal.items():
        if name.startswith("contr_") and name.endswith("bias"):
            continue
        err = np.linalg.norm(final[name] - w) / np.linalg.norm(w)
        assert err <= 1e-4, (name, err)
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


def test_losses_and_metrics_match_jax():
    """f32, rtol 1e-6: Dice+CE, CE with ignore_index 255, NLL, and the
    Dice score of probabilities and of labels."""
    rs = np.random.RandomState(4)
    logits = rs.randn(2, 3, 5, 6, 7).astype(np.float32)
    target = rs.randint(0, 3, (2, 5, 6, 7))
    t255 = np.where(rs.rand(*target.shape) < 0.2, 255, target)
    lt, tt = torch.tensor(logits), torch.tensor(target)
    lj, tj = jnp.asarray(logits), jnp.asarray(target)
    pairs = [
        (L.dice_ce_loss(lt, tt), JL.dice_ce_loss(lj, tj)),
        (L.cross_entropy(lt, torch.tensor(t255), ignore_index=255),
         JL.cross_entropy(lj, jnp.asarray(t255), ignore_index=255)),
        (M.nll_loss(torch.log_softmax(lt, 1), tt),
         JM.nll_loss(jax.nn.log_softmax(lj, 1), tj)),
        (M.dice_score(lt, tt, ignore_index=0),
         JM.dice_score(lj, tj, ignore_index=0)),
        (M.dice_score(tt, tt.flip(0)), JM.dice_score(tj, tj[::-1])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("PortTrainToy")
    _toy_data(root)
    return root


@pytest.mark.parametrize("workers,training", [(0, True), (2, True),
                                              (0, False)])
def test_loader_batches_byte_equal_to_jax(toy, workers, training):
    """Two epochs of batches from the same seed are byte-equal to the JAX
    loader's: training batches (random crops and raters, sequential or
    on worker threads) and validation windows (random raters)."""
    base = str(toy / "Case_1" / "preprocessed")
    samples = (get_train_data_samples(base, num_raters=3) if training
               else get_val_test_data_samples(base, num_raters=3,
                                              patch_size=8))
    kw = dict(batch_size=4, patch_size=8, seed=11, num_workers=workers,
              training=training)
    port, ref = NumpyBatchLoader(samples, **kw), JaxLoader(samples, **kw)
    for _ in range(2):
        for a, b in zip(port, ref, strict=True):
            assert a.keys() == b.keys()
            for key in a:
                if isinstance(a[key], np.ndarray):
                    assert a[key].dtype == b[key].dtype
                    assert a[key].tobytes() == b[key].tobytes(), key
                else:
                    assert a[key] == b[key], key


def test_kfold_matches_scikit_learn():
    from sklearn.model_selection import KFold
    for n, k, seed in ((6, 3, 123), (42, 5, 123), (11, 4, 0)):
        got = list(kfold_indices(n, k, seed))
        want = list(KFold(k, shuffle=True, random_state=seed).split(
            np.arange(n)))
        assert len(got) == len(want)
        for (gt, gv), (wt, wv) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("name", ["softmax_config", "dropout_config",
                                  "ssn_config", "softmax_config_lidc"])
def test_compose_matches_jax(name):
    overrides = ["data_input_dir=/data", "datamodule.patch_size=16",
                 "+precision=bf16", "model.initial_filter_size=2"]
    assert compose("configs", name, overrides) == jax_compose(
        "configs", name, overrides)


def _cli_args(toy, save_dir, *extra):
    return ["--device", "cpu", f"data_input_dir={toy}",
            f"save_dir={save_dir}", "max_epochs=2", "batch_size=2",
            "datamodule.patch_size=16", "datamodule.batch_size=2",
            "datamodule.data_num_folds=3", "model.initial_filter_size=2",
            "version=0", *extra]


def test_training_cli_end_to_end(toy, tmp_path):
    """The port's training CLI on toy data writes a native checkpoint
    that the JAX package reads into the flax tree of UNet3D.init, with
    the torch optimizer state under its own key; the port's and the JAX
    score CLIs agree on it within tests/test_torch_score_cli.py's atol =
    rtol = 5e-3."""
    ckpt = main(_cli_args(toy, tmp_path / "exp"))
    assert ckpt.endswith(os.path.join("version_0", "checkpoints",
                                      "last.ckpt"))
    payload = jax_load(ckpt)
    assert payload["global_step"] == 4 and payload["epoch"] == 1
    assert "opt_state" not in payload
    assert payload[TORCH_OPTIMIZER_KEY]["state"]
    init = jax.eval_shape(JaxUNet3D(num_classes=2, initial_filter_size=2).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, P, P, P, 1)))
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shapes(payload["state_dict"]) == shapes(init)
    args = ["--checkpoint_paths", ckpt, "-i", str(toy), "--test_split",
            "val", "--dtype", "float32"]
    got = run_score(score_cli(args + ["--out", str(tmp_path / "p.json"),
                                      "--device", "cpu"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VALUES_TPU_AGG_LINEAR", "0")  # fault R1
        want = jax_run_score(jax_score_cli(
            args + ["--out", str(tmp_path / "j.json")]))
    assert got.keys() == want.keys() and len(got) == 2
    for subject, scores in got.items():
        np.testing.assert_allclose(
            [scores[r] for r in score_rows()],
            [want[subject][r] for r in score_rows()], atol=5e-3, rtol=5e-3,
            err_msg=subject)
    log_dir = tmp_path / "exp" / "Softmax-Case-1" / "version_0"
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(log_dir))


def test_resume_and_retention(toy, tmp_path):
    """fit resumes a port checkpoint's parameters, optimizer state and
    step; retention keeps last, every-n and the best k."""
    cfg = compose("configs", "softmax_config", _cli_args(
        toy, tmp_path / "exp", "save_top_k=1",
        "checkpoint_every_n_epochs=1")[2:])
    ckpt = fit(cfg, device="cpu")
    names = set(os.listdir(os.path.dirname(ckpt)))
    assert {"epoch=0.ckpt", "epoch=1.ckpt", "last.ckpt"} <= names
    assert len([n for n in names if "val_loss=" in n]) == 1
    cfg["max_epochs"] = 3
    resumed = fit(cfg, resume_from=ckpt, device="cpu")
    assert jax_load(resumed)["global_step"] == 6


@pytest.mark.parametrize("case", ["dropout", "ssn", "devices", "orbax",
                                  "2d", "augment", "hrnet"])
def test_refusals(toy, tmp_path, case, monkeypatch):
    """What is not ported raises NotImplementedError naming its ROADMAP
    item: orbax checkpoints. Dropout and SSN models now train
    (tests/test_torch_dropout_training.py, test_torch_ssn_training.py),
    and data parallelism runs (tests/test_torch_parallel_fit.py): ``fit``
    asked for 2 devices in a process that belongs to no torch.distributed
    world refuses, naming the launchers (the training CLI spawns the
    ranks itself), before the data is touched. ``augment=True`` now runs
    the native ops (tests/test_torch_lidc.py); a failed build of them
    raises instead of falling back to numpy."""
    if case == "augment":
        from values_tpu_torch.data import native
        monkeypatch.setattr(native, "GXX_FLAGS", ("--no-such-flag",))
        native._load.cache_clear()
        loader = NumpyBatchLoader(get_train_data_samples(
            str(toy / "Case_1" / "preprocessed"), num_raters=3), 2, 8,
            augment=True, prefetch=0)
        try:
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                next(iter(loader))
        finally:
            native._load.cache_clear()
        return
    if case == "hrnet":
        # the HRNet trains (tests/test_torch_training_2d.py): the
        # Experiment builds its 2D state; the 3D entry and an aleatoric
        # objective, which it has no head for, refuse
        from tests.test_hrnet import small_cfg
        from values_tpu_torch.models.hrnet import (HighResolutionNet,
                                                   get_seg_model)
        assert locate("values_tpu.models.hrnet.get_seg_model") is \
            get_seg_model
        node = {"model": {"_target_": "values_tpu.models.hrnet."
                                      "get_seg_model", "cfg": small_cfg()}}
        exp = Experiment(make_config(node), "cpu")
        assert exp.is_2d and not exp.is_ssn
        state = exp.init_state_2d(0, 32, 32, 3)
        assert isinstance(state.params, HighResolutionNet)
        assert state.params.training
        assert set(exp.variables(state)) == {"params", "batch_stats"}
        with pytest.raises(ValueError, match="init_state_2d"):
            exp.init_state(0, 16)
        with pytest.raises(ValueError, match="aleatoric"):
            Experiment(make_config(dict(node, aleatoric_loss=True)), "cpu")
        return
    if case == "2d":
        # 2D training runs (tests/test_torch_fit_2d.py), over several
        # ranks too; fit outside a world refuses before the data is
        # touched
        cfg = compose("configs", "gta_softmax_config", [
            f"data_input_dir={tmp_path / 'none'}",
            f"save_dir={tmp_path / 'exp'}", "gpus=2"])
        with pytest.raises(RuntimeError, match="torchrun"):
            fit(cfg, device="cpu")
        return
    name, extra = {
        "dropout": ("dropout_config", ["gpus=2"]),
        "ssn": ("ssn_config", ["gpus=2"]),
        "devices": ("softmax_config", ["gpus=2"]),
        "orbax": ("softmax_config", ["checkpoint_format=orbax"]),
    }[case]
    args = _cli_args(toy, tmp_path / "exp", *extra)
    if case != "orbax":
        cfg = compose("configs", name, args[2:])
        with pytest.raises(RuntimeError, match="torchrun"):
            fit(cfg, device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--config-name", name] + args)


def test_logger_falls_back_to_jsonl(tmp_path, monkeypatch):
    """Without a TensorBoard package the scalars go to scalars.jsonl and
    the panels to .npy files."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    logger = TensorBoardLogger(str(tmp_path), "E")
    logger.log_hparams({"a": {"b": 1}, "c": None})
    logger.log_scalars({"training/train_loss": 0.5}, 3)
    logger.log_image("validation/example", np.zeros((4, 12, 3)), 3)
    logger.finalize()
    log_dir = tmp_path / "E" / "version_0"
    lines = (log_dir / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(l) for l in lines] == [
        {"tag": "training/train_loss", "value": 0.5, "step": 3}]
    assert (log_dir / "images" / "validation_example_3.npy").exists()
    assert json.loads((log_dir / "hparams.json").read_text()) == {"a/b": 1}


def test_schedules_and_clipping_match_jax():
    """The plateau tracker and the polynomial schedule give the JAX
    module's rates; clipping scales by max_norm / (norm + 1e-6)."""
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.8, 0.9, 0.9, 0.9, 0.9]
    port = optim.PlateauTracker(optim.reduce_lr_on_plateau(patience=2)(1e-3))
    ref = jax_optim.PlateauTracker(
        jax_optim.reduce_lr_on_plateau(patience=2)(1e-3))
    assert [port.step(m) for m in metrics] == [ref.step(m) for m in metrics]
    sched, jsched = (optim.polynomial_lr(total_iters=7, power=0.9)(0.01),
                     jax_optim.polynomial_lr(total_iters=7, power=0.9)(0.01))
    assert [sched.value(s) for s in range(9)] == [jsched.value(s)
                                                  for s in range(9)]
    g = [torch.full((3,), 3.0, requires_grad=True),
         torch.full((4,), 4.0, requires_grad=True)]
    for t in g:
        t.grad = t.detach().clone()
    norm = optim.clip_grads_by_global_norm(g, 1.0)
    want = jax_optim.clip_grads_by_global_norm(
        [jnp.full((3,), 3.0), jnp.full((4,), 4.0)], 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(27 + 64), rtol=1e-6)
    for t, w in zip(g, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-6)
    opt = optim.sgd(lr=0.1, momentum=0.9)(g)
    optim.set_learning_rate(opt, 0.05)
    assert optim.get_learning_rate(opt) == 0.05


def test_checkpoint_retention_top_k(tmp_path):
    ret = CheckpointRetention(str(tmp_path), save_top_k=2)
    for epoch, value in enumerate([3.0, 1.0, 2.0, 0.5]):
        ret.save({"params": {"w": np.zeros(2)}}, {}, epoch=epoch,
                 global_step=epoch, monitored=value)
    kept = sorted(f for f in os.listdir(tmp_path) if "val_loss" in f)
    assert kept == ["epoch=1-val_loss=1.0000.ckpt",
                    "epoch=3-val_loss=0.5000.ckpt"]
    with open(ret.best_path, "rb") as f:
        assert pickle.load(f)["epoch"] == 3


@pytest.mark.parametrize("extra", [["+aleatoric_loss=true"],
                                   ["+precision=bf16"]],
                         ids=["aleatoric", "bf16"])
def test_training_cli_variants(toy, tmp_path, extra):
    """The aleatoric objective and bf16 compute train through the CLI:
    the checkpoint carries the head the objective needs, every leaf
    float32 and finite."""
    ckpt = main(_cli_args(toy, tmp_path / "exp", "max_epochs=1", *extra))
    params = jax_load(ckpt)["state_dict"]["params"]
    assert ("final_aleatoric" in params) == ("aleatoric" in extra[0])
    assert "final" in params or "final_aleatoric" in params
    for name, leaf in _leaves(params):
        assert leaf.dtype == np.float32 and np.isfinite(leaf).all(), name


def test_clipped_sgd_step_matches_jax():
    """gradient_clip_val with SGD, one step from the same init, against
    the JAX Experiment's XLA backend (flax): loss rtol 1e-5, parameters
    atol 1e-6 (lr 0.1 times gradients clipped to a global norm of 1e-2)."""
    extra = dict(gradient_clip_val=1e-2,
                 optimizer={"_target_": "torch.optim.SGD", "lr": 0.1})
    params = _init_params()
    port = Experiment(make_config(_cfg(**extra)), "cpu")
    state = port.state_from_variables({"params": params})
    jexp = JaxExperiment(jax_make_config(_cfg(**extra)))
    jstate = jexp.state_from_variables(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)})
    x, seg = _batch(30)
    state, loss = port.train_step(state, {"data": torch.tensor(x),
                                          "seg": torch.tensor(seg)})
    jstate, jloss = jexp.train_step(
        jstate, {"data": jnp.asarray(x), "seg": jnp.asarray(seg)},
        jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = dict(_leaves(tree_map(lambda t: t.detach().numpy(),
                                state.params)))
    for name, w in _leaves(jax.tree_util.tree_map(np.asarray,
                                                  jstate.params)):
        np.testing.assert_allclose(got[name], w, atol=1e-6, err_msg=name)
