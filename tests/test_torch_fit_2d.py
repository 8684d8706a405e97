"""The GTA pipeline's training half end to end in the port, on the CPU:
``fit`` (2 epochs of the 2D datamodule, HRNet small_cfg, SGD and the
polynomial rate) and the training CLI on ``gta_softmax_config`` (widths
cut by overrides) write native checkpoints that the JAX package's
``load_checkpoint`` reads and both packages' ``test_2d`` CLIs run (the
JAX one's outputs held to the port's by tests/test_torch_test_2d.py's
limits); the port's test_2d maps then go through ``eval_config_gta``'s six
tasks in both packages (every task file equal, floats within 1e-6;
tests/test_torch_evaluation.py's limits for the Platt parameters and
the calibration). The JAX ``fit`` is not run (its tests are slow)."""
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401
import values_tpu.evaluation.eval_experiments as J_EVAL
from tests.test_2d_path import AUG_CONFIG, H, W, make_gta_tree
from tests.test_hrnet import small_cfg
from tests.test_torch_evaluation import _close, _outputs, _task_files
from tests.test_torch_test_2d import _compare, _read
from values_tpu.config import compose as jax_compose
from values_tpu.config import make_config as jax_make_config
from values_tpu.inference import test_2d as J2D
from values_tpu.training.checkpoint import load_checkpoint as jax_load
from values_tpu_torch.config import compose, make_config
from values_tpu_torch.evaluation import eval_experiments as P_EVAL
from values_tpu_torch.inference import test_2d as P2D
from values_tpu_torch.training.loops import fit
from values_tpu_torch.training.main import main as train_main

ROOT = Path(__file__).resolve().parents[1]
VERSION = "fold0_seed123"
SPLITS = ("val", "id", "ood", "unlabeled")


def _config(gta, save_dir, seed, **cfg_kw):
    aug = dict(AUG_CONFIG, height=H, width=W)
    cfg = small_cfg(num_classes=24, **cfg_kw)
    return make_config({
        "exp_name": "Softmax-GTA", "version": VERSION, "seed": seed,
        "save_dir": str(save_dir), "data_input_dir": str(gta),
        "max_epochs": 2, "batch_size": 1, "learning_rate": 0.01,
        "weight_decay": 0.0005, "MODEL": cfg["MODEL"],
        "model": {"_target_": "values_tpu.models.hrnet.get_seg_model",
                  "cfg": cfg},
        "optimizer": {"_target_": "torch.optim.SGD", "lr": 0.01,
                      "momentum": 0.9, "weight_decay": 0.0005},
        "lr_scheduler": {"_target_":
                         "torch.optim.lr_scheduler.PolynomialLR",
                         "power": 0.9},
        "datamodule": {
            "_target_": "values_tpu.data.base_datamodule.BaseDataModule",
            "num_classes": 24, "ignore_index": 255, "num_workers": 0,
            "batch_size": 1, "val_batch_size": 1, "data_fold_id": 0,
            "dataset": {
                "_target_":
                    "values_tpu.data.cityscapes_dataset.CityscapesDataset",
                "splits_path": str(gta / "splits" / "firstCycle"
                                   / "splits.pkl")}},
        "AUGMENTATIONS": aug})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    work = tmp_path_factory.mktemp("fit2d")
    gta = make_gta_tree(work / "GTA")
    ckpts = [fit(_config(gta, work / "exp", seed), device="cpu")
             for seed in (123, 124)]
    return work, gta, ckpts


def test_fit_writes_checkpoints_the_jax_package_reads(trained):
    work, _, ckpts = trained
    payload = jax_load(ckpts[0])
    assert payload["epoch"] == 1 and payload["global_step"] == 4
    variables = payload["state_dict"]
    assert set(variables) == {"params", "batch_stats"}
    import jax
    import jax.numpy as jnp
    from values_tpu.models.hrnet import HighResolutionNet
    model = HighResolutionNet(cfg=small_cfg(num_classes=24))
    want = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, H, W, 3)))
    for collection in ("params", "batch_stats"):
        assert sorted(variables[collection]) == sorted(want[collection])
        for module, leaves in want[collection].items():
            for leaf, shape in leaves.items():
                assert variables[collection][module][leaf].shape == \
                    shape.shape
    assert not np.allclose(variables["batch_stats"]["bn1"]["var"], 1)
    assert "torch_optimizer_state" in payload
    assert payload["hyper_parameters"]["AUGMENTATIONS"]["height"] == H
    log_dir = work / "exp" / "Softmax-GTA" / VERSION
    assert any(f.name.startswith("events.out.tfevents")
               for f in log_dir.iterdir())


def test_both_testers_read_the_trained_checkpoints(trained):
    """The trained pair as an ensemble through both test_2d CLIs."""
    work, _, ckpts = trained
    split = "ood"
    common = ["--checkpoint_paths", *ckpts, "--test_split", split,
              "--n_reference_samples", "2"]
    jdir, pdir = work / f"jax_{split}", work / f"port_{split}"
    J2D.run_test(J2D.test_cli(common + ["--save_dir", str(jdir)]))
    P2D.main(common + ["--save_dir", str(pdir), "--device", "cpu"])
    base = Path("Softmax-GTA") / "test_results" / VERSION / split
    _compare(_read(pdir / base), _read(jdir / base))


def test_training_cli_on_gta_softmax_config(trained, tmp_path):
    """``--config-name gta_softmax_config`` with the widths cut by
    overrides and ``model=hrnet_config_dropout_final``: one epoch."""
    _, gta, _ = trained
    widths = {"STAGE1": ("[1]", "[8]"), "STAGE2": ("[1, 1]", "[4, 8]"),
              "STAGE3": ("[1, 1, 1]", "[4, 8, 16]"),
              "STAGE4": ("[1, 1, 1, 1]", "[4, 8, 16, 32]")}
    overrides = [f"data_input_dir={gta}", f"save_dir={tmp_path}",
                 "max_epochs=1", "batch_size=1", "version=0",
                 "datamodule.val_batch_size=1",
                 f"datamodule.dataset.splits_path="
                 f"{gta / 'splits' / 'firstCycle' / 'splits.pkl'}",
                 f"AUGMENTATIONS.height={H}", f"AUGMENTATIONS.width={W}",
                 "MODEL.PRETRAINED=true", "model=hrnet_config_dropout_final"]
    for stage, (blocks, channels) in widths.items():
        overrides += [f"MODEL.EXTRA.{stage}.NUM_BLOCKS={blocks}",
                      f"MODEL.EXTRA.{stage}.NUM_CHANNELS={channels}"]
    overrides += ["MODEL.EXTRA.STAGE3.NUM_MODULES=1",
                  "MODEL.EXTRA.STAGE4.NUM_MODULES=1"]
    ckpt = train_main(["--config-name", "gta_softmax_config", "--device",
                       "cpu"] + overrides)
    payload = jax_load(ckpt)
    assert payload["epoch"] == 0 and payload["global_step"] == 2
    hp = payload["hyper_parameters"]
    assert hp["MODEL"]["EXTRA"]["DROPOUT_FINAL"] is True
    assert hp["optimizer"]["_target_"] == "torch.optim.SGD"


def _eval_tree(trained):
    """The port's test_2d maps of the trained pair as an Ensemble, as
    eval_config_gta reads them, over the val, id, ood and unlabeled
    splits."""
    work, _, ckpts = trained
    base = work / "eval_tree"
    if base.exists():
        return base
    for model, paths in (("Ensemble", ckpts),):
        for split in SPLITS:
            P2D.main(["--checkpoint_paths", *paths, "--test_split", split,
                      "--save_dir", str(base), "--exp_name", model,
                      "--device", "cpu"])
    return base


def _overrides(base, gta):
    return [f"base_path={base}", "GTA.iter_params.pred_model=[Ensemble]",
            "GTA.iter_params.seed=['123']",
            f"GTA.datamodule_config.data_input_dir={gta}",
            "GTA.datamodule_config.dataset.splits_path="
            f"{gta / 'splits' / 'firstCycle' / 'splits.pkl'}"]


def _jax_with_r13_repaired(cfg, monkeypatch, n=5):
    """The JAX evaluation with reference hazard R13 repaired as the port
    repairs it: eval_config_gta's TEST pipeline draws ``n_reference_segs``
    = 5 masks (the JAX loader keeps its one, and the calibration then
    fails on the shapes), and the GT uncertainty stays (H, W) like the
    testers' maps (the JAX loader transposes it, and ambiguity_modeling
    then fails on non-square images)."""
    import values_tpu.evaluation.gta as J_GTA
    tree = cfg.to_container()
    for experiment in tree["experiments"]:
        for aug in experiment["datamodule_config"]["augmentations"]["TEST"][
                0]["Compose"]["transforms"]:
            if "StochasticLabelSwitches" in aug:
                aug["StochasticLabelSwitches"]["n_reference_samples"] = n
    gt_unc_map = J_GTA.gt_unc_map
    monkeypatch.setattr(J_GTA, "gt_unc_map",
                        lambda image_id, dataloader: np.swapaxes(
                            gt_unc_map(image_id, dataloader), 0, 1))
    return jax_make_config(tree)


def test_eval_config_gta_matches_jax(trained, tmp_path, monkeypatch):
    """eval_config_gta's six tasks (threshold, aggregation, ood_detection,
    failure_detection, calibration, ambiguity_modeling) on the port's
    test_2d maps (non-square, as GTA's are), in both packages on copies
    of the tree: the port on the shipped config, the JAX package with
    R13 repaired as the port repairs it (:func:`_jax_with_r13_repaired`)."""
    _, gta, _ = trained
    tree = _eval_tree(trained)
    bases = {}
    for name in ("jax", "port"):
        bases[name] = tmp_path / name
        shutil.copytree(tree, bases[name])
    config_dir = str(ROOT / "configs" / "evaluation")
    splits_dir = str(gta / "splits")
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        cfg = jax_compose(config_dir, "eval_config_gta",
                          _overrides(bases["jax"], gta))
        cfg["task_params"]["ood_detection"]["function"][
            "base_splits_path"] = splits_dir
        J_EVAL.EvalExperiments(_jax_with_r13_repaired(
            cfg, monkeypatch)).analyse()
        cfg = compose(config_dir, "eval_config_gta",
                             _overrides(bases["port"], gta))
        cfg["task_params"]["ood_detection"]["function"][
            "base_splits_path"] = splits_dir
        P_EVAL.EvalExperiments(cfg).analyse()
    names = _task_files(bases["jax"])
    assert names == _task_files(bases["port"])
    assert any("ood_detection" in n for n in names)
    assert any("ncc" in n or "ambiguity" in n for n in names)
    got, want = _outputs(bases["port"], names), _outputs(bases["jax"], names)
    for name in names:
        if "platt_scale_params" in name:
            assert _close(got[name], want[name], rtol=1e-5), name
        elif name.endswith("calibration.json"):
            assert _close(got[name], want[name], atol=1e-5), name
        else:
            assert _close(got[name], want[name], atol=1e-6), name
