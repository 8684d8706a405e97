"""The plain reference against the program's CPU path at a small size
(this test imports both; the reference imports nothing of the program)."""
import copy

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import hrnet as ref_hrnet
from benchmark.reference import measures
from benchmark.reference import train as ref_train
from benchmark.reference import unet3d as ref_unet3d

MODEL = {"num_classes": 2, "in_channels": 1, "initial_filter_size": 4}


def _states(members, seed=3):
    return inputs.unet3d_states(MODEL, members, inputs.generator(seed, "cpu"),
                                "cpu")


def test_unet3d_forward_matches_the_program_module():
    from values_tpu_torch.models.unet3d import UNet3D
    (sd,) = _states(1)
    net = UNet3D(2, initial_filter_size=4)
    missing = net.load_state_dict(sd, strict=False)
    assert set(missing.missing_keys) == {"output_reconstruction_map.weight",
                                         "output_reconstruction_map.bias"}
    assert not missing.unexpected_keys
    x = torch.rand(2, 16, 16, 16, 1, generator=torch.Generator()
                   .manual_seed(0))
    with torch.no_grad():
        want = net.eval()(x).permute(0, 4, 1, 2, 3)
        got = ref_unet3d.forward(sd, x.permute(0, 4, 1, 2, 3))
    assert torch.allclose(got, want, atol=1e-6)


def test_scores_match_the_program_scorer():
    from values_tpu_torch.inference.scoring import make_scorer
    from values_tpu_torch.models.ensemble_unet3d import cast_weights
    from values_tpu_torch.models.torch_import import group_member_state_dicts
    states = _states(3)
    gen = inputs.generator(5, "cpu")
    vols, masks = inputs.volume_pool(gen, 2, 16, 4, (0.1, 0.5), "cpu")
    score, _ = make_scorer(3, 16, agg_patch=4, threshold=0.3,
                           dtype=torch.float32, device="cpu")
    got = score(cast_weights(group_member_state_dicts(states),
                             torch.float32, "cpu"), vols, masks)
    x = vols.permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        probs = torch.stack([torch.softmax(ref_unet3d.forward(sd, x)
                                           .double(), 1) for sd in states])
    want = measures.volume_scores(probs, masks, agg_patch=4, threshold=0.3,
                                  ignore_index=0)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-5)


def test_hrnet_matches_the_program_module():
    from values_tpu_torch.models.hrnet import HighResolutionNet
    from conftest import small
    _, cfg, trf = small("hrnet-w48-ens5-test2d-b6-f32")
    model_cfg = cfg["model"]["cfg"]
    calib = torch.randn(2, 3, 32, 48, generator=torch.Generator()
                        .manual_seed(1))
    (sd,), flops = inputs.hrnet_states(model_cfg, 1, calib,
                                       inputs.generator(2, "cpu"))
    assert flops > 0
    port = HighResolutionNet(model_cfg)
    port.load_state_dict(sd, strict=True)
    ref = ref_hrnet.HRNet(model_cfg)
    ref.load_state_dict(sd, strict=True)
    x = torch.randn(2, 3, 32, 48)
    with torch.no_grad():
        assert torch.allclose(ref.eval()(x), port.eval()(x), atol=1e-5)


def test_hrnet_w48_width_and_flops():
    """The published HRNetV2-W48: 65.86 M parameters with 24 classes."""
    bench = harness.load_benchmark()
    _, cfg, _ = harness.resolve(bench, "hrnet-w48-ens5-test2d-b6-f32")
    with torch.device("meta"):
        net = ref_hrnet.HRNet(cfg["model"]["cfg"])
    n = sum(p.numel() for p in net.parameters())
    assert n == pytest.approx(65.86e6, rel=1e-3)


def test_2d_measures_match_the_program():
    from values_tpu_torch.ops import metrics as M
    from values_tpu_torch.ops import uncertainty as U
    g = torch.Generator().manual_seed(4)
    probs = torch.softmax(torch.randn(5, 4, 8, 12, generator=g), 1)
    probs = torch.cat([probs, torch.zeros(5, 1, 8, 12)], 1)
    gt = torch.randint(0, 5, (1, 8, 12), generator=g)
    stats = measures.sample_statistics(probs.double(), class_axis=1)
    port = U.uncertainty_measures(probs)
    for mine, theirs in (("pred_entropy", "pred_entropy"),
                         ("expected_entropy", "aleatoric_uncertainty"),
                         ("mutual_information", "epistemic_uncertainty")):
        assert torch.allclose(stats[mine].float(), port[theirs], atol=1e-6)
    seg = stats["mean_softmax"].argmax(0)
    dice = measures.dice_from_counts(measures.dice_counts(seg, gt[0], 4,
                                                          (0, 1)))
    want = M.dice_score(probs.mean(0)[None], gt, ignore_index=4)
    assert float(dice) == pytest.approx(float(want))
    ged = measures.ged(probs.double(), gt, 4)
    want = M.generalized_energy_distance(probs, gt, ignore_index=4,
                                         ged_only=True)["ged"]
    assert float(ged) == pytest.approx(float(want), abs=1e-12)


def test_training_steps_match_the_program():
    from values_tpu_torch.config import make_config
    from values_tpu_torch.models.torch_import import unet3d_params_from_torch
    from values_tpu_torch.training.experiment import Experiment
    (sd,) = _states(1, seed=9)
    gen = inputs.generator(6, "cpu")
    vols, masks = inputs.volume_pool(gen, 6, 16, 1, (0.1, 0.5), "cpu")
    exp = Experiment(make_config({
        "model": {"_target_": "values_tpu.models.unet3d.UNet3D", **MODEL},
        "learning_rate": 3e-4, "weight_decay": 1e-5}), "cpu")
    state = exp.state_from_variables(unet3d_params_from_torch(
        copy.deepcopy(sd)))
    losses = []
    for j in range(3):
        batch = {"data": vols[2 * j:2 * j + 2],
                 "seg": masks[2 * j:2 * j + 2, 0].long()}
        state, loss = exp.train_step(state, batch)
        losses.append(float(loss))
    batches = [(vols[2 * j:2 * j + 2].permute(0, 4, 1, 2, 3),
                masks[2 * j:2 * j + 2, 0].long()) for j in range(3)]
    ref_losses, _, ref_params = ref_train.train_steps(sd, batches, 3e-4,
                                                      1e-5)
    assert np.allclose(losses, ref_losses, rtol=1e-5)
    # Adam's first steps move a leaf by ~lr an element, whatever the
    # gradient's size, so the leaves are compared by the norm of their
    # change: elements whose gradient is round-off flip either way
    start = unet3d_params_from_torch(sd)["params"]
    port = unet3d_params_from_torch(ref_params)["params"]
    for name in ("final", "contr_2_1", "expand_1_1", "upscale2"):
        got = state.params[name].get("conv", state.params[name])
        a = start[name].get("conv", start[name])
        b = port[name].get("conv", port[name])
        moved = np.linalg.norm(got["kernel"].detach().numpy() - a["kernel"])
        want = np.linalg.norm(b["kernel"] - a["kernel"])
        assert moved == pytest.approx(want, rel=1e-3)


def test_written_labels_are_judged_as_the_tester_scores_them():
    """The check reads the tester's colour-coded label maps back to
    classes, gives the tester's Dice exactly, and a GED range that holds
    the tester's GED whatever the members' labels where the mask is
    ignored."""
    from values_tpu_torch.data import cityscapes_labels as cs_labels
    from values_tpu_torch.inference.test_2d import _color_table
    from values_tpu_torch.ops import metrics as M
    from benchmark.drivers import tester2d
    gen = torch.Generator().manual_seed(4)
    s, c, h, w = 3, 6, 8, 10
    probs = torch.softmax(3 * torch.randn((s, c, h, w), generator=gen), 1)
    gt = torch.randint(0, c, (h, w), generator=gen)
    gt[:2] = c                                  # ignored rows
    colors = _color_table()
    unlabeled = cs_labels.name2trainId["unlabeled"]
    table = tester2d.label_table(colors, unlabeled, "cpu")
    stack = torch.cat([probs.mean(0)[None], probs])
    labels = stack.argmax(1)
    labels[:, gt == c] = unlabeled
    written = dict(zip(["mean"] + [f"{k + 1:02d}" for k in range(s)],
                       colors[labels.numpy()]))
    judged = tester2d.judge_image(probs.double(), gt, written, table)
    assert judged["label_gap"] == 0.0
    padded = torch.cat([probs, probs.new_zeros((s, 1, h, w))], 1)
    want = M.dice_score(padded.mean(0)[None], gt[None], ignore_index=c)
    assert judged["dice"] == float(want)
    ged = float(M.generalized_energy_distance(
        padded, gt[None], ignore_index=c, ged_only=True)["ged"])
    lo, hi = judged["ged"]
    assert lo < hi and lo <= ged <= hi
    written["mean"] = written["mean"].copy()
    written["mean"][5, 5] = colors[unlabeled]   # unlabeled off the mask
    assert tester2d.judge_image(probs.double(), gt, written,
                                table)["label_gap"] == float("inf")
