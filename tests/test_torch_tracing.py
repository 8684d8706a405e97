"""The port's span recorder (``values_tpu_torch.core.tracing``): off and
free of torch calls without a profiler; inside one, the spans and counters
of the scorer, the training step and the 2D tester, and their annotations
in the profiler's trace."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from values_tpu_torch.config import instantiate, make_config
from values_tpu_torch.core import tracing
from values_tpu_torch.inference import test_2d
from values_tpu_torch.inference.scoring import make_scorer
from values_tpu_torch.models.torch_import import (group_member_state_dicts,
                                                  unet3d_params_to_torch)
from values_tpu_torch.training.experiment import Experiment, tree_map

M, P, B, F = 2, 16, 2, 4
CLASSES, H, W, S = 5, 32, 48, 2

SCORE = {"score": None, "score.cast": "score", "score.forward": "score",
         "score.c2": "score", "score.c3": "score"}
TRAIN = {"train_step": None, "train_step.forward": "train_step",
         "train_step.backward": "train_step",
         "train_step.optimizer": "train_step"}
TEST2D = {"test2d.batch": None, "test2d.to_device": "test2d.batch",
          "test2d.forward": "test2d.batch",
          "test2d.process_output": "test2d.batch",
          "test2d.metrics": "test2d.process_output",
          "test2d.uncertainty": "test2d.process_output",
          "test2d.save_prediction": "test2d.process_output",
          "test2d.save_uncertainty": "test2d.process_output",
          "test2d.write": ("test2d.save_prediction",
                           "test2d.save_uncertainty")}
# the blocking reads of one image that the code makes: the GED's ignore
# check, the two metrics, the colour map and the three uncertainty maps
READBACKS_PER_IMAGE = 1 + 2 + 1 + 3


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _experiment():
    return Experiment(make_config({
        "model": {"_target_": "values_tpu.models.unet3d.UNet3D",
                  "num_classes": 2, "initial_filter_size": F},
        "datamodule": {"ignore_index": 0}, "learning_rate": 3e-4,
        "weight_decay": 1e-5, "seed": 7}), "cpu")


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(B, P, P, P, 1).astype(np.float32)),
            torch.from_numpy((rs.rand(B, P, P, P) > 0.6).astype(np.int64)))


@pytest.fixture(scope="module")
def scorer():
    exp = _experiment()
    states = [unet3d_params_to_torch(tree_map(
        lambda t: t.detach().numpy(), exp.init_state(seed, P).params))
        for seed in range(M)]
    score, _ = make_scorer(M, P, agg_patch=4, dtype=torch.float32,
                           device="cpu")
    return score, group_member_state_dicts(states)


def _profiled(fn, path=None):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    if path is not None:
        prof.export_chrome_trace(str(path))


def _check_tree(recs, parents):
    """Every record's parent and root, by name."""
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        want = parents[r["name"]]
        if want is None:
            assert r["parent"] is None and r["root"] == r["id"]
        else:
            parent = by_id[r["parent"]]
            assert parent["name"] in (want if isinstance(want, tuple)
                                      else (want,))
            assert r["root"] == parent["root"]
            assert by_id[r["root"]]["parent"] is None


def test_off_without_a_profiler(scorer, monkeypatch):
    """No profiler: the shared null context, no torch call, no record."""
    assert tracing.span("score") is tracing.span("train_step")
    assert tracing.span("score") is tracing._NULL

    def forbidden(*a, **k):
        raise AssertionError("a span called torch with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    score, weights = scorer
    x, gt = _batch()
    score(weights, x, gt)
    tracing.count("readbacks", 3)
    tracing.to_host(torch.zeros(4))
    assert tracing.records() == [] and tracing.summary() == {}
    assert tracing.totals() == {}


def test_scorer_spans(scorer):
    score, weights = scorer
    x, gt = _batch()
    plain = score(weights, x, gt)
    got = []
    _profiled(lambda: got.extend(score(weights, x, gt) for _ in range(2)))
    assert all(torch.equal(g, plain) for g in got)
    recs = tracing.records()
    assert {r["name"] for r in recs} == set(SCORE)
    _check_tree(recs, SCORE)
    summary = tracing.summary()
    assert all(summary[n]["calls"] == 2 for n in SCORE)
    assert len({r["root"] for r in recs}) == 2
    for n, s in summary.items():
        assert s["stream_ms"] is None          # no card
        assert 0 <= s["self_host_ms"] <= s["host_ms"]
    root = summary["score"]
    children = sum(summary[n]["host_ms"] for n in SCORE if n != "score")
    assert root["self_host_ms"] == pytest.approx(
        root["host_ms"] - children, abs=1e-6)


def test_train_step_spans():
    exp = _experiment()
    state = exp.init_state(3, P)
    x, gt = _batch(1)
    batch = {"data": x, "seg": gt}
    gen = torch.Generator().manual_seed(0)
    _profiled(lambda: [exp.train_step(state, batch, gen) for _ in range(3)])
    recs = tracing.records()
    assert {r["name"] for r in recs} == set(TRAIN)
    _check_tree(recs, TRAIN)
    assert all(tracing.summary()[n]["calls"] == 3 for n in TRAIN)
    assert state.step == 3


def _tiny_hrnet():
    stage = {"NUM_MODULES": 1, "BLOCK": "BASIC", "FUSE_METHOD": "SUM"}
    return {"MODEL": {
        "NAME": "hrnet", "PRETRAINED": False, "ALIGN_CORNERS": False,
        "INPUT_CHANNELS": 3,
        "EXTRA": {
            "FINAL_CONV_KERNEL": 1,
            "STAGE1": {"NUM_MODULES": 1, "NUM_BRANCHES": 1,
                       "BLOCK": "BOTTLENECK", "NUM_BLOCKS": [1],
                       "NUM_CHANNELS": [4], "FUSE_METHOD": "SUM"},
            "STAGE2": dict(stage, NUM_BRANCHES=2, NUM_BLOCKS=[1, 1],
                           NUM_CHANNELS=[2, 4]),
            "STAGE3": dict(stage, NUM_BRANCHES=3, NUM_BLOCKS=[1, 1, 1],
                           NUM_CHANNELS=[2, 4, 8],
                           DROPOUT=[False] * 3),
            "STAGE4": dict(stage, NUM_BRANCHES=4, NUM_BLOCKS=[1] * 4,
                           NUM_CHANNELS=[2, 4, 8, 16],
                           DROPOUT=[False] * 4)}},
        "DATASET": {"NUM_CLASSES": CLASSES}}


class _Tester(test_2d.Tester2D):
    """Tester2D without checkpoints or a datamodule: S members of a tiny
    HRNet, batches handed in as a list."""

    def __init__(self, save_dir, batches):
        self.device = torch.device("cpu")
        self.dtype = torch.float32
        self.hparams = {"model": {
            "_target_": "values_tpu.models.hrnet.get_seg_model",
            "cfg": _tiny_hrnet()}}
        self.ignore_index = 255
        self.tta, self.n_pred, self.is_ssn = False, 1, False
        torch.manual_seed(0)
        self.models = [self._load_model(self.hparams, instantiate(
            make_config(dict(self.hparams["model"]))).state_dict())
            for _ in range(S)]
        self.results_dict = {}
        self.generator = torch.Generator().manual_seed(0)
        self.sliding_window, self._sliding = None, {}
        self._colors = torch.from_numpy(test_2d._color_table())
        self.save_dir = str(save_dir)
        self.save_pred_dir = os.path.join(self.save_dir, "pred_seg")
        os.makedirs(self.save_pred_dir, exist_ok=True)
        self.test_dataloader = batches


def _image_batches(n):
    rs = np.random.RandomState(5)
    for k in range(n):
        seg = rs.randint(0, CLASSES, (B, H, W))
        seg[:, :4] = 255
        yield {"data": rs.randn(B, H, W, 3).astype(np.float32),
               "seg": seg, "image_id": [f"{k}_{i}" for i in range(B)],
               "dataset": ["gta"] * B}


def test_tester2d_spans_and_readbacks(tmp_path):
    tester = _Tester(tmp_path, list(_image_batches(2)))
    trace = tmp_path / "trace.json"
    _profiled(tester.predict_cases, trace)
    recs = tracing.records()
    assert {r["name"] for r in recs} == set(TEST2D)
    _check_tree(recs, TEST2D)
    summary = tracing.summary()
    per_batch = {"test2d.batch": 1, "test2d.to_device": S,
                 "test2d.forward": S, "test2d.process_output": 1,
                 "test2d.metrics": B, "test2d.uncertainty": B,
                 "test2d.save_prediction": B, "test2d.save_uncertainty": B,
                 "test2d.write": 2 * B}
    assert {n: s["calls"] for n, s in summary.items()} == {
        n: 2 * k for n, k in per_batch.items()}
    totals = tracing.totals()
    assert totals["images"] == 2 * B
    assert totals["readbacks"] == READBACKS_PER_IMAGE * totals["images"]
    assert totals["h2d_bytes"] == 2 * (S * B * H * W * 3 * 4
                                       + B * H * W * 8)
    # the colour map (S + 1 label maps of RGB bytes), the three float32
    # maps, the GED's bool and the two float64 metrics
    assert totals["d2h_bytes"] == 2 * B * (
        (S + 1) * H * W * 3 + 3 * H * W * 4 + 1 + 2 * 8)
    assert set(tester.results_dict) == {f"{k}_{i}" for k in range(2)
                                        for i in range(B)} | {"mean"}
    # each span is an annotation of the trace, nested in its root's
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    for name in TEST2D:
        mine = sorted((e for e in events if e["name"] == name),
                      key=lambda e: e["ts"])
        assert len(mine) == summary[name]["calls"]
    roots = sorted((e for e in events if e["name"] == "test2d.batch"),
                   key=lambda e: e["ts"])
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        ann = sorted((e for e in events if e["name"] == r["name"]),
                     key=lambda e: e["ts"])[r["seq"]]
        root = roots[by_id[r["root"]]["seq"]]
        assert root["ts"] <= ann["ts"]
        assert ann["ts"] + ann["dur"] <= root["ts"] + root["dur"]


def test_tester2d_ssn_spans_and_counters(tmp_path):
    """SSN members: per member and batch one ``test2d.forward`` (the trunk
    and the heads) and one ``test2d.ssn_sample`` (the degenerate check,
    the draws, the low-rank product, the softmax); ``forwards`` counts
    the trunk passes, ``ssn_samples`` the n_pred x B samples drawn."""
    n_pred, batches = 3, 2
    tester = _Tester(tmp_path, list(_image_batches(batches)))
    cfg = _tiny_hrnet()
    cfg["MODEL"].update(SSN=True, SSN_RANK=3, SSN_EPS=1e-5)
    hparams = {"model": {"_target_": "values_tpu.models.hrnet.get_seg_model",
                         "cfg": cfg}}
    torch.manual_seed(1)
    tester.models = [tester._load_model(hparams, instantiate(make_config(
        dict(hparams["model"]))).state_dict()) for _ in range(S)]
    tester.is_ssn, tester.n_pred = True, n_pred
    _profiled(tester.predict_cases)
    recs = tracing.records()
    parents = dict(TEST2D, **{"test2d.ssn_sample": "test2d.batch"})
    assert {r["name"] for r in recs} == set(parents)
    _check_tree(recs, parents)
    summary = tracing.summary()
    for name in ("test2d.to_device", "test2d.forward", "test2d.ssn_sample"):
        assert summary[name]["calls"] == S * batches
    assert summary["test2d.ssn_sample"]["counters"] == {
        "ssn_samples": S * batches * n_pred * B}
    totals = tracing.totals()
    assert totals["forwards"] == S * batches
    assert totals["ssn_samples"] == S * batches * n_pred * B
    # the CPU draws through rsample: the card's kernels count none
    assert totals.get("ssn_fused_samples", 0) == 0
    assert totals["images"] == batches * B
    assert "graphed_forwards" not in totals
    assert len(tester.results_dict) == batches * B + 1


def test_write_seconds_is_gone():
    assert not hasattr(test_2d.Tester2D, "write_seconds")
    assert "write_seconds" not in test_2d.Tester2D.__init__.__code__.co_names


def test_profiled_writes_trace_and_spans(tmp_path, monkeypatch, capsys):
    """The operator's switch: nothing without the variable; with it, the
    Chrome trace, spans.json and the summary table."""
    with tracing.profiled():
        with tracing.span("outer"):
            pass
    assert tracing.records() == []
    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(tmp_path / "t"))
    with tracing.profiled():
        with tracing.span("outer"):
            with tracing.span("inner"):
                tracing.count("readbacks", 2)
    out = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert [r["name"] for r in out["records"]] == ["outer", "inner"]
    assert out["summary"]["inner"]["counters"] == {"readbacks": 2}
    assert out["totals"] == {"readbacks": 2}
    names = {e.get("name") for e in json.loads(
        (tmp_path / "t" / "trace.json").read_text())["traceEvents"]}
    assert {"outer", "inner"} <= names
    assert "inner" in capsys.readouterr().err


@pytest.mark.parametrize("cli", ["score", "test_3d", "test_2d", "train"])
def test_each_cli_main_is_profiled(cli, tmp_path, monkeypatch):
    """With the variable set, each CLI's main runs its work under the
    profiler: a span the work opens lands in spans.json."""
    from values_tpu_torch.inference import score as score_cli
    from values_tpu_torch.inference import test_3d
    from values_tpu_torch.training import main as train_main

    def work(*args, **kw):
        with tracing.span(f"{cli}.work"):
            pass

    argv = ["--checkpoint_paths", "none.ckpt", "--device", "cpu"]
    module, name = {"score": (score_cli, "run_score"),
                    "test_3d": (test_3d, "run_test"),
                    "test_2d": (test_2d, "run_test"),
                    "train": (train_main, "_train")}[cli]
    monkeypatch.setattr(module, name, work)
    if cli == "score":
        argv += ["--out", str(tmp_path / "scores.json")]
    if cli == "train":
        monkeypatch.setattr(train_main, "compose", lambda *a: {})
        argv = ["--device", "cpu"]
    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(tmp_path / "t"))
    module.main(argv)
    out = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert [r["name"] for r in out["records"]] == [f"{cli}.work"]
