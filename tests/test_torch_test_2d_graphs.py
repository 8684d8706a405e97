"""The 2D tester's CUDA graphs (``Tester2D._forward``, ``GraphedPass``):
which passes take a graph and what the tester counts, on the CPU; and on
the card (``cuda`` marker, skipped without one) that a replay gives the
eager pass's softmax, once captured per model and batch shape, as a
tensor of its own, while MC dropout stays eager on the generator's draws.
No JAX here, so the file runs on the card's machine: ``python -m pytest
tests/test_torch_test_2d_graphs.py -m cuda``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu_torch.core import tracing
from values_tpu_torch.inference import test_2d as P
from values_tpu_torch.models.hrnet import HighResolutionNet

C, H, W, IGNORE = 5, 32, 48, 255


def _cfg(dropout_final=False, ssn=False):
    """A small HRNet (tests/test_hrnet.py's widths)."""
    def stage(branches, block="BASIC"):
        return {"NUM_MODULES": 1, "NUM_BRANCHES": branches, "BLOCK": block,
                "NUM_BLOCKS": [2] * branches,
                "NUM_CHANNELS": [4 * 2 ** i for i in range(branches)],
                "DROPOUT": [False] * branches, "FUSE_METHOD": "SUM"}
    extra = {"FINAL_CONV_KERNEL": 1,
             "STAGE1": dict(stage(1, "BOTTLENECK"), NUM_CHANNELS=[8]),
             "STAGE2": stage(2), "STAGE3": stage(3), "STAGE4": stage(4)}
    if dropout_final:
        extra["DROPOUT_FINAL"] = True
    model = {"NAME": "hrnet", "INPUT_CHANNELS": 3, "EXTRA": extra}
    if ssn:
        model.update({"SSN": True, "SSN_RANK": 3, "SSN_EPS": 1e-5})
    return {"MODEL": model, "DATASET": {"NUM_CLASSES": C}}


def _model(seed=0, device="cpu", **kw):
    """An eval-mode HRNet with random BN running statistics, channels-last
    on the card as ``Tester2D._load_model`` makes it."""
    torch.manual_seed(seed)
    model = HighResolutionNet(_cfg(**kw)).eval()
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.normal_(0.0, 0.1)
        elif name.endswith("running_var"):
            buf.uniform_(0.5, 1.5)
    model = model.to(device)
    if device == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _tester(models, device, tmp_path, n_pred=1, tta=False, sliding=None):
    """A Tester2D over ``models`` with no checkpoint or dataset: the
    attributes ``__init__`` would set."""
    t = object.__new__(P.Tester2D)
    t.device = torch.device(device)
    t.models, t.is_ssn = models, models[0].ssn
    t.tta, t.n_pred, t.dtype, t.ignore_index = tta, n_pred, torch.float32, \
        IGNORE
    t.generator = torch.Generator(t.device).manual_seed(123)
    t.sliding_window, t.sliding_overlap, t._sliding = sliding, 0.0, {}
    t._colors = torch.from_numpy(P._color_table()).to(t.device)
    t.results_dict = {}
    t.save_dir = str(tmp_path)
    t.save_pred_dir = str(tmp_path / "pred_seg")
    (tmp_path / "pred_seg").mkdir()
    return t


def _batches(sizes, tta=False, seed=0):
    """Host batches as the GTA loader gives them; the last may be
    smaller. With ``tta``, each item holds 4 variants, the second
    flipped."""
    rng = np.random.RandomState(seed)
    out = []
    for k, b in enumerate(sizes):
        seg = rng.randint(0, C, size=(b, H, W))
        seg[:, :2] = IGNORE
        if tta:
            data = [rng.randn(4, H, W, 3).astype(np.float32)
                    for _ in range(b)]
            extra = {"transforms": [[[], ["HorizontalFlip"], [], []]]}
        else:
            data, extra = rng.randn(b, H, W, 3).astype(np.float32), {}
        out.append(dict(extra, data=data, seg=seg, dataset=["gta"] * b,
                        image_id=[f"{k}_{i}" for i in range(b)]))
    return out


def _counted(tester):
    """The tester's ``forwards`` and ``graphed_forwards`` over one
    ``predict_cases`` under a profiler."""
    activities = [ProfilerActivity.CPU]
    if tester.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    tracing.reset()
    try:
        with profile(activities=activities):
            tester.predict_cases()
        totals = tracing.totals()
    finally:
        tracing.reset()
    return totals.get("forwards", 0), totals.get("graphed_forwards", 0)


RULE = {
    # case: (device, model kwargs, sliding window, training, graphed)
    "eval softmax on the card": ("cuda", {}, None, False, True),
    "cpu": ("cpu", {}, None, False, False),
    "dropout_final": ("cuda", {"dropout_final": True}, None, False, False),
    "ssn": ("cuda", {"ssn": True}, None, False, False),
    "sliding window": ("cuda", {}, (16, 24), False, False),
    "training": ("cuda", {}, None, True, False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_which_passes_take_a_graph(case):
    device, kw, sliding, training, graphed = RULE[case]
    with torch.device("meta"):
        model = HighResolutionNet(_cfg(**kw)).train(training)
    tester = object.__new__(P.Tester2D)
    tester.sliding_window = sliding
    assert tester._takes_graph(model, torch.device(device)) is graphed


COUNTS = {
    # case: (model kwargs, members, passes a member, n_pred, tta, sliding)
    "ensemble": ({}, 2, 1, 1, False, None),
    "n_pred": ({}, 1, 2, 2, False, None),
    "tta": ({}, 1, 4, 1, True, None),
    "dropout_final": ({"dropout_final": True}, 1, 3, 3, False, None),
    # an SSN member: one trunk pass a batch, its samples drawn after it
    "ssn": ({"ssn": True}, 1, 1, 2, False, None),
    "sliding window": ({}, 1, 2, 2, False, (16, 24)),
}


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_counters_on_the_cpu(case, tmp_path):
    """``forwards`` counts every pass of a model: members x passes x
    batches (an SSN member's samples are no passes); no pass on the CPU
    replays a graph."""
    kw, members, passes, n_pred, tta, sliding = COUNTS[case]
    models = [_model(seed=m, **kw) for m in range(members)]
    tester = _tester(models, "cpu", tmp_path, n_pred=n_pred, tta=tta,
                     sliding=sliding)
    tester.test_dataloader = _batches([2, 1], tta=tta)
    assert _counted(tester) == (members * passes * 2, 0)
    assert "_graphs" not in tester.__dict__
    assert len(tester.results_dict) == 3 + 1  # 3 images and the mean


# ---------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _x(batch, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, 3, H, W), generator=g).cuda().contiguous(
        memory_format=torch.channels_last)


# precision: (cuDNN's TF32, model type, tolerance on the probabilities)
PRECISIONS = {"fp32": (False, torch.float32, 1e-6),
              "tf32": (True, torch.float32, 1e-3),
              "bf16": (True, torch.bfloat16, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_replay_matches_the_eager_pass(precision, tmp_path):
    """The first (capturing) and a later pass against the eager softmax:
    within 1e-6 with cuDNN's TF32 off, 1e-3 with it on, 1e-2 for a
    bfloat16 model (whose float32 cast the graph holds)."""
    _card()
    tf32, dtype, tol = PRECISIONS[precision]
    model = _model(device="cuda").to(dtype)
    tester = _tester([model], "cuda", tmp_path)
    x = _x(2).to(dtype)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.inference_mode():
            want = tester._softmax(model, x)
            got = [tester._forward(model, x) for _ in range(2)]
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert len(tester._graphs) == 1
    for g in got:
        assert g.shape == want.shape and g.dtype == torch.float32
        assert float((g - want).abs().max()) <= tol


@pytest.mark.cuda
def test_each_batch_shape_is_captured_once(tmp_path):
    """Batches of 2 and 1 get a graph each, captured on their first pass
    and replayed after; every pass matches the eager softmax of its own
    input, TF32 off."""
    _card()
    model = _model(device="cuda")
    tester = _tester([model], "cuda", tmp_path)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            for seed, batch in enumerate((2, 1, 2, 1)):
                x = _x(batch, seed)
                got = tester._forward(model, x)
                if seed == 1:
                    first = dict(tester._graphs)
                assert float((got - tester._softmax(model, x)).abs().max()
                             ) <= 1e-6
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert sorted(key[1][0] for key in tester._graphs) == [1, 2]
    assert all(tester._graphs[k] is v for k, v in first.items())
    assert len(tester._graphs) == len(first)


@pytest.mark.cuda
def test_each_pass_returns_a_tensor_of_its_own(tmp_path):
    """n_pred = 2: two equal softmaxes in two buffers, which a replay on
    another input leaves as they were; ``predict_cases`` over two members
    and a smaller last batch replays every pass."""
    _card()
    models = [_model(seed=m, device="cuda") for m in range(2)]
    tester = _tester(models, "cuda", tmp_path, n_pred=2)
    with torch.inference_mode():
        a, b = (tester._forward(models[0], _x(2)) for _ in range(2))
        kept = a.clone()
        tester._forward(models[0], _x(2, seed=1))
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    assert torch.equal(a, kept)
    tester.test_dataloader = _batches([2, 1])
    assert _counted(tester) == (2 * 2 * 2, 2 * 2 * 2)
    assert len(tester._graphs) == 2 * 2
    assert len(tester.results_dict) == 3 + 1


@pytest.mark.cuda
def test_dropout_final_stays_eager_on_the_generator(tmp_path):
    """A DROPOUT_FINAL model captures no graph and draws the masks that
    its eager forward draws from a generator of the same seed, pass after
    pass."""
    _card()
    model = _model(device="cuda", dropout_final=True)
    tester = _tester([model], "cuda", tmp_path, n_pred=2)
    twin = torch.Generator("cuda").manual_seed(123)
    x = _x(2)
    with torch.inference_mode():
        got = [tester._forward(model, x) for _ in range(2)]
        want = [torch.softmax(model(x, generator=twin), dim=1)
                for _ in range(2)]
    assert "_graphs" not in tester.__dict__
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], got[1])
    assert torch.equal(tester.generator.get_state(), twin.get_state())
