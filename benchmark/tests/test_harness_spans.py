"""The readers of the program's spans and counters (``spans.py`` and the
metrics that use it): nothing to read without a root span; per call of
the root span from a recorded CPU run; the retaken windows normalised
away."""
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, spans
from conftest import small

SPAN_METRICS = ("forward_ms.score", "c3_ms.score", "forward_ms.train",
                "backward_ms.train", "optimizer_ms.train",
                "step_host_ms.train", "forward_ms.2d", "forward_host_ms.2d",
                "process_output_ms.2d", "readbacks_per_image.2d")


@pytest.fixture(autouse=True)
def fresh():
    from values_tpu_torch.core import tracing
    tracing.reset()
    yield
    tracing.reset()


def _read(name):
    return harness.reader("metrics", name).read(None)


def test_nothing_recorded_reads_none(monkeypatch):
    for name in SPAN_METRICS:
        assert _read(name) is None
    # a program without the recorder: the import fails, nothing is read
    monkeypatch.setitem(sys.modules, "values_tpu_torch.core.tracing", None)
    for name in SPAN_METRICS:
        assert _read(name) is None


def _cpu_windows(workload, windows, steps):
    """The cell's driver at its small size on the CPU, then ``windows``
    profiled windows of ``steps`` steps, as the traced run retakes one."""
    from types import SimpleNamespace
    _, cfg, trf = small(workload)
    drv = harness.driver(trf["driver"])
    ctx = SimpleNamespace(config=cfg, traffic=trf, seed=2 ** 31 + 3,
                          device=torch.device("cpu"), control=False,
                          log=lambda m: None)
    state = drv.setup(ctx)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU]):
            drv.window(state, harness.for_steps(steps))


def test_train_step_per_call_from_a_recorded_run():
    from values_tpu_torch.core import tracing
    _cpu_windows("unet3d-train-b8-f32", 2, 2)
    recs = [r for r in tracing.records() if r["name"] == "train_step"]
    assert len(recs) == 4
    assert _read("step_host_ms.train") == pytest.approx(
        sum(r["host_ms"] for r in recs) / 4)
    # no card: no stream time, so the device readers read nothing
    for name in ("forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train"):
        assert _read(name) is None


def test_tester2d_per_batch_from_a_recorded_run():
    from values_tpu_torch.core import tracing
    _cpu_windows("hrnet-w48-ens5-test2d-b6-f32", 1, 2)
    recs = tracing.records()
    batches = sum(r["name"] == "test2d.batch" for r in recs)
    assert batches == 2
    assert _read("forward_host_ms.2d") == pytest.approx(sum(
        r["host_ms"] for r in recs if r["name"] == "test2d.forward") / 2)
    # per image: the GED's ignore check, two metrics, the colour map and
    # the three uncertainty maps
    assert _read("readbacks_per_image.2d") == 7
    assert _read("forward_ms.2d") is None


def test_stream_time_per_root_call(monkeypatch):
    """Two windows' worth of scored batches: the sums over the calls are
    taken per call of the root span."""
    from values_tpu_torch.core import tracing
    summary = {"score": {"calls": 8, "host_ms": 400.0, "stream_ms": 420.0},
               "score.forward": {"calls": 8, "host_ms": 9.0,
                                 "stream_ms": 200.0},
               "score.c3": {"calls": 8, "host_ms": 2.0, "stream_ms": 28.0}}
    monkeypatch.setattr(tracing, "summary", lambda: summary)
    assert _read("forward_ms.score") == 25.0
    assert _read("c3_ms.score") == 3.5
    assert spans.per_root("score", "score", "host_ms") == 50.0
    assert spans.per_root("train_step", "train_step.forward") is None
