"""Work counted from shapes against hand values; the rates and the tail
over every step of a window; the trace's reading of a window."""
import math
from types import SimpleNamespace

import pytest

from benchmark import flops, readers, trace
from benchmark.harness import Step, Window


def test_conv_counts_by_hand():
    convs = flops.unet3d_convs(64, 8, 1, 5)
    assert [c.name for c in convs][:2] == ["contr_1_1", "contr_1_2"]
    assert len(convs) == 18
    # expand_1_1 at batch 32: 16 + ... split input 8 + 8 -> 8, 5 groups
    e11 = next(c for c in convs if c.name == "expand_1_1")
    assert (e11.d, e11.cin1, e11.cin2, e11.cout) == (64, 8, 8, 8)
    vox = 32 * 64 ** 3
    assert flops.conv_flops(e11, 32) == 2 * vox * 27 * 16 * 8 * 5
    assert flops.conv_bytes(e11, 32, "bfloat16") == \
        2 * (vox * 5 * (8 + 8 + 8) + 27 * 16 * 8 * 5)
    # the first conv: one input channel a member
    c11 = convs[0]
    assert flops.conv_flops(c11, 1) == 2 * 64 ** 3 * 27 * 1 * 8 * 5
    # dx of expand_1_1 at batch 8, float32: dy, y, dy' and dx, the weight
    one = flops.unet3d_convs(64, 8, 1, 1)
    e = next(c for c in one if c.name == "expand_1_1")
    assert flops.dx_bytes(e, 8, "float32") == \
        4 * (8 * 64 ** 3 * (3 * 8 + 16) + 27 * 16 * 8)


def test_model_flops_by_hand():
    # one member at 64^3 with 8 filters: 7.523 GFLOP; five 37.62
    assert flops.unet3d_flops(64, 8, 1, 2, 5) == pytest.approx(
        37.617664e9, rel=1e-12)
    assert flops.unet3d_flops(64, 8, 1, 2, 5) == \
        5 * flops.unet3d_flops(64, 8, 1, 2, 1)


def test_least_time_takes_the_larger_bound():
    assert flops.least_seconds(3.35e12, 0.0, 989e12) == 1.0
    assert flops.least_seconds(0.0, 989e12, 989e12) == 1.0
    convs = flops.unet3d_convs(64, 8, 1, 5)
    assert flops.k1_least_seconds(convs, 32, "bfloat16") == \
        pytest.approx(2.315e-3, rel=1e-3)        # PERF.md's K1 bound


def _window(ms, units=32):
    t, steps = 100.0, []
    for m in ms:
        steps.append(Step(t, t + m / 1e3, units, 0))
        t += m / 1e3
    return Window(100.0, t, steps)


def test_rate_and_tail_over_every_step():
    ms = [10.0] * 99 + [1000.0]             # one stall in 100 batches
    run = SimpleNamespace(window=_window(ms))
    assert readers.rate(run) == pytest.approx(3200 / 1.99)
    assert readers.p95_ms(run) == pytest.approx(10.0)
    ms = [10.0] * 90 + [500.0] * 10         # a tenth of the batches stall
    run = SimpleNamespace(window=_window(ms))
    assert readers.p95_ms(run) == pytest.approx(500.0)
    assert readers.rate(run) == pytest.approx(3200 / 5.9)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_window_busy_gaps_and_records():
    k1 = "void conv3d_mma_kernel<__nv_bfloat16, 8, false>(Args)"
    dx = "void conv3d_mma_kernel<float, 8, true>(Args)"
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 1000),
        _ev("kernel", k1, 100, 200), _ev("kernel", k1, 250, 150),
        _ev("kernel", dx, 600, 100), _ev("gpu_memcpy", "Memcpy HtoD", 800,
                                          100),
        _ev("cpu_op", "aten::copy_", 0, 1000),
        _ev("cpu_op", "aten::item", 420, 170),
        _ev("cuda_runtime", "cudaLaunchKernel", 90, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 240, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 590, 5),
        _ev("kernel", k1, 2000, 100),            # outside the window
    ]
    t = trace.parse(events, steps=1, units=8, counted={"conv3d_fused": 3})
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(500e-6)     # 100-400, 600-700, 800-900
    assert t.launches == 3 and len(t.kernels) == 3 and t.complete
    assert dict(t.idle_gaps) == pytest.approx(
        {"aten::copy_": 300e-6, "aten::item": 200e-6})
    assert t.device_ops[0][0] == k1
    short = trace.parse(events, 1, 8, {"conv3d_fused": 4})
    assert not short.complete
    run = SimpleNamespace(trace=short, work={"k1_least_s_per_step": 1e-4})
    assert readers.roofline_percent(run, "k1_least_s_per_step",
                                    readers.k1_forward) is None
    run = SimpleNamespace(trace=t, work={"k1_least_s_per_step": 1e-4,
                                         "dx_least_s_per_step": 5e-5})
    assert readers.roofline_percent(run, "k1_least_s_per_step",
                                    readers.k1_forward) == \
        pytest.approx(100 * 1e-4 / 350e-6)
    assert readers.roofline_percent(run, "dx_least_s_per_step",
                                    trace.is_dx) == pytest.approx(50.0)
    assert readers.idle_percent(run) == pytest.approx(50.0)
    assert readers.launches_per_unit(run) == pytest.approx(3 / 8)
    assert not math.isnan(readers.idle_percent(run))


def test_profiler_events_read_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile, record_function
    import torch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            torch.ones(64, 64) @ torch.ones(64, 64)
    t = trace.parse(trace._events(prof), steps=1, units=1, counted={})
    assert t.window_s > 0 and t.busy_s == 0 and t.kernels == []
    assert t.complete and t.idle_gaps[0][0].startswith("aten::")
