"""The sampled cells, the SSN HRNet's 2D test and the aleatoric-head
ensemble's scoring: found from their files alone; their work counted by
hand; their output checks at a small size on the CPU, where sound runs
come out correct and the lower-precision controls and the planted faults
(``benchmark/faults_sampled.py``) do not."""
import copy
import math

import pytest
import torch

from benchmark import counts, harness, spans
from benchmark.faults_sampled import FAULTS
from benchmark.flops import conv2d_flops_hook
from benchmark.reference import hrnet as ref_hrnet
from benchmark.reference import hrnet_ssn
from conftest import small_hrnet, small_unet

SSN = "hrnet-w48-ssn10-test2d-b6-f32"
ALEA = "unet3d-ens5-alea-b32-bf16"
CELLS = [SSN, ALEA]
CASES = [(w, f) for w in CELLS
         for f in FAULTS[harness.resolve(harness.load_benchmark(), w)[2]
                         ["driver"]]]


def small(workload):
    """The cell's configuration and traffic at a size the CPU holds."""
    bench = harness.load_benchmark()
    _, cfg, trf = harness.resolve(bench, workload)
    cfg, trf = copy.deepcopy(cfg), copy.deepcopy(trf)
    if workload == SSN:
        small_hrnet(cfg, trf)
        cfg["testing"]["members"] = 1
    else:
        small_unet(cfg, trf)
    return bench, cfg, trf


def run_small(workload, seed=2 ** 31 + 11, control=False):
    bench, cfg, trf = small(workload)
    return harness.run_cell(bench, workload, seed, 0.3, False, device="cpu",
                            config=cfg, traffic=trf, control=control,
                            log=lambda m: None)


def test_cells_found_from_files_alone(bench):
    for workload in CELLS:
        cell, cfg, trf = harness.resolve(bench, workload)
        drv = harness.driver(trf["driver"])
        for fn in ("setup", "window", "work", "check"):
            assert callable(getattr(drv, fn))
        for kind, folder in (("end_to_end", "end_to_end"),
                             ("per_layer", "metrics")):
            names = [m["name"] for m in harness.cell_metrics(bench, workload,
                                                             kind)]
            assert names
            for name in names:
                assert harness.reader(folder, name).read
        assert cfg["reduced"] == [] and cell["chips"] == 1
    e2e = [m["name"] for m in harness.cell_metrics(bench, SSN, "end_to_end")]
    assert e2e == ["tested_images_per_s", "setup_s"]
    e2e = [m["name"] for m in harness.cell_metrics(bench, ALEA,
                                                   "end_to_end")]
    assert e2e == ["scored_volumes_per_s", "score_batch_ms_p95", "setup_s"]


def test_ssn_configuration_is_the_published_one(bench):
    """HRNetV2-W48's trunk as the softmax cell runs it, the SSN head of
    hrnet_config_ssn.yaml, gta_ssn_config.yaml's 10 samples, batch 6 at
    256 x 478."""
    _, cfg, trf = harness.resolve(bench, SSN)
    _, plain, _ = harness.resolve(bench, "hrnet-w48-ens5-test2d-b6-f32")
    model = cfg["model"]["cfg"]["MODEL"]
    assert (model["SSN"], model["SSN_RANK"], model["SSN_EPS"]) == \
        (True, 10, 1e-5)
    assert model["EXTRA"] == plain["model"]["cfg"]["MODEL"]["EXTRA"]
    assert cfg["model"]["cfg"]["DATASET"]["NUM_CLASSES"] == 24
    assert (cfg["data"]["height"], cfg["data"]["width"], trf["batch"]) == \
        (256, 478, 6)
    assert (cfg["testing"]["members"], cfg["testing"]["n_pred"],
            cfg["testing"]["dtype"]) == (1, 10, "float32")


def test_counts_by_hand():
    # the sampling stage: mean, diagonal, factor (R) read, S samples
    # written, float32, at B 6, N = 24 x 256 x 478
    n = 24 * 256 * 478
    assert counts.ssn_sample_bytes(6, 24, 256, 478, 10, 10) == \
        4 * 6 * n * (2 + 10 + 10) == 1_550_647_296
    assert counts.ssn_sample_least_seconds(6, 24, 256, 478, 10, 10) == \
        pytest.approx(0.463e-3, rel=1e-3)
    # the factor head at 64 x 120: 720 -> 720 -> 240 1x1 convs
    assert counts.ssn_factor_head_flops(256, 478, 720, 24, 10) == \
        2 * 64 * 120 * 720 * (720 + 240) == pytest.approx(10.6e9, rel=2e-3)
    # K3 at the scorer's shape: PERF.md's 51.9 G operations, 0.774 ms
    n = 32 * 64 ** 3
    draw = 21 * 2 + 2 * (4 + 2 + (1 - 0.0485) * 24 + 0.0485 * 27 + 2) \
        + 9 * 2 - 1
    assert counts.k3_operations(n, 5, 2, 10) == pytest.approx(
        n * 5 * (10 * draw + 4))
    assert counts.k3_operations(n, 5, 2, 10) == pytest.approx(51.9e9,
                                                              rel=1e-3)
    assert counts.k3_bytes(n, 5, 2) == 2 * 2 * n * 5 * 2 + 4 * 3 * n
    assert counts.k3_least_seconds(n, 5, 2, 10) == pytest.approx(
        0.774e-3, rel=1e-3)
    assert counts.is_k3("void sampled_stats_c2_kernel<false, true, "
                        "__nv_bfloat16>(Args)")
    assert not counts.is_k3("void fused_entropy_kernel<float>(Args)")


def test_factor_head_flops_are_the_convs():
    """What the SSN's convs add over the plain HRNet, counted by the hook
    at a small size, is the factor head's count."""
    _, cfg, _ = small(SSN)
    model_cfg = cfg["model"]["cfg"]
    x = torch.randn(1, 3, 32, 48)
    got = []
    for net in (ref_hrnet.HRNet(model_cfg), hrnet_ssn.HRNetSSN(model_cfg)):
        counter = {"flops": 0.0}
        for mod in net.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.register_forward_hook(conv2d_flops_hook(counter))
        with torch.no_grad():
            if isinstance(net, hrnet_ssn.HRNetSSN):
                net.eval().distribution(x)
            else:
                net.eval()(x)
        got.append(counter["flops"])
    width = sum(model_cfg["MODEL"]["EXTRA"]["STAGE4"]["NUM_CHANNELS"])
    assert got[1] - got[0] == counts.ssn_factor_head_flops(32, 48, width,
                                                           24, 10)


def test_span_readers_read_per_batch(monkeypatch):
    """The SSN cell's span metrics, per tested batch; nothing recorded
    (the parent's program has no ``test2d.ssn_sample``) reads None."""
    from values_tpu_torch.core import tracing
    monkeypatch.setattr(tracing, "summary", lambda: {})
    for name in ("forward_ms.ssn", "ssn_sample_ms.ssn",
                 "ssn_sample_roofline.ssn", "process_output_ms.ssn"):
        assert harness.reader("metrics", name).read(None) is None
    summary = {"test2d.batch": {"calls": 2, "stream_ms": 300.0},
               "test2d.forward": {"calls": 2, "stream_ms": 60.0},
               "test2d.ssn_sample": {"calls": 2, "stream_ms": 10.0},
               "test2d.process_output": {"calls": 2, "stream_ms": 220.0}}
    monkeypatch.setattr(tracing, "summary", lambda: summary)
    run = type("Run", (), {"work": {"ssn_sample_least_s_per_batch":
                                    0.463e-3}})()
    read = {name: harness.reader("metrics", name).read(run)
            for name in ("forward_ms.ssn", "ssn_sample_ms.ssn",
                         "ssn_sample_roofline.ssn", "process_output_ms.ssn")}
    assert read == pytest.approx({"forward_ms.ssn": 30.0,
                                  "ssn_sample_ms.ssn": 5.0,
                                  "ssn_sample_roofline.ssn": 9.26,
                                  "process_output_ms.ssn": 110.0})
    assert spans.per_root("test2d.batch", "test2d.ssn_sample") == 5.0


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run_small(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if workload == SSN:
        assert out["logged"]["degenerate"] == 0
        for key in ("factor_to_diag_min", "factor_to_diag_max"):
            assert 0.1 < out["logged"][key] < 10
        assert math.isfinite(out["checks"]["alea_gap"]["value"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The SSN's control: its trunk and heads in bfloat16; the aleatoric
    scorer's: the reference in float8."""
    out = run_small(workload, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    driver = small(workload)[2]["driver"]
    with FAULTS[driver][fault]():
        out = run_small(workload)
    assert not out["correct"], out["checks"]
    if fault == "unswapped":        # the maps, not the labels, fail it
        for name in ("alea_gap", "epi_gap"):
            assert (out["checks"][name]["value"]
                    > out["checks"][name]["limit"]), out["checks"]
