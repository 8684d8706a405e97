"""The output check at a small size on the CPU: sound runs come out
correct, and runs with the timed path broken underneath
(``benchmark/faults.py``), or with the lower-precision control in the
program's place, come out not correct, each held to the cell's own
limits."""
import pytest

from benchmark.faults import FAULTS
from conftest import run_small, small

CELLS = ["unet3d-ens5-score-b32-bf16", "unet3d-train-b8-f32",
         "hrnet-w48-ens5-test2d-b6-f32"]
CASES = [(w, f) for w in CELLS
         for f in FAULTS[small(w)[2]["driver"]]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run_small(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = run_small(workload, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    with FAULTS[small(workload)[2]["driver"]][fault]():
        out = run_small(workload)
    assert not out["correct"], out["checks"]
    if fault == "state_unchanged":       # no leaf moved: the gap reads 1
        for name in ("change_gap", "step_change_gap"):
            assert out["checks"][name]["value"] == pytest.approx(1.0)
    if fault in ("dice_no_ignore", "ged_one_member"):
        name = fault.split("_")[0] + "_gap"
        assert (out["checks"][name]["value"]
                > out["checks"][name]["limit"]), out["checks"]


def test_training_check_holds_a_window_step():
    """The training check holds one step inside the measured window, and
    fails where the window ends before it."""
    out = run_small("unet3d-train-b8-f32")
    for name in ("step_loss_gap", "step_grad_gap", "step_change_gap"):
        assert name in out["checks"]
    bench, cfg, trf = small("unet3d-train-b8-f32")
    trf["check_step"] = [10 ** 6, 10 ** 6 + 1]
    from benchmark import harness
    out = harness.run_cell(bench, "unet3d-train-b8-f32", 3, 0.2, False,
                           device="cpu", config=cfg, traffic=trf,
                           log=lambda m: None)
    assert not out["correct"]
    assert out["checks"]["step_loss_gap"]["value"] == float("inf")
