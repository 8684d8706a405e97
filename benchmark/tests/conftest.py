"""Small sizes of the benchmark's cells, for runs on the CPU."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def small_unet(cfg, trf, patch=16, members=2):
    cfg["data"]["patch_size"] = patch
    cfg["model"]["initial_filter_size"] = 4
    if "scoring" in cfg:
        cfg["scoring"]["members"] = members
        cfg["scoring"]["agg_patch"] = 4
    trf.update(batch=2, pool_batches=3, reference_block=2, check_batches=2,
               warmup_batches=1, warmup_steps=4, check_step=[0, 2])


def small_hrnet(cfg, trf):
    extra = cfg["model"]["cfg"]["MODEL"]["EXTRA"]
    extra["STAGE1"].update(NUM_BLOCKS=[1], NUM_CHANNELS=[8])
    for k in ("STAGE2", "STAGE3", "STAGE4"):
        s = extra[k]
        s.update(NUM_MODULES=1, NUM_BLOCKS=[1] * s["NUM_BRANCHES"],
                 NUM_CHANNELS=[c // 8 for c in s["NUM_CHANNELS"]])
    cfg["data"].update(height=32, width=48)
    cfg["testing"]["members"] = 2
    trf.update(batch=2, pool_batches=3, calibration_images=2,
               check_batches=2, warmup_batches=1)


SMALL = {"scorer": small_unet, "train_step": small_unet,
         "tester2d": small_hrnet}


def small(workload: str):
    """The cell's configuration and traffic at a size the CPU holds."""
    bench = harness.load_benchmark()
    _, cfg, trf = harness.resolve(bench, workload)
    cfg, trf = copy.deepcopy(cfg), copy.deepcopy(trf)
    SMALL[trf["driver"]](cfg, trf)
    return bench, cfg, trf


def run_small(workload: str, seed: int = 2 ** 31 + 11, seconds=0.3,
              control=False):
    bench, cfg, trf = small(workload)
    return harness.run_cell(bench, workload, seed, seconds, False,
                            device="cpu", config=cfg, traffic=trf,
                            control=control, log=lambda m: None)


@pytest.fixture
def bench():
    return harness.load_benchmark()
