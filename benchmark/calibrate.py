"""The readings that a cell's limits are set from, on the card, in one
process: the output check of the program over many seeds, and of the
lower-precision control over a few; or, with ``--fault``, of the program
with a fault of ``faults.py`` planted.

    python3 benchmark/calibrate.py --workload <name> --seconds 3 \\
        --seeds 11 12 ... --control-seeds 21 22 23 [--control-seconds 10]

Each seed is one run of the cell as ``run.py`` makes it (set-up, a short
window at the cell's own load, the check), with the control in the
program's place for the control seeds. Prints one JSON line per seed
with every number the check read, held or logged, and then the largest
program reading and the smallest control reading of each. The
benchmark's own runs never run the control or a fault.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(bench, workload: str, seed: int, seconds: float,
             control: bool, fault: str = None):
    from benchmark import harness
    from benchmark.faults import FAULTS
    driver = harness.resolve(bench, workload, ROOT)[2]["driver"]
    planted = (FAULTS[driver][fault]() if fault
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with planted:
        out = harness.run_cell(bench, workload, seed, seconds, False,
                               control=control, root=ROOT)
    return {"seed": seed, "control": control, "fault": fault,
            "attempted": out["attempted"],
            "run_s": round(time.perf_counter() - t0, 3),
            "correct": out["correct"],
            **{k: v["value"] for k, v in out["checks"].items()},
            **out["logged"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="the control's window (default --seconds)")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default=None,
                    help="a fault of benchmark/faults.py planted in the "
                         "program for the --seeds runs")
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    bench = harness.load_benchmark(ROOT)
    control_s = (args.seconds if args.control_seconds is None
                 else args.control_seconds)
    rows = []
    for seed, control in ([(s, False) for s in args.seeds]
                          + [(s, True) for s in args.control_seeds]):
        rows.append(readings(bench, args.workload, seed,
                             control_s if control else args.seconds,
                             control, None if control else args.fault))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    skip = ("seed", "control", "fault", "attempted", "run_s", "correct")
    summary = {}
    for k in (k for k in rows[0] if k not in skip):
        prog = [r[k] for r in rows if not r["control"]]
        ctl = [r[k] for r in rows if r["control"]]
        summary[k] = {"program_max": max(prog) if prog else None,
                      "control_min": min(ctl) if ctl else None}
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "summary": summary}))


if __name__ == "__main__":
    main()
