"""Run one cell of the benchmark once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (weights and inputs made from the seed, the program's objects,
warm-up of the cell's shapes) is timed from the process's start; then,
with ``--trace 1``, a profiled window of a few steps; then the measured
window of ``--seconds``; then the output check against the plain
reference. The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; the same numbers close standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when the repository's program is missing, or
when the JAX package or JAX is loaded in the process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel caches live at fixed paths inside the checkout
CACHE = ROOT / "build" / "bench_cache"
os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))


def fail(msg: str, code: int) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    bench = harness.load_benchmark(ROOT)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no workload {args.workload!r}", 2)
    if not (ROOT / "values_tpu_torch").is_dir():
        fail("the program (values_tpu_torch) is not in this checkout", 2)
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             " (no CPU fallback)", 3)
    card = harness.card()
    print(f"card: {card['kind']} x {card['count']}, power limit "
          f"{card['power_limit']}", file=sys.stderr, flush=True)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"the JAX side was loaded in this process: {loaded}", 4)
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
