"""One run of one cell: set-up, an optional profiled window, the measured
window, the output check, the metrics, and the result line.

Everything is found by name. A cell (``workloads`` in ``BENCHMARK.json``)
names its configuration (``configs``, whose ``file`` holds it) and its
traffic, ``traffic/<traffic>.json``, which names the driver,
``drivers/<driver>.py``, its parameters and the limits of its output
check. An end-to-end metric is read by ``end_to_end/<name>.py`` and a
per-layer metric by ``metrics/<name>.py``; each has ``read(run)``, which
returns a number or None when it finds nothing to read.

A driver module has:

- ``setup(ctx)``: the program's objects, weights and input pool, made
  from ``ctx.seed``, and its warm-up; returns the driver's state;
- ``window(state, stop)``: steps until ``stop(steps_done, start)`` says
  so; returns a :class:`Window`;
- ``work(state)``: the shapes' work that the per-layer readers take
  (``flops_per_unit``, ``peak_flops``, least seconds of a step's
  kernels);
- ``check(state)``: once the window has closed, frees the program's
  state and compares what the window produced with the reference;
  returns ``{name: value}``; those the traffic names in ``limits`` are
  held against their limit, the others only logged.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, Dict, List, NamedTuple, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the JAX package and its libraries, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "values_tpu")


class Step(NamedTuple):
    start: float          # host clock, seconds
    end: float
    units: int            # volumes, images or trained volumes
    failed: int


class Window(NamedTuple):
    start: float
    end: float
    steps: List[Step]

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def units(self) -> int:
        return sum(s.units for s in self.steps)

    @property
    def failed(self) -> int:
        return sum(s.failed for s in self.steps)


def loop(step: Callable[[int], Step], stop) -> Window:
    """Call ``step(i)`` for i = 0, 1, ... until ``stop(i, start)``."""
    steps: List[Step] = []
    start = time.perf_counter()
    while not stop(len(steps), start):
        steps.append(step(len(steps)))
    return Window(start, time.perf_counter(), steps)


def for_seconds(seconds: float):
    return lambda n, start: time.perf_counter() - start >= seconds


def for_steps(count: int):
    return lambda n, start: n >= count


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "benchmark._found." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / BENCH_DIR.name / "drivers" / f"{name}.py")


def reader(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / BENCH_DIR.name / kind / f"{name}.py")


def resolve(bench: Dict, workload: str, root: Path = ROOT):
    """The cell, its configuration and its traffic, by name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / entry["file"]) as fh:
        config = json.load(fh)
    with open(root / BENCH_DIR.name / "traffic"
              / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)
    return cell, config, traffic


def cell_metrics(bench: Dict, workload: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> Dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    import torch
    out = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        out["power_limit"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return out


def run_cell(bench: Dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None,
             control: bool = False, log=None, root: Path = ROOT,
             config: Optional[Dict] = None, traffic: Optional[Dict] = None
             ) -> Dict:
    """One run of ``workload``; returns the result line's dict: ``setup``
    says whether set-up built the program's kernels, ``logged`` holds the
    check's readings that have no limit, ``checks`` comes last.
    ``config`` and ``traffic`` replace the cell's files (a test at a
    small size); ``control`` runs the driver's lower-precision control
    in the program's place."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, trf = resolve(bench, workload, root)
    cfg, trf = config or cfg, traffic or trf
    drv = driver(trf["driver"], root)
    ctx = SimpleNamespace(config=cfg, traffic=trf, seed=int(seed),
                          device=torch.device(device), control=control,
                          log=log)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    built = _libraries(root)
    state = drv.setup(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    # a set-up that built the program's kernels is a cold one
    compiled = sorted(_libraries(root) - built)
    log(f"set-up {setup_s:.3f} s"
        + (f", cold: built {', '.join(compiled)}" if compiled else ", warm"))
    prof = None
    if trace:
        prof = _profiled(drv, state, int(trf.get("trace_steps", 4)), log)
    window = drv.window(state, for_seconds(seconds))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated()
            if ctx.device.type == "cuda" else 0)
    log(f"window {window.seconds:.3f} s: {len(window.steps)} steps, "
        f"{window.units} units, {window.failed} failed; {_halves(window)}")
    run = SimpleNamespace(setup_s=setup_s, window=window, trace=prof,
                          work=drv.work(state), cell=cell, config=cfg,
                          traffic=trf)
    t0 = time.perf_counter()
    checks = drv.check(state)
    log(f"output check {time.perf_counter() - t0:.1f} s")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, kind):
        value = reader("metrics" if trace else "end_to_end", m["name"],
                       root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = trf["limits"]
    held = {name: {"value": float(v), "limit": float(limits[name])}
            for name, v in checks.items() if name in limits}
    logged = {name: float(checks[name])
              for name in sorted(set(checks) - set(limits))}
    for name, value in logged.items():
        log(f"not held: {name} {value!r}")
    correct = (bool(held) and window.failed == 0 and all(
        math.isfinite(h["value"]) and h["value"] <= h["limit"]
        for h in held.values()))
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": window.units,
           "failed": window.failed, "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"], dev["window_s"] = prof.busy_s, prof.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in prof.device_ops],
                            "idle_gaps": [list(x) for x in prof.idle_gaps]}
    out["setup"] = {"cold": bool(compiled), "built": compiled}
    out["logged"] = logged
    out["checks"] = held
    return out


def _libraries(root: Path) -> set:
    """The program's built kernel libraries in the checkout."""
    return {p.name for p in (root / "build" / "kernels").glob("*.so")}


def _halves(window: Window) -> str:
    """Units a second in the window's first and second half, and the
    median and largest step, for the log."""
    mid = (window.start + window.end) / 2
    parts = [[s for s in window.steps if (s.end <= mid) == first]
             for first in (True, False)]
    rates = [sum(s.units for s in p) / max(1e-9, sum(s.end - s.start
                                                       for s in p))
             for p in parts]
    ms = sorted((s.end - s.start) * 1e3 for s in window.steps) or [0.0]
    return (f"halves {rates[0]:.2f} / {rates[1]:.2f} units/s, step median "
            f"{ms[len(ms) // 2]:.2f} ms, largest {ms[-1]:.2f} ms")


def _profiled(drv, state, steps: int, log):
    from . import trace as trace_mod

    def run_steps(n: int) -> int:
        return drv.window(state, for_steps(n)).units

    return trace_mod.profile(run_steps, steps, log=log)
