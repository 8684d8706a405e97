"""A profiled window of a few steady steps, read from torch.profiler's
trace.

The window is a ``bench.window`` annotation around the steps, which end
on the host. From the profiler's events it takes the device's
kernels, copies and sets (their names and durations), the host's kernel
launches (``LAUNCH_CALLS``), and the host's operations. Busy time is the
union of the device's intervals inside the window; each idle interval is
named by the innermost host operation that covers its middle.

The profiler has dropped kernel records in long sessions. So the window
is taken early, and its kernel records are held against the host's
launches and against the program's own launch counters; a window that
falls short is taken again, and after ``tries`` windows that all fall
short, the trace is marked incomplete and the metrics that need it read
nothing.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
# the program's kernels, as the profiler names them
K1_KERNELS = ("conv3d_f32_kernel", "conv3d_cin1_kernel", "conv3d_mma_kernel",
              "conv3d_shallow_kernel")
# a K1 instance of the dx entry: its last template argument, FLIP, true
DX_MARKS = (", true>", "Lb1EE")
K2_KERNELS = ("fused_entropy_kernel", "fused_entropy_stream_kernel")
# counter name -> the kernels whose records it must match
COUNTED = {"conv3d_fused": K1_KERNELS, "fused_entropy": K2_KERNELS}


def is_k1(name: str) -> bool:
    return any(k in name for k in K1_KERNELS)


def is_dx(name: str) -> bool:
    return is_k1(name) and any(m in name for m in DX_MARKS)


def port_counters() -> Dict[str, int]:
    """The program's launch counters of its hand-written kernels."""
    from values_tpu_torch.ops.kernels.conv3d import conv3d_fused
    from values_tpu_torch.ops.kernels.entropy import fused_entropy
    return {"conv3d_fused": conv3d_fused.launches,
            "fused_entropy": fused_entropy.launches}


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]      # every kernel record, seconds
    launches: int                         # the host's kernel launches
    steps: int
    units: int
    complete: bool
    note: str
    device_ops: List[Tuple[str, float]]   # by total time, at most 10
    idle_gaps: List[Tuple[str, float]]    # idle time by host op, at most 10


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def parse(events: List[Dict], steps: int, units: int,
          counted: Dict[str, int]) -> Trace:
    """A Trace of a Chrome trace's events (times in microseconds)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace has no {WINDOW} annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernels, host, launches = [], [], [], 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, a = e.get("cat"), float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= w0 or a >= w1:
            continue
        if cat in DEVICE_CATS:
            dev.append((max(a, w0), min(b, w1)))
            if cat == "kernel":
                kernels.append((e["name"], (b - a) * 1e-6))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((a, b, e["name"]))
            if cat == "cuda_runtime" and e["name"] in LAUNCH_CALLS:
                launches += 1
    busy = _union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    idle: Dict[str, float] = {}
    # a sweep over the gaps' middles: the host ops begun by then on a heap
    # by latest start, those that ended before dropped as they surface;
    # the top is then the innermost op that covers the middle
    host.sort()
    heap: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(no host op)"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    by_kernel: Dict[str, float] = {}
    for name, s in kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + s
    short = []
    if len(kernels) < launches:
        short.append(f"{len(kernels)} kernel records of {launches} "
                     "launches")
    for counter, names in COUNTED.items():
        want = counted.get(counter, 0)
        got = sum(1 for n, _ in kernels if any(k in n for k in names))
        if got < want:
            short.append(f"{counter}: {got} records of {want} launches")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Trace((w1 - w0) * 1e-6, busy_us * 1e-6, kernels, launches, steps,
                 units, not short, "; ".join(short) or "complete",
                 [(_short(n), s) for n, s in top],
                 [(_short(n), s) for n, s in gaps_top])


def _events(prof) -> List[Dict]:
    """The profile's events, as an exported Chrome trace holds them."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def profile(run_steps: Callable[[int], int], steps: int, tries: int = 3,
            log=print) -> Trace:
    """Profile ``run_steps(steps)`` (which returns the units it did) until
    its kernel records are complete, at most ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function
    trace: Optional[Trace] = None
    for attempt in range(tries):
        before = port_counters()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                units = run_steps(steps)
                torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in port_counters().items()}
        t0 = time.perf_counter()
        events = _events(prof)
        trace = parse(events, steps, units, counted)
        log(f"profiled window {attempt + 1}: {steps} steps, {units} units, "
            f"{trace.window_s:.4f} s, busy {trace.busy_s:.4f} s, "
            f"{len(trace.kernels)} kernel records, {trace.launches} "
            f"launches ({trace.note}); read in "
            f"{time.perf_counter() - t0:.1f} s")
        if trace.complete:
            break
    return trace
