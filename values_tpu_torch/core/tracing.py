"""Spans and counters of the port's own layers, on the profiler's clock.

The port's only tracing module. ``span(name)`` marks one layer of a
step: the scorer's cast, forward, C2 and C3, the training step's forward,
backward and optimizer, the 2D tester's copies, forwards, SSN sampling,
batch-wide metrics and maps, and writes. ``count(name, n)`` counts the
bytes copied each way (``h2d_bytes``, ``d2h_bytes``), the blocking
device-to-host reads (``readbacks``) and the work done (``images``,
``ssn_samples``) at the sites that do them; :func:`to_device`,
:func:`to_host`, :func:`to_host_packed` (several tensors in one read,
through pinned memory) and :func:`item` copy or read and count together.
A site counts on every device, so a CPU run counts what the card would
copy and read.

Spans and counters record only while a ``torch.profiler`` collects.
Outside one, ``span`` is one flag check that returns a shared null
context: no torch call, no allocation, no event. Inside one, a span

- enters ``torch.profiler.record_function(name)``, so the profiler's
  trace holds it as a ``user_annotation`` on the device kernels' clock;
- keeps its host start and end (``perf_counter_ns``), its parent and its
  root: the root's id names one request, step or batch;
- on CUDA, records a timing event on the current stream at each end. The
  span's stream ms runs from the end of the work queued before it to the
  end of the work queued inside it. The events are read when
  :func:`records` or :func:`summary` is called, after the profiled work
  has been synchronized; recording never synchronizes.

The span stack is per thread. ``count`` adds to the innermost open span
and to the process's totals (:func:`totals`).

:func:`profiled` is the operator's switch: with
``VALUES_TPU_TORCH_TRACE_DIR`` set, it runs ``torch.profiler`` over a
command's work and writes the Chrome trace (``trace.json``) and
``spans.json`` into that directory, and prints the summary table. Every
span and every profiled op is kept in memory until the end: it is meant
for a short run. Without the variable it does nothing.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_DIR_ENV = "VALUES_TPU_TORCH_TRACE_DIR"

_NULL = contextlib.nullcontext()
_local = threading.local()
_ids = itertools.count(1)
_records: List["_Span"] = []
_totals: Dict[str, int] = defaultdict(int)
_totals_lock = threading.Lock()

def enabled() -> bool:
    """Whether a ``torch.profiler`` is collecting."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One open or closed span; its own context manager."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "child_ns", "counters", "events", "stream",
                 "_fn", "_cuda_stream")

    def __init__(self, name: str):
        self.name = name
        self.counters: Dict[str, int] = {}
        self.child_ns = 0
        self.events = None
        self.stream: Optional[float] = None

    def __enter__(self) -> "_Span":
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        if torch.cuda.is_initialized():
            self._cuda_stream = torch.cuda.current_stream()
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self._cuda_stream)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self._cuda_stream)
        self._fn.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += self.end_ns - self.start_ns
        _records.append(self)
        return False

    def stream_ms(self) -> Optional[float]:
        """Device ms between the two events (None off CUDA); waits for
        the end event if the device has not reached it."""
        if self.stream is None and self.events is not None:
            self.events[1].synchronize()
            self.stream = self.events[0].elapsed_time(self.events[1])
        return self.stream


def span(name: str):
    """A context that records span ``name`` while a profiler collects;
    otherwise the shared null context."""
    if not enabled():
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span and of the
    process's totals, while a profiler collects."""
    if not enabled():
        return
    stack = _stack()
    if stack:
        top = stack[-1].counters
        top[name] = top.get(name, 0) + int(n)
    with _totals_lock:
        _totals[name] += int(n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t.to(device)``, its bytes counted as ``h2d_bytes``."""
    if enabled():
        count("h2d_bytes", _nbytes(t))
    return t.to(device)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: one blocking read (``readbacks``) of ``d2h_bytes``."""
    if enabled():
        count("readbacks")
        count("d2h_bytes", _nbytes(t))
    return t.cpu()


def item(t: torch.Tensor):
    """``t.item()`` of a one-element tensor: one blocking read."""
    if enabled():
        count("readbacks")
        count("d2h_bytes", t.element_size())
    return t.item()


PACK_ALIGN = 64  # bytes; every part of a packed read starts on a multiple


def to_host_packed(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors ``parts`` (one device) read back in one blocking copy:
    packed into one byte buffer on their device, each at an offset aligned
    to ``PACK_ALIGN``, copied asynchronously into a new host buffer
    (from torch's pinned allocator on CUDA), then synchronized on that
    copy. Returns contiguous host views of the buffer, one a part, in the
    parts' shapes and types. One ``readbacks`` of the buffer's
    ``d2h_bytes``, padding included.

    The host buffer is new on every call, so views that a caller keeps
    are never overwritten by a later read."""
    offsets, total = [], 0
    for t in parts:
        total = -(-total // PACK_ALIGN) * PACK_ALIGN
        offsets.append(total)
        total += _nbytes(t)
    device = parts[0].device
    packed = torch.empty(total, dtype=torch.uint8, device=device)
    for t, at in zip(parts, offsets):
        packed[at:at + _nbytes(t)].view(t.dtype).view(t.shape).copy_(t)
    if enabled():
        count("readbacks")
        count("d2h_bytes", total)
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host.copy_(packed, non_blocking=True)
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return [host[at:at + _nbytes(t)].view(t.dtype).view(t.shape)
            for t, at in zip(parts, offsets)]


def records() -> List[Dict]:
    """Every closed span, in start order: its name, its ``seq`` (its
    place among the spans of that name and thread, which is the order of
    its annotations in the profiler's trace), ids, host times, stream ms
    and counters."""
    out, seen = [], defaultdict(int)
    for r in sorted(_records, key=lambda r: r.start_ns):
        seq = seen[(r.name, r.thread)]
        seen[(r.name, r.thread)] += 1
        host = (r.end_ns - r.start_ns) * 1e-6
        out.append({"name": r.name, "seq": seq, "id": r.id,
                    "parent": r.parent, "root": r.root, "thread": r.thread,
                    "start_ns": r.start_ns, "end_ns": r.end_ns,
                    "host_ms": host, "self_host_ms": host - r.child_ns * 1e-6,
                    "stream_ms": r.stream_ms(), "counters": dict(r.counters)})
    return out


def summary() -> Dict[str, Dict]:
    """For each span name: ``calls``, ``host_ms``, ``self_host_ms`` (less
    the time its child spans cover), ``stream_ms`` (None off CUDA), each
    summed over its calls, and its ``counters``."""
    out: Dict[str, Dict] = {}
    for r in records():
        s = out.setdefault(r["name"], {"calls": 0, "host_ms": 0.0,
                                       "self_host_ms": 0.0, "stream_ms": 0.0,
                                       "counters": {}})
        s["calls"] += 1
        s["host_ms"] += r["host_ms"]
        s["self_host_ms"] += r["self_host_ms"]
        s["stream_ms"] = (None if s["stream_ms"] is None
                          or r["stream_ms"] is None
                          else s["stream_ms"] + r["stream_ms"])
        for k, v in r["counters"].items():
            s["counters"][k] = s["counters"].get(k, 0) + v
    return out


def totals() -> Dict[str, int]:
    """The process's counters, summed over every span and outside them."""
    return dict(_totals)


def reset() -> None:
    """Forget every closed span and counter."""
    _records.clear()
    _totals.clear()


def format_summary() -> str:
    """The summary as a table, one span name a row."""
    rows = summary()
    lines = [f"{'span':<26}{'calls':>7}{'host ms':>12}{'self ms':>12}"
             f"{'stream ms':>12}  counters"]
    for name in sorted(rows):
        s = rows[name]
        stream = "-" if s["stream_ms"] is None else f"{s['stream_ms']:.3f}"
        lines.append(f"{name:<26}{s['calls']:>7}{s['host_ms']:>12.3f}"
                     f"{s['self_host_ms']:>12.3f}{stream:>12}  "
                     + " ".join(f"{k}={v}" for k, v in
                                sorted(s["counters"].items())))
    lines.append("totals: " + " ".join(f"{k}={v}" for k, v in
                                       sorted(totals().items())))
    return "\n".join(lines)


@contextlib.contextmanager
def profiled() -> Iterator[None]:
    """Profile the work inside (CPU, and CUDA where there is a card) when
    ``VALUES_TPU_TORCH_TRACE_DIR`` names a directory; then write
    ``trace.json`` and ``spans.json`` there and print the summary table
    to standard error. Otherwise does nothing."""
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    reset()
    prof = profile(activities=activities)
    try:
        with prof:
            yield
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        with open(os.path.join(trace_dir, "spans.json"), "w") as fh:
            json.dump({"records": records(), "summary": summary(),
                       "totals": totals()}, fh, indent=1)
        print(format_summary(), file=sys.stderr, flush=True)
