"""What the metric readers share. Each returns None where there is
nothing to read (no traced window, or one whose kernel records fell short
of the launches), and never a share it cannot back."""
from __future__ import annotations

import math
from typing import Callable, Optional

from .trace import is_dx, is_k1


def rate(run) -> float:
    """All the window's units over all its seconds."""
    return run.window.units / run.window.seconds


def p95_ms(run) -> float:
    """The 95th percentile (nearest rank) of every step's milliseconds."""
    ms = sorted((s.end - s.start) * 1e3 for s in run.window.steps)
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]


def _trace(run):
    t = run.trace
    return t if t is not None and t.complete and t.window_s > 0 else None


def idle_percent(run) -> Optional[float]:
    t = _trace(run)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_percent(run) -> Optional[float]:
    """Model operations of the measured window over the window times the
    peak of the configuration's precision."""
    w = run.work
    return (100.0 * w["flops_per_unit"] * run.window.units
            / (run.window.seconds * w["peak_flops"]))


def roofline_percent(run, least_key: str,
                     select: Callable[[str], bool]) -> Optional[float]:
    """The least time of the traced steps' kernels (``work[least_key]``
    a step) over the device time of the kernels ``select`` names."""
    t = _trace(run)
    if t is None:
        return None
    seconds = sum(d for name, d in t.kernels if select(name))
    if seconds <= 0:
        return None
    return 100.0 * run.work[least_key] * t.steps / seconds


def k1_forward(name: str) -> bool:
    return is_k1(name) and not is_dx(name)


def launches_per_unit(run) -> Optional[float]:
    t = _trace(run)
    return None if t is None or t.units == 0 else t.launches / t.units
