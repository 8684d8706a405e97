"""The program's own spans and counters (``values_tpu_torch.core.tracing``),
read in the run's process after it ends.

The program records them only while a ``torch.profiler`` collects, so
they hold the traced window's steps: every window the profiler took, where
it took a short one again. Each number is taken per call of the cell's
root span (one scored batch, training step or tested batch), which holds
however many windows there were. Every reader returns None where there is
nothing to read: a program without the recorder, or a run in which no
root span was recorded. The program is imported inside the functions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


def _recorded() -> Optional[Tuple[Dict, Dict]]:
    """The recorder's summary and counter totals, or None."""
    try:
        from values_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing.summary(), tracing.totals()


def per_root(root: str, name: str, key: str = "stream_ms"
             ) -> Optional[float]:
    """Span ``name``'s ``key`` (``stream_ms`` or ``host_ms``), summed over
    its calls, per call of span ``root``."""
    got = _recorded()
    if got is None:
        return None
    spans = got[0]
    calls = spans.get(root, {}).get("calls", 0)
    value = spans.get(name, {}).get(key)
    if calls == 0 or value is None:
        return None
    return value / calls


def ratio(root: str, counter: str, per: str) -> Optional[float]:
    """The program's ``counter`` over its ``per`` counter, both summed over
    the recorded windows, where span ``root`` was recorded."""
    got = _recorded()
    if got is None:
        return None
    spans, totals = got
    if spans.get(root, {}).get("calls", 0) == 0 or not totals.get(per):
        return None
    return totals.get(counter, 0) / totals[per]
