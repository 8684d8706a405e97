"""matplotlib's y axis for the bar plot, in numpy.

The JAX bar plot reads ``ax.get_yticks()`` from a fresh pandas bar plot
and then ``set_yticks`` those ticks
(``values_tpu/evaluation/visualization/ds_task_barplots.py:76-81``). This
module computes the same numbers without matplotlib (matplotlib 3.10's
``axes/_base.py::autoscale_view``, ``ticker.py::MaxNLocator`` as
``AutoLocator`` sets it up, ``transforms.py::nonsingular``):

- the data interval of the bars (each from 0 to its height) and their
  error bars, widened by the default margin 0.05 of its span on each
  side, a bound stopping at 0 where the data meets the bars' base (the
  bars' sticky edge);
- ``MaxNLocator`` with steps [1, 2, 2.5, 5, 10] and ``nbins`` from the
  axis's tick space: the default subplot's height in points (the plot
  reads its ticks before ``tight_layout``) over twice the tick label's
  size, at most 9. pandas sets its ``fontsize`` on the tick labels, not
  on the axis, so the size is matplotlib's default 10 pt;
- ``set_yticks`` then widens the view to the outermost ticks.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

FIGSIZE = (5.0, 6.0)              # inches, the JAX plot's figsize
SUBPLOT_BOTTOM, SUBPLOT_TOP = 0.11, 0.88   # rcParams figure.subplot.*
TICK_LABEL_PT = 10.0              # rcParams ytick.labelsize ("medium")
MARGIN = 0.05                     # rcParams axes.ymargin
STEPS = np.array([1, 2, 2.5, 5, 10])
MIN_N_TICKS = 2


def nonsingular(vmin: float, vmax: float, expander: float = 0.001,
                tiny: float = 1e-15) -> Tuple[float, float]:
    if not np.isfinite(vmin) or not np.isfinite(vmax):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabsvalue = max(abs(vmin), abs(vmax))
    if maxabsvalue < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabsvalue * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return vmin, vmax


def tick_space() -> int:
    """How many ticks fit on the default subplot's y axis."""
    length = FIGSIZE[1] * (SUBPLOT_TOP - SUBPLOT_BOTTOM) * 72
    return int(np.floor(length / (TICK_LABEL_PT * 2)))


def _scale_range(vmin: float, vmax: float, n: int, threshold: int = 100):
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    if abs(meanv) / dv < threshold:
        offset = 0
    else:
        offset = math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / n) // 1)
    return scale, offset


class _EdgeInteger:
    def __init__(self, step: float, offset: float):
        self.step = step
        self._offset = abs(offset)

    def closeto(self, ms: float, edge: float) -> bool:
        if self._offset > 0:
            digits = np.log10(self._offset / self.step)
            tol = min(0.4999, max(1e-10, 10 ** (digits - 12)))
        else:
            tol = 1e-10
        return abs(ms - edge) < tol

    def le(self, x: float):
        d, m = divmod(x, self.step)
        return d + 1 if self.closeto(m / self.step, 1) else d

    def ge(self, x: float):
        d, m = divmod(x, self.step)
        return d if self.closeto(m / self.step, 0) else d + 1


def tick_values(vmin: float, vmax: float, nbins: int) -> np.ndarray:
    """``MaxNLocator.tick_values``: ticks spanning [vmin, vmax], one
    beyond an end where the step does not meet it."""
    vmin, vmax = nonsingular(vmin, vmax, expander=1e-13, tiny=1e-14)
    scale, offset = _scale_range(vmin, vmax, nbins)
    _vmin, _vmax = vmin - offset, vmax - offset
    steps = np.concatenate([0.1 * STEPS[:-1], STEPS, [10 * STEPS[1]]]) * scale
    raw_step = (_vmax - _vmin) / nbins
    large = steps >= raw_step
    istep = np.nonzero(large)[0][0] if any(large) else len(steps) - 1
    for step in steps[:istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        edge = _EdgeInteger(step, offset)
        low = edge.le(_vmin - best_vmin)
        high = edge.ge(_vmax - best_vmin)
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= MIN_N_TICKS:
            break
    return ticks + offset


def autoscale(values: Sequence[float], stickies: Sequence[float]
              ) -> Tuple[float, float]:
    """The view interval autoscaling gives the data ``values``."""
    values = [v for v in values if np.isfinite(v)]
    x0, x1 = (min(values), max(values)) if values else (-np.inf, np.inf)
    x0, x1 = nonsingular(x0, x1, expander=0.05)
    stickies = np.sort(np.asarray(stickies, dtype=float))
    tol = 1e-5 * abs(x1 - x0)
    i0 = stickies.searchsorted(x0 + tol) - 1
    x0bound = stickies[i0] if i0 != -1 else None
    i1 = stickies.searchsorted(x1 - tol)
    x1bound = stickies[i1] if i1 != len(stickies) else None
    delta = (x1 - x0) * MARGIN
    if not np.isfinite(delta):
        delta = 0
    x0, x1 = x0 - delta, x1 + delta
    if x0bound is not None:
        x0 = max(x0, x0bound)
    if x1bound is not None:
        x1 = min(x1, x1bound)
    x0, x1 = nonsingular(x0, x1, expander=1e-12, tiny=1e-13)  # view_limits
    return nonsingular(x0, x1, expander=0.05)                 # set_ylim


def bar_axis(heights: np.ndarray, errors: np.ndarray
             ) -> Tuple[List[float], Tuple[float, float]]:
    """(ticks, ylim) of a bar plot of ``heights`` (bars from 0) with
    symmetric error bars ``errors`` (NaN: none)."""
    heights = np.asarray(heights, dtype=float).ravel()
    errors = np.asarray(errors, dtype=float).ravel()
    values = [0.0] + list(heights)
    has = ~np.isnan(errors)
    values += list(heights[has] - errors[has]) + list(heights[has]
                                                       + errors[has])
    vmin, vmax = autoscale(values, np.zeros(heights.size))
    nbins = int(np.clip(tick_space(), max(1, MIN_N_TICKS - 1), 9))
    ticks = tick_values(vmin, vmax, nbins).tolist()
    if ticks:
        vmin, vmax = min(ticks[0], ticks[-1], vmin), max(ticks[0], ticks[-1],
                                                         vmax)
    return ticks, (vmin, vmax)
