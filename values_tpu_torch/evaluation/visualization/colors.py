"""The colour data that the reporting layer takes from matplotlib, kept
here as data (the card's machine has no matplotlib).

- :data:`YLORRD_ANCHORS`: ColorBrewer's 9-class YlOrRd, the anchors that
  matplotlib 3.10 keeps as ``_YlOrRd_data`` in ``matplotlib/_cm.py``.
  :func:`ylorrd` is matplotlib's ``YlOrRd`` colormap: the 256-entry
  lookup table that ``LinearSegmentedColormap.from_list`` builds from
  the anchors (``colors.py::_create_lookup_table``), read as
  ``Colormap.__call__`` reads it (``int(x * N)``, ``x == 1`` mapped to
  ``N - 1``, under and over clamped to the ends, NaN to the "bad" colour
  (0, 0, 0, 0)).
- :data:`TABLEAU_COLORS`: the ``tab:`` colour names
  (``matplotlib/_color_data.py``); :data:`TAB10_CYCLE`, matplotlib's
  default property cycle, which pandas' bar plot takes when no colours
  are given.
- :func:`to_rgba` and :func:`rgb2hex`: matplotlib's conversions for the
  colour forms the plot configs use (``tab:`` names, ``#rrggbb[aa]``,
  RGB(A) tuples).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np

RGBA = Tuple[float, float, float, float]

YLORRD_ANCHORS = (
    (1.0, 1.0, 0.8),
    (1.0, 0.92941176470588238, 0.62745098039215685),
    (0.99607843137254903, 0.85098039215686272, 0.46274509803921571),
    (0.99607843137254903, 0.69803921568627447, 0.29803921568627451),
    (0.99215686274509807, 0.55294117647058827, 0.23529411764705882),
    (0.9882352941176471, 0.30588235294117649, 0.16470588235294117),
    (0.8901960784313725, 0.10196078431372549, 0.10980392156862745),
    (0.74117647058823533, 0.0, 0.14901960784313725),
    (0.50196078431372548, 0.0, 0.14901960784313725),
)
LUT_SIZE = 256           # matplotlib's rcParams["image.lut"]
BAD = (0.0, 0.0, 0.0, 0.0)

TABLEAU_COLORS = {
    "tab:blue": "#1f77b4", "tab:orange": "#ff7f0e", "tab:green": "#2ca02c",
    "tab:red": "#d62728", "tab:purple": "#9467bd", "tab:brown": "#8c564b",
    "tab:pink": "#e377c2", "tab:gray": "#7f7f7f", "tab:olive": "#bcbd22",
    "tab:cyan": "#17becf",
}
TAB10_CYCLE = tuple(TABLEAU_COLORS.values())


def _lookup_channel(n: int, anchors: np.ndarray) -> np.ndarray:
    """``_create_lookup_table`` for one channel of evenly spaced anchors
    (gamma 1)."""
    x = np.linspace(0, 1, len(anchors)) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[anchors[0]],
                          distance * (anchors[ind] - anchors[ind - 1])
                          + anchors[ind - 1], [anchors[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.lru_cache(maxsize=None)
def ylorrd_lut() -> np.ndarray:
    """The (N + 3, 4) table: N colours, then under, over and bad."""
    anchors = np.array(YLORRD_ANCHORS, dtype=float)
    lut = np.ones((LUT_SIZE + 3, 4))
    for channel in range(3):
        lut[:LUT_SIZE, channel] = _lookup_channel(LUT_SIZE,
                                                  anchors[:, channel])
    lut[LUT_SIZE] = lut[0]
    lut[LUT_SIZE + 1] = lut[LUT_SIZE - 1]
    lut[LUT_SIZE + 2] = BAD
    lut.flags.writeable = False
    return lut


def ylorrd(x) -> np.ndarray:
    """RGBA rows of YlOrRd at the normalised values ``x`` (floats)."""
    xa = np.array(x, dtype=float, copy=True) * LUT_SIZE
    xa[xa == LUT_SIZE] = LUT_SIZE - 1
    under, over, bad = xa < 0, xa >= LUT_SIZE, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        index = xa.astype(int)
    index[under] = LUT_SIZE
    index[over] = LUT_SIZE + 1
    index[bad] = LUT_SIZE + 2
    return ylorrd_lut().take(index, axis=0, mode="clip")


def to_rgba(color) -> RGBA:
    """matplotlib's ``to_rgba`` for a ``tab:`` name, ``#rrggbb``,
    ``#rrggbbaa`` or an RGB(A) sequence of floats in [0, 1]."""
    if isinstance(color, str):
        hexcode = TABLEAU_COLORS.get(color.lower(), color)
        if hexcode.startswith("#") and len(hexcode) in (7, 9):
            rgba = [int(hexcode[i:i + 2], 16) / 255
                    for i in range(1, len(hexcode), 2)]
            return tuple(rgba + [1.0] * (4 - len(rgba)))
        raise ValueError(f"{color!r}: a colour is a 'tab:' name, "
                         "'#rrggbb', '#rrggbbaa' or an RGB(A) sequence")
    rgba = [float(c) for c in color]
    if len(rgba) not in (3, 4) or not all(0 <= c <= 1 for c in rgba):
        raise ValueError(f"{color!r}: an RGB(A) colour is 3 or 4 floats "
                         "in [0, 1]")
    return tuple(rgba + [1.0] * (4 - len(rgba)))


def rgb2hex(rgba: Sequence[float]) -> str:
    """``#rrggbb``, each channel ``round(v * 255)``."""
    return "#" + "".join(format(round(float(v) * 255), "02x")
                         for v in rgba[:3])


def cycle_color(i: int) -> str:
    """The i-th colour of the default property cycle."""
    return TAB10_CYCLE[i % len(TAB10_CYCLE)]
