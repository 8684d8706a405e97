"""The LaTeX text of the results table, as pandas' Styler writes it.

The JAX package styles its table with ``Styler.background_gradient`` and
writes it with ``Styler.to_latex`` (``values_tpu/evaluation/visualization/
ds_task_table.py:223-244``). The card's machine has no pandas, so this
module writes the same text itself, for the options that call uses:

- :func:`gradient_styles`: ``background_gradient(cmap="YlOrRd")`` over one
  column: the gradient map normalised by its ``nanmin``/``nanmax``
  (matplotlib's ``Normalize``; a constant map is all 0), YlOrRd's colour,
  and the text colour ``#f1f1f1`` where the colour's relative luminance
  is under 0.408, else ``#000000``;
- :func:`styler_latex`: ``to_latex(convert_css=True, hrules=True,
  position_float="centering", multicol_align="c",
  clines="skip-last;data")`` of a table with a MultiIndex of rows, two
  levels of column labels and string cells: the sparsified index as
  ``\\multirow[c]{n}{*}{...}``, one ``\\multicolumn{n}{c}{...}`` per run
  of equal top-level column labels, the index names' row, each styled
  cell as ``{\\cellcolor[HTML]{..}} \\color[HTML]{..} text``, and after
  each row the ``\\cline{i-N}`` of every index level but the last whose
  run of equal labels ends there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .colors import rgb2hex, ylorrd

TEXT_COLOR_THRESHOLD = 0.408
Style = Optional[Tuple[str, str]]     # (background "#rrggbb", text colour)


def relative_luminance(rgba) -> float:
    r, g, b = (x / 12.92 if x <= 0.04045 else ((x + 0.055) / 1.055) ** 2.4
               for x in rgba[:3])
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def normalize(gmap: np.ndarray) -> np.ndarray:
    """matplotlib's ``Normalize(nanmin, nanmax)`` of ``gmap``."""
    gmap = np.array(gmap, dtype=float)
    with np.errstate(invalid="ignore"):
        finite = gmap[~np.isnan(gmap)]
        vmin = finite.min() if finite.size else np.nan
        vmax = finite.max() if finite.size else np.nan
    if vmin == vmax:
        return np.zeros_like(gmap)
    gmap -= vmin
    gmap /= (vmax - vmin)
    return gmap


def gradient_styles(gmap: Sequence[float]) -> List[Tuple[str, str]]:
    """(background, text colour) of each cell of one column."""
    out = []
    for rgba in ylorrd(normalize(gmap)):
        dark = relative_luminance(rgba) < TEXT_COLOR_THRESHOLD
        out.append((rgb2hex(rgba), "#f1f1f1" if dark else "#000000"))
    return out


def _cell(text: str, style: Style) -> str:
    if style is None:
        return text
    background, color = style
    return (f"{{\\cellcolor[HTML]{{{background[1:].upper()}}}}} "
            f"\\color[HTML]{{{color[1:].upper()}}} {text}")


def level_spans(labels: Sequence[tuple]) -> List[dict]:
    """For each level, {first row of a run: its length}: a row starts a
    run of a level unless it and the row before carry the same labels in
    that level and every level above (pandas' sparsification; the last
    level is never sparsified)."""
    n_levels = len(labels[0]) if labels else 0
    spans: List[dict] = [{} for _ in range(n_levels)]
    for level in range(n_levels):
        start = None
        for r, row in enumerate(labels):
            if (start is None or level == n_levels - 1
                    or row[:level + 1] != labels[r - 1][:level + 1]):
                start = r
                spans[level][r] = 1
            else:
                spans[level][start] += 1
    return spans


def _header_cell(text: str, span: int, kind: str) -> str:
    if span > 1 and kind == "col":
        return f"\\multicolumn{{{span}}}{{c}}{{{text}}}"
    if span > 1:
        return f"\\multirow[c]{{{span}}}{{*}}{{{text}}}"
    return text


def _row(cells: Sequence[str]) -> str:
    return " & ".join(cells) + " \\\\\n"


def styler_latex(index: Sequence[tuple], index_names: Sequence[str],
                 columns: Sequence[tuple], cells: Sequence[Sequence[str]],
                 styles: Sequence[Sequence[Style]],
                 column_format: str) -> str:
    """The text of ``Styler.to_latex`` for the table; ``cells[r][c]`` is
    the display text and ``styles[r][c]`` its gradient style (or None)."""
    n_levels, n_cols = len(index_names), len(columns)
    out = ["\\begin{table}\n", "\\centering\n",
           f"\\begin{{tabular}}{{{column_format}}}\n", "\\toprule\n"]
    col_spans = level_spans(columns)
    for level in range(len(columns[0]) if columns else 0):
        heads = [_header_cell(str(columns[c][level]), span, "col")
                 for c, span in col_spans[level].items()]
        out.append(_row([""] * n_levels + heads))
    out.append(_row(list(index_names) + [""] * n_cols))
    out.append("\\midrule\n")
    spans = level_spans(index)
    clines = {}
    for level in range(n_levels - 1):
        for r, span in spans[level].items():
            clines.setdefault(r + span, []).append(
                f"\\cline{{{level + 1}-{n_levels + n_cols}}}")
    for r, row in enumerate(index):
        heads = [_header_cell(str(row[level]), spans[level][r], "row")
                 if r in spans[level] else "" for level in range(n_levels)]
        out.append(_row(heads + [_cell(cells[r][c], styles[r][c])
                                 for c in range(n_cols)]))
        if clines.get(r + 1):
            out.append(" ".join(clines[r + 1]) + "\n")
    out += ["\\bottomrule\n", "\\end{tabular}\n", "\\end{table}\n"]
    return "".join(out)
