"""The bar plot's figure, written by hand as SVG.

The JAX package saves its bar plots as PNGs through matplotlib on
seaborn's ``whitegrid`` style; the card's machine has neither, and the
port's PNG writer (``core/image_io.py``) draws no text. So the port
writes the figure as SVG text: a 5 x 6 in page (points), the axes with
their grid, one ``<rect class="bar">`` per (group, dataset) (face colour
at alpha 0.6 where the plot is hatched, the hatch an SVG ``<pattern>`` in
the bar's own colour), one ``<g class="errorbar">`` per finite error
(the line and caps 2 x 4 pt wide), the zero line, the y tick labels
("µ" at 0), the x labels with their "(µ: ...)" line and the y label, at
font size 19. The numbers come from
:func:`.ds_task_barplots.barplot_data`; the layout is the port's own.
"""
from __future__ import annotations

from pathlib import Path
from typing import List
from xml.sax.saxutils import escape, quoteattr

import numpy as np

from .colors import rgb2hex

PAGE = (360.0, 432.0)            # 5 x 6 in, in points
AXES = (100.0, 12.0, 348.0, 362.0)   # left, top, right, bottom
GRID, SPINE, INK = "#cccccc", "#cccccc", "#262626"   # whitegrid .8/.15
FONT = "DejaVu Sans, Arial, Helvetica, sans-serif"
LINE_WIDTH = 1.5
FONT_SIZE = 19
CAPSIZE = 4.0                    # half an error bar cap's width, points
HATCH_UNIT = 72.0                # matplotlib's hatch unit (an inch) ...
HATCH_DENSITY = 6                # ... holds 6 lines per hatch character


def _hatch_pattern(pid: str, hatch: str, color) -> str:
    """A tile of matplotlib's hatch ``hatch``: ``/`` ``\\`` ``x`` ``-``
    ``|`` ``+`` lines, ``o`` ``O`` circles, ``.`` ``*`` dots; repeating a
    character doubles its density."""
    stroke = rgb2hex(color)
    marks = []
    for chars, kind in (("/x", "/"), ("\\x", "\\"), ("-+", "-"), ("|+", "|"),
                        ("o", "o"), ("O", "O"), (".*", ".")):
        n = sum(hatch.count(c) for c in chars)
        if n:
            marks.append((kind, HATCH_UNIT / (n * HATCH_DENSITY)))
    size = min((s for _, s in marks), default=HATCH_UNIT)
    body = []
    for kind, step in marks:
        r = step / 2
        if kind == "/":
            body.append(f'<path d="M0,{size} L{size},0 M{-r},{r} L{r},{-r} '
                        f'M{size - r},{size + r} L{size + r},{size - r}"/>')
        elif kind == "\\":
            body.append(f'<path d="M0,0 L{size},{size} M{-r},{size - r} '
                        f'L{r},{size + r} M{size - r},{-r} '
                        f'L{size + r},{r}"/>')
        elif kind == "-":
            body.append(f'<path d="M0,{size / 2} L{size},{size / 2}"/>')
        elif kind == "|":
            body.append(f'<path d="M{size / 2},0 L{size / 2},{size}"/>')
        elif kind in "oO":
            body.append(f'<circle cx="{size / 2}" cy="{size / 2}" '
                        f'r="{size * (0.2 if kind == "o" else 0.4)}" '
                        'fill="none"/>')
        else:
            body.append(f'<circle cx="{size / 2}" cy="{size / 2}" '
                        f'r="{size * 0.1}" fill="{stroke}"/>')
    return (f'<pattern id="{pid}" patternUnits="userSpaceOnUse" '
            f'width="{size}" height="{size}"><g stroke="{stroke}" '
            f'stroke-width="1">{"".join(body)}</g></pattern>')


def _text(x: float, y: float, text: str, anchor: str, extra: str = ""
          ) -> str:
    return (f'<text x="{x:.2f}" y="{y:.2f}" text-anchor="{anchor}" '
            f'font-size="{FONT_SIZE}" fill="{INK}"{extra}>'
            f'{escape(text)}</text>')


def write_barplot(data, path: Path) -> Path:
    """Write ``data`` (a ``BarPlotData``) as an SVG file at ``path``."""
    left, top, right, bottom = AXES
    x0, x1 = data.xlim
    y0, y1 = data.ylim

    def px(x):
        return left + (x - x0) / (x1 - x0) * (right - left)

    def py(y):
        return bottom - (y - y0) / (y1 - y0) * (bottom - top)

    defs: List[str] = []
    out: List[str] = [
        f'<rect x="0" y="0" width="{PAGE[0]}" height="{PAGE[1]}" '
        'fill="#ffffff"/>',
        f'<g class="grid" stroke="{GRID}" stroke-width="0.8">']
    for t in data.yticks:
        if y0 <= t <= y1:
            out.append(f'<line x1="{left}" x2="{right}" y1="{py(t):.3f}" '
                       f'y2="{py(t):.3f}"/>')
    for i in range(len(data.labels)):
        out.append(f'<line x1="{px(i):.3f}" x2="{px(i):.3f}" y1="{top}" '
                   f'y2="{bottom}"/>')
    out.append("</g>")
    for g, group in enumerate(data.groups):
        color = data.facecolors[g]
        fill = f'fill="{rgb2hex(color)}" fill-opacity="{color[3]:g}"'
        pattern = ""
        if data.hatches and data.hatches[g]:
            pid = f"hatch{g}"
            defs.append(_hatch_pattern(pid, data.hatches[g],
                                       data.hatch_colors[g]))
            pattern = f' fill="url(#{pid})"'
        for d, label in enumerate(data.labels):
            h = data.heights[g, d]
            ya, yb = sorted((py(0.0), py(h)))
            xa, xb = px(data.left[g, d]), px(data.left[g, d] + data.width)
            attrs = (f'class="bar" data-group={quoteattr(str(group))} '
                     f'data-dataset={quoteattr(label)} x="{xa:.3f}" '
                     f'y="{ya:.3f}" width="{xb - xa:.3f}" '
                     f'height="{yb - ya:.3f}"')
            out.append(f'<rect {attrs} {fill} stroke="#ffffff" '
                       'stroke-width="1"/>')
            if pattern:
                out.append(f'<rect x="{xa:.3f}" y="{ya:.3f}" '
                           f'width="{xb - xa:.3f}" height="{yb - ya:.3f}"'
                           f'{pattern} stroke="none"/>')
    for g, group in enumerate(data.groups):
        for d, label in enumerate(data.labels):
            e = data.errors[g, d]
            if not np.isfinite(e):
                continue
            h = data.heights[g, d]
            cx, lo, hi = px(data.centers[g, d]), py(h - e), py(h + e)
            out.append(
                f'<g class="errorbar" data-group={quoteattr(str(group))} '
                f'data-dataset={quoteattr(label)} stroke="{INK}" '
                f'stroke-width="{LINE_WIDTH}"><line x1="{cx:.3f}" '
                f'x2="{cx:.3f}" y1="{lo:.3f}" y2="{hi:.3f}"/>'
                + "".join(f'<line x1="{cx - CAPSIZE:.3f}" '
                          f'x2="{cx + CAPSIZE:.3f}" y1="{y:.3f}" '
                          f'y2="{y:.3f}"/>' for y in (lo, hi))
                + "</g>")
    if y0 <= 0.0 <= y1:
        out.append(f'<line class="zero" x1="{left}" x2="{right}" '
                   f'y1="{py(0.0):.3f}" y2="{py(0.0):.3f}" stroke="#000000" '
                   f'stroke-width="{LINE_WIDTH}"/>')
    out.append(f'<rect x="{left}" y="{top}" width="{right - left}" '
               f'height="{bottom - top}" fill="none" stroke="{SPINE}" '
               'stroke-width="1.25"/>')
    for t, label in zip(data.yticks, data.yticklabels):
        if y0 <= t <= y1:
            out.append(_text(left - 6, py(t) + 6.5, label, "end",
                             ' class="ytick"'))
    for i, label in enumerate(data.labels):
        lines = "".join(
            f'<tspan x="{px(i):.2f}" dy="{0 if n == 0 else 22}">'
            f"{escape(part.strip())}</tspan>"
            for n, part in enumerate(label.split("\n")))
        out.append(f'<text class="xtick" x="{px(i):.2f}" y="{bottom + 24}" '
                   f'text-anchor="middle" font-size="{FONT_SIZE}" '
                   f'fill="{INK}">'
                   f"{lines}</text>")
    out.append(_text(24, (top + bottom) / 2, data.ylabel, "middle",
                     f' class="ylabel" transform="rotate(-90 24 '
                     f'{(top + bottom) / 2:.2f})"'))
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" width="{PAGE[0]}pt" '
           f'height="{PAGE[1]}pt" viewBox="0 0 {PAGE[0]} {PAGE[1]}" '
           f'font-family="{FONT}">\n<defs>{"".join(defs)}</defs>\n'
           + "\n".join(out) + "\n</svg>\n")
    Path(path).write_text(svg, encoding="utf-8")
    return Path(path)
