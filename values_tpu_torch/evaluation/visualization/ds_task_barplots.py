"""Mean-centred comparison bar plots per task x metric x dimension.

The port's counterpart of ``values_tpu/evaluation/visualization/
ds_task_barplots.py`` (reference: evaluation/visualization/
ds_task_barplots.py:14-191), without pandas, matplotlib or seaborn.
:func:`barplot_data` computes in numpy what the JAX function hands to
pandas and matplotlib: per dataset frame the metric column centred on
its mean (sign flipped for lower-better) after the config's filters,
grouped by the chosen dimension (pred_model / unc_type / aggregation;
mean and ``std(ddof=1)``, groups sorted as ``groupby`` sorts them), rows
that are NaN for every dataset dropped, the config's ordering, colours
and hatches, the bars' geometry as pandas' ``plot.bar`` lays it out and
the y axis as matplotlib autoscales it (:mod:`.ticks`). :mod:`.svg` then
draws the figure. The one difference from the JAX output: the figure is
an SVG (``<save_path>/<dimension>/<metric>.svg``), not a PNG.

CLI (host only; composes as the JAX ``main``):
    python -m values_tpu_torch.evaluation.visualization.ds_task_barplots \\
        -cn plot_config [key=value ...]
"""
from __future__ import annotations

import copy
import dataclasses
import os
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import colors as colormod
from .ds_task_table import DsTaskTable, ResultFrame
from .svg import write_barplot
from .ticks import bar_axis

BAR_WIDTH = 0.5             # pandas' plot.bar width (all bars of a tick)
HATCH_ALPHA = 0.6


@dataclasses.dataclass
class BarPlotData:
    """Everything the figure shows; arrays are (groups, datasets)."""
    groups: List[str]               # the bar series (dimension values)
    labels: List[str]               # x tick labels (one a dataset)
    left: np.ndarray                # each bar's left edge
    width: float
    centers: np.ndarray
    heights: np.ndarray             # NaN means drawn as 0, as pandas does
    errors: np.ndarray              # std; NaN where the plot draws none
    facecolors: List[Tuple[float, float, float, float]]   # per group
    hatches: Optional[List[str]]    # per group, None without a hatch map
    hatch_colors: Optional[List[Tuple[float, float, float, float]]]
    xlim: Tuple[float, float]
    yticks: List[float]
    yticklabels: List[str]
    ylim: Tuple[float, float]
    ylabel: str


def _group_stats(values: np.ndarray, keys: List[str]):
    """Sorted group keys, each group's mean and std(ddof=1) over its
    non-NaN values (NaN where it has none, or one for the std)."""
    groups = sorted(set(keys))
    keys = np.asarray(keys, dtype=object)
    mean, std = [], []
    for g in groups:
        v = values[keys == g]
        v = v[~np.isnan(v)]
        mean.append(v.mean() if v.size else np.nan)
        std.append(v.std(ddof=1) if v.size > 1 else np.nan)
    return groups, np.array(mean), np.array(std)


def _union(indexes: List[List[str]]) -> List[str]:
    out = list(dict.fromkeys(indexes[0]))
    for index in indexes[1:]:
        out += [k for k in dict.fromkeys(index) if k not in out]
    return out


def _drop_all_nan(rows: List[str], table: np.ndarray):
    keep = ~np.isnan(table).all(axis=1)
    return [r for r, k in zip(rows, keep) if k], table[keep]


def _reindex(rows: List[str], table: np.ndarray, order: List[str]):
    out = np.full((len(order), table.shape[1]), np.nan)
    for i, key in enumerate(order):
        if key in rows:
            out[i] = table[rows.index(key)]
    return out


def barplot_data(ds_task: str, metric: str, dimension: str,
                 dataset_dfs: Dict[str, ResultFrame],
                 lower_better: bool = False, percent: bool = False,
                 df_naming=None, coloring=None, hatches=None, ordering=None,
                 filter_index=None) -> BarPlotData:
    """The JAX ``generate_barplot``'s numbers (``dataset_dfs`` are not
    changed)."""
    col = (ds_task, metric)
    labels, group_rows, means, stds = [], [], [], []
    for df_name, df in dataset_dfs.items():
        if filter_index:
            for dim_name, dim_value in filter_index:
                df = df.rows([v != dim_value
                              for v in df.level(("", dim_name))])
        values = df.column(col).copy()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            mean_ds = np.nanmean(values)
        values -= mean_ds
        if lower_better:
            values *= -1
        plot_name = (df_naming or {}).get(df_name, df_name)
        mu = round(mean_ds, 2) if percent else round(mean_ds / 100, 2)
        labels.append(f"{plot_name} \n (µ: {round(mu, 2)})")
        groups, m, s = _group_stats(values, df.level(("", dimension)))
        group_rows.append(groups)
        means.append(dict(zip(groups, m)))
        stds.append(dict(zip(groups, s)))

    rows = _union(group_rows)
    mean = np.array([[d.get(r, np.nan) for d in means] for r in rows]
                    ).reshape(len(rows), len(labels))
    std = np.array([[d.get(r, np.nan) for d in stds] for r in rows]
                   ).reshape(len(rows), len(labels))
    mean_rows, mean = _drop_all_nan(rows, mean)
    std_rows, std = _drop_all_nan(rows, std)
    if ordering and dimension in ordering:
        order = [o for o in ordering[dimension] if o in mean_rows]
        mean = _reindex(mean_rows, mean, order)
        std = _reindex(std_rows, std, order)
        mean_rows = std_rows = order
    # the bars: one series a group, its bars over the datasets
    errors = np.array([std[std_rows.index(g)] if g in std_rows
                       else np.full(len(labels), np.nan)
                       for g in mean_rows]).reshape(mean.shape)
    colors = dict(coloring[dimension]) if (coloring
                                           and dimension in coloring) else None
    facecolors = [colormod.to_rgba(colors[g] if colors is not None
                                   else colormod.cycle_color(i))
                  for i, g in enumerate(mean_rows)]
    hatch = dict(hatches[dimension]) if (hatches
                                         and dimension in hatches) else None
    hatch_list = hatch_colors = None
    if hatch:
        hatch_list = [hatch.get(g, "") for g in mean_rows]
        hatch_colors = facecolors
        facecolors = [c[:3] + (HATCH_ALPHA,) for c in facecolors]
    k = max(len(mean_rows), 1)
    w = BAR_WIDTH / k
    tick_pos = np.arange(len(labels))
    ax_pos = tick_pos - BAR_WIDTH * 0.5
    centers = np.array([ax_pos + (i + 0.5) * w
                        for i in range(len(mean_rows))]).reshape(mean.shape)
    heights = np.nan_to_num(mean, nan=0.0)
    ticks, ylim = bar_axis(heights, errors)
    scale = 1.0 if percent else 100.0
    return BarPlotData(
        groups=list(mean_rows), labels=labels, left=centers - w / 2,
        width=w, centers=centers, heights=heights, errors=errors,
        facecolors=facecolors, hatches=hatch_list, hatch_colors=hatch_colors,
        xlim=(ax_pos[0] - 0.25, ax_pos[-1] + 0.25 + BAR_WIDTH)
        if len(labels) else (-0.5, 0.5), yticks=ticks,
        yticklabels=[str(round(t / scale, 3)) if float(t) != 0.0 else "µ"
                     for t in ticks], ylim=ylim,
        ylabel=" ".join(metric.split(" ")[0].split("_")))


def generate_barplot(ds_task: str, metric: str, dimension: str,
                     dataset_dfs: Dict[str, ResultFrame],
                     results_plot_dir: Path, lower_better: bool = False,
                     percent: bool = False, df_naming=None, coloring=None,
                     hatches=None, ordering=None, filter_index=None) -> Path:
    """Draw the plot as ``<results_plot_dir>/<dimension>/<metric>.svg``
    (the JAX function's PNG path with ``.svg``); returns that path."""
    data = barplot_data(ds_task, metric, dimension, dataset_dfs,
                        lower_better=lower_better, percent=percent,
                        df_naming=df_naming, coloring=coloring,
                        hatches=hatches, ordering=ordering,
                        filter_index=filter_index)
    out_dir = Path(results_plot_dir) / dimension
    os.makedirs(out_dir, exist_ok=True)
    out_path = out_dir / f"{'_'.join(metric.lower().split(' '))}.svg"
    write_barplot(data, out_path)
    return out_path


def run_plots(plot_config: Dict) -> List[Path]:
    """Every plot of ``plot_config``; returns the SVGs' paths."""
    dataset_dfs: Dict[str, ResultFrame] = {}
    for dataset, table_config in plot_config["datasets"].items():
        table = DsTaskTable(table_config)
        mean_df, _ = table.create()
        if table_config.get("split_param"):
            for split_value in table_config["split_param"]["split_values"]:
                dataset_dfs[f"{dataset} {split_value.title()}"] = \
                    mean_df.xs(split_value)
        else:
            dataset_dfs[dataset] = mean_df

    paths = []
    for ds_task, task_config in plot_config["ds_tasks"].items():
        for metric, metric_config in task_config.items():
            for dimension in metric_config["levels"]:
                filter_ds = None
                if "filter" in metric_config and dimension in \
                        metric_config["filter"]:
                    filter_ds = [
                        (filter_dim, value)
                        for filter_dim, values in
                        metric_config["filter"][dimension].items()
                        for value in values]
                metric_names = (
                    [f"{metric} {s}"
                     for s in metric_config["dataset_splits"]]
                    if metric_config["dataset_splits"] is not None
                    else [metric])
                for metric_name in metric_names:
                    paths.append(generate_barplot(
                        ds_task=ds_task, metric=metric_name,
                        dimension=dimension,
                        dataset_dfs=copy.deepcopy(dataset_dfs),
                        lower_better=not metric_config["higher_better"],
                        percent=metric_config.get("percent", False),
                        filter_index=filter_ds,
                        df_naming=plot_config.get("df_naming"),
                        coloring=plot_config.get("coloring"),
                        hatches=plot_config.get("hatches"),
                        ordering=plot_config.get("ordering"),
                        results_plot_dir=Path(plot_config["save_path"])))
    return paths


def main(argv=None) -> None:
    import argparse
    from ...config import compose
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-dir", "-cd", default="configs/evaluation")
    parser.add_argument("--config-name", "-cn", default="plot_config")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = compose(args.config_dir, args.config_name, args.overrides)
    run_plots(cfg.to_container())


if __name__ == "__main__":
    main()
