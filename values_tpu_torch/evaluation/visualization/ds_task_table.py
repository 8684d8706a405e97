"""Results table: (pred_model, unc_measure, unc_type, aggregation) x
(task, metric split), mean ± std across seeds, styled LaTeX output.

The port's counterpart of ``values_tpu/evaluation/visualization/
ds_task_table.py`` (reference: evaluation/visualization/ds_task_table.py:
14-533), without pandas: the frames are :class:`ResultFrame`\\ s, a list
of row labels, a list of column labels and a float64 array, and the LaTeX
is written by :mod:`.latex`. The JAX class's rules, in its order:

- versions grouped by the naming scheme without the seed placeholder;
- per-metric registry entries {metrics_file_name, metrics_key,
  dataset_splits, levels, higher_better} (tasks/table_tasks.yaml); 1, 2
  or 3 levels, ``al_improvement`` without ``aleatoric_uncertainty``
  (:135-137), ``"metrics"`` sub-dicts read through;
- each cell the mean and ``std(ddof=1)`` over the group's seeds (one
  seed gives a NaN std);
- unc-measure relabeling: Softmax -> MSR; SSN swaps MI/EE; everyone else
  PE/EE/MI (:156-165);
- x100 scaling; ``split_param`` tables concatenated under the split name;
  ``Dropout-Final`` renamed ``Dropout`` where it is in the first level;
- ``mean±std`` cells after ``round(2)``, per-column YlOrRd gradients
  (reversed for higher-better), NaN cells grey.

CLI (host only; composes as the JAX ``main``):
    python -m values_tpu_torch.evaluation.visualization.ds_task_table \\
        -cn table_config_lidc [key=value ...]
"""
from __future__ import annotations

import json
import warnings
from itertools import groupby, product
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..experiment_version import ExperimentVersion
from .latex import gradient_styles, styler_latex

INDEX_NAMES = [("", "pred_model"), ("", "unc_measure"), ("", "unc_type"),
               ("", "aggregation")]


class ResultFrame:
    """A table of floats with row labels (tuples, one entry a level, under
    ``index_names``) and column labels ``(task, "metric split")``."""

    def __init__(self, index: List[tuple], index_names: List,
                 columns: List[tuple], values: np.ndarray):
        self.index = [tuple(row) for row in index]
        self.index_names = list(index_names)
        self.columns = [tuple(col) for col in columns]
        self.values = np.asarray(values, dtype=float).reshape(
            len(self.index), len(self.columns))

    def column(self, col: tuple) -> np.ndarray:
        """The column's values (a view)."""
        return self.values[:, self.columns.index(tuple(col))]

    def level(self, name) -> List:
        """The labels of the index level ``name``, row by row."""
        i = self.index_names.index(name)
        return [row[i] for row in self.index]

    def rows(self, keep: Sequence[bool]) -> "ResultFrame":
        keep = np.asarray(keep, dtype=bool)
        return ResultFrame([r for r, k in zip(self.index, keep) if k],
                           self.index_names, self.columns, self.values[keep])

    def xs(self, key) -> "ResultFrame":
        """The rows whose first label is ``key``, without that level (the
        JAX package's ``frame.loc[key]``)."""
        keep = [row[0] == key for row in self.index]
        if not any(keep):
            raise KeyError(key)
        picked = self.rows(keep)
        return ResultFrame([row[1:] for row in picked.index],
                           self.index_names[1:], self.columns, picked.values)


def _mean_std(values) -> tuple:
    values = np.array(values, dtype=float)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.mean(values)), float(np.std(values, ddof=1))


class DsTaskTable:
    def __init__(self, config: Dict):
        self.base_path = Path(config["base_path"])
        self.versions = self._init_versions(config)
        self.grouped_versions = self._group_versions("seed")
        self.split_param = config.get("split_param")
        self.ds_tasks = config["ds_tasks"]

    # -- version grid ----------------------------------------------------
    def _init_versions(self, config) -> List[ExperimentVersion]:
        versions = []
        for experiment in config["experiments"]:
            iter_lists = [[(k, v) for v in values]
                          for k, values in experiment["iter_params"].items()]
            for params in product(*iter_lists):
                version_params = {k: v for k, v in params}
                exp_config = {k: v for k, v in experiment.items()
                              if k != "iter_params"}
                version_params.update(exp_config)
                version_params["base_path"] = self.base_path
                version_params.update(dict(
                    experiment["prediction_models"][
                        version_params["pred_model"]]))
                version_params.pop("prediction_models", None)
                versions.append(ExperimentVersion(**version_params))
        return versions

    def _group_key(self, version: ExperimentVersion, param: str):
        scheme = version.naming_scheme_version.replace(
            f"{param}{{{param}}}", "")
        return version.pred_model, scheme.format(**version.version_params)

    def _group_versions(self, param: str) -> List[List[ExperimentVersion]]:
        return [list(group) for _, group in groupby(
            self.versions, key=lambda v: self._group_key(v, param))]

    # -- table skeleton ---------------------------------------------------
    def _columns(self) -> List[tuple]:
        cols = []
        for ds_task, metrics in self.ds_tasks.items():
            for metric_name, probs in metrics.items():
                splits = probs["dataset_splits"]
                if splits is not None:
                    cols.extend((ds_task, f"{metric_name} {s}")
                                for s in splits)
                else:
                    cols.append((ds_task, metric_name))
        return cols

    def get_base_df(self, grouped_versions) -> ResultFrame:
        rows = []
        for group in grouped_versions:
            v = group[0]
            for unc_type in v.unc_types:
                for aggregation in v.aggregations:
                    rows.append((v.pred_model, unc_type, aggregation))
        columns = self._columns()
        return ResultFrame(rows, [INDEX_NAMES[0]] + INDEX_NAMES[2:], columns,
                           np.full((len(rows), len(columns)), np.nan))

    # -- filling ----------------------------------------------------------
    @staticmethod
    def _metric_from(entry: Dict, key: str) -> float:
        if "metrics" in entry:
            return entry["metrics"][key]
        return entry[key]

    def fill_single_metric(self, mean_df: ResultFrame, std_df: ResultFrame,
                           ds_task, metric_name, probs, versions,
                           dataset_split) -> None:
        metric_dicts = []
        for version in versions:
            path = version.exp_path
            if dataset_split is not None:
                path = path / dataset_split
            with open(path / probs["metrics_file_name"]) as f:
                metric_dicts.append(json.load(f))
        v = versions[0]
        col = mean_df.columns.index(
            (ds_task, f"{metric_name} {dataset_split}"
             if dataset_split is not None else metric_name))
        levels = probs["levels"]
        key = probs["metrics_key"]

        def put(selector, values):
            # every row under the selector, in the configured row order
            m, s = _mean_std(values)
            for r, row in enumerate(mean_df.index):
                if row[:len(selector)] == selector:
                    mean_df.values[r, col] = m
                    std_df.values[r, col] = s

        if len(levels) == 1:
            put((v.pred_model,),
                [self._metric_from(d["mean"], key) for d in metric_dicts])
        elif len(levels) == 2:
            for unc_type in v.unc_types:
                put((v.pred_model, unc_type),
                    [self._metric_from(d["mean"][unc_type], key)
                     for d in metric_dicts])
        else:
            unc_types = v.unc_types
            if metric_name == "al_improvement":
                unc_types = [u for u in unc_types
                             if u != "aleatoric_uncertainty"]
            for unc_type in unc_types:
                for aggregation in v.aggregations:
                    put((v.pred_model, unc_type, aggregation),
                        [self._metric_from(
                            d["mean"][unc_type][aggregation], key)
                         for d in metric_dicts])

    def fill_all_metrics(self, mean_df, std_df, versions) -> None:
        for ds_task, metrics in self.ds_tasks.items():
            for metric_name, probs in metrics.items():
                splits = probs["dataset_splits"] or [None]
                for dataset_split in splits:
                    self.fill_single_metric(mean_df, std_df, ds_task,
                                            metric_name, probs, versions,
                                            dataset_split)

    # -- unc-measure relabeling (reference ds_task_table.py:297-313) --------
    @staticmethod
    def get_unc_measure(pred_model: str, unc_type: str) -> str:
        if pred_model == "Softmax":
            return "MSR"
        if unc_type == "predictive_uncertainty":
            return "PE"
        if pred_model == "SSN":
            return "MI" if unc_type == "aleatoric_uncertainty" else "EE"
        return "EE" if unc_type == "aleatoric_uncertainty" else "MI"

    def _add_unc_measure(self, df: ResultFrame) -> ResultFrame:
        index = [(m, self.get_unc_measure(m, u), u, a)
                 for m, u, a in df.index]
        return ResultFrame(index, INDEX_NAMES, df.columns, df.values)

    def create_single_table(self, grouped_versions):
        mean_df = self.get_base_df(grouped_versions)
        std_df = self.get_base_df(grouped_versions)
        for group in grouped_versions:
            self.fill_all_metrics(mean_df, std_df, group)
        mean_df = self._add_unc_measure(mean_df)
        std_df = self._add_unc_measure(std_df)
        mean_df.values *= 100
        std_df.values *= 100
        return mean_df, std_df

    def create(self):
        """(mean, std) frames, rows in the configured order."""
        if self.split_param is not None:
            name = self.split_param["name"]
            parts = []
            for split_value in self.split_param["split_values"]:
                filtered = [g for g in self.grouped_versions
                            if g[0].version_params[name] == split_value]
                parts.append((split_value,
                              self.create_single_table(filtered)))

            def concat(which: int) -> ResultFrame:
                frames = [(key, tables[which]) for key, tables in parts]
                return ResultFrame(
                    [(key,) + row for key, f in frames for row in f.index],
                    [name] + INDEX_NAMES, frames[0][1].columns,
                    np.concatenate([f.values for _, f in frames]))

            mean_df, std_df = concat(0), concat(1)
        else:
            mean_df, std_df = self.create_single_table(self.grouped_versions)
        for df in (mean_df, std_df):
            if "Dropout-Final" in df.level(df.index_names[0]):
                df.index = [("Dropout",) + row[1:]
                            if row[0] == "Dropout-Final" else row
                            for row in df.index]
        return mean_df, std_df

    # -- LaTeX -------------------------------------------------------------
    @staticmethod
    def format_mean_std(mean: float, std: float) -> str:
        """``round(2)`` of each, printed as ``str`` prints a float."""
        return (f"{str(np.round(np.float64(mean), 2))}±"
                f"{str(np.round(np.float64(std), 2))}")

    def _gradient_cells(self):
        cells, cells_reverse = [], []
        for ds_task, metrics in self.ds_tasks.items():
            for metric, probs in metrics.items():
                names = ([f"{metric} {s}" for s in probs["dataset_splits"]]
                         if probs["dataset_splits"] is not None else [metric])
                target = cells_reverse if probs["higher_better"] else cells
                target.extend((ds_task, n) for n in names)
        return cells, cells_reverse

    def to_latex(self, mean_df: ResultFrame, std_df: ResultFrame) -> str:
        texts = [[self.format_mean_std(m, s) for m, s in zip(mrow, srow)]
                 for mrow, srow in zip(mean_df.values, std_df.values)]
        styles: List[List[Optional[tuple]]] = [
            [None] * len(mean_df.columns) for _ in mean_df.index]
        cells, cells_reverse = self._gradient_cells()
        for cell, sign in ([(c, -1) for c in cells_reverse]
                           + [(c, 1) for c in cells]):
            if cell in mean_df.columns:
                c = mean_df.columns.index(cell)
                for r, style in enumerate(gradient_styles(
                        mean_df.values[:, c] * sign)):
                    styles[r][c] = style
        names = [n if isinstance(n, str) else n[1]
                 for n in mean_df.index_names]
        column_format = ("l|" * len(names) + "|"
                         + "l|" * len(mean_df.columns))[:-1]
        latex = styler_latex(mean_df.index, names, mean_df.columns, texts,
                             styles, column_format)
        latex = latex.replace("_", r"\_")
        latex = latex.replace(r"\centering", r"\centering \tiny")
        latex = latex.replace(
            r"{\cellcolor[HTML]{000000}} \color[HTML]{F1F1F1} nan±nan",
            r"{\cellcolor[HTML]{D3D3D3}}")
        print(latex)
        return latex


def main(argv=None) -> None:
    import argparse
    from ...config import compose
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-dir", "-cd", default="configs/evaluation")
    parser.add_argument("--config-name", "-cn", default="table_config_lidc")
    parser.add_argument("overrides", nargs="*", default=[])
    args = parser.parse_args(argv)
    cfg = compose(args.config_dir, args.config_name, args.overrides)
    table = DsTaskTable(cfg.to_container())
    mean_df, std_df = table.create()
    table.to_latex(mean_df, std_df)


if __name__ == "__main__":
    main()
