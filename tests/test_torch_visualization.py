"""The port's reporting layer (values_tpu_torch.evaluation.visualization)
against the JAX package's (values_tpu.evaluation.visualization) on the
same task JSONs, written with numpy from a seed: four result trees --
(a) three models, two seeds, one split; (b) eval_config_lidc's layout
(split_param with two shifts, levels 1, 2 and 3, al_improvement); (c)
the GTA layout with Dropout-Final; (d) one seed (NaN stds, grey cells) --
give the same cells (1e-12, the same NaNs) and the same LaTeX text; the
bar data equals the JAX figure's (read from ``plt.gca()`` with
``plt.close`` a no-op) to 1e-9 over dimension x lower/higher-better x
percent, each with six sets of filter, ordering, colouring and hatches
that hold every pair of those four on and off, on two datasets; the
SVGs parse; run_plots and both CLIs write the JAX file set (SVG for PNG)
and print its table."""
import contextlib
import copy
import io
import json
import warnings
import xml.etree.ElementTree as ET
from pathlib import Path

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.container import BarContainer  # noqa: E402

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu.config import compose as jax_compose  # noqa: E402
from values_tpu.evaluation.visualization import (  # noqa: E402
    ds_task_barplots as J_BP, ds_task_table as J_TT)
from values_tpu_torch.config import compose  # noqa: E402
from values_tpu_torch.evaluation.visualization import (  # noqa: E402
    colors, ds_task_barplots as P_BP, ds_task_table as P_TT, latex, ticks)

ROOT = Path(__file__).resolve().parents[1]
EVAL_CONFIGS = ROOT / "configs" / "evaluation"
UNC = ["predictive_uncertainty", "aleatoric_uncertainty",
       "epistemic_uncertainty"]
AGGS = ["patch_level", "threshold"]
SMALL_TASKS = {
    "seg_performance": {"dice": {
        "metrics_file_name": "metrics.json", "metrics_key": "dice",
        "dataset_splits": ["id"], "levels": ["pred_model"],
        "higher_better": True}},
    "ood_detection": {"auroc": {
        "metrics_file_name": "ood_detection.json", "metrics_key": "auroc",
        "dataset_splits": None,
        "levels": ["pred_model", "unc_type", "aggregation"],
        "higher_better": True}},
    "failure_detection": {
        name: {"metrics_file_name": "failure_detection.json",
               "metrics_key": name, "dataset_splits": ["id"],
               "levels": ["pred_model", "unc_type", "aggregation"],
               "higher_better": False} for name in ("aurc", "eaurc")},
    "calibration": {"ace": {
        "metrics_file_name": "calibration.json", "metrics_key": "ace",
        "dataset_splits": ["id"], "levels": ["pred_model", "unc_type"],
        "higher_better": False}},
}


def small_config(base, seeds):
    models = ["Softmax", "Ensemble", "SSN"]
    return {"base_path": str(base), "ds_tasks": SMALL_TASKS, "experiments": [{
        "iter_params": {"pred_model": models, "seed": seeds},
        "case": 1, "image_ending": ".nii.gz", "unc_ending": ".nii.gz",
        "n_reference_segs": 2, "epochs": 2,
        "naming_scheme_pred_model": "{pred_model}-Case-{case}",
        "prediction_models": {m: {
            "naming_scheme_version": "epochs{epochs}_seed{seed}",
            "unc_types": UNC[:1] if m == "Softmax" else UNC,
            "aggregations": AGGS} for m in models}}]}


def write_tree(config, rng, nan_at=None):
    """Every task JSON ``config``'s table reads, with uniform values; the
    levels-1 metrics directly under ``mean`` (as test_3d writes them), the
    others under ``metrics`` sub-dicts (as the tasks write them);
    ``nan_at`` = (model, metric) gets one NaN (R3's NCC)."""
    table = J_TT.DsTaskTable(config)
    files = {}
    for v in table.versions:
        for metrics in config["ds_tasks"].values():
            for name, probs in metrics.items():
                for split in probs["dataset_splits"] or [None]:
                    path = v.exp_path if split is None else v.exp_path / split
                    mean = files.setdefault(path / probs[
                        "metrics_file_name"], {"mean": {}})["mean"]
                    key, levels = probs["metrics_key"], len(probs["levels"])

                    def value():
                        if nan_at == (v.pred_model, key) and split == "ood":
                            return float("nan")
                        return float(rng.uniform(0, 1))

                    if levels == 1:
                        mean[key] = value()
                        continue
                    for unc in v.unc_types:
                        if name == "al_improvement" and unc == UNC[1]:
                            continue
                        node = mean.setdefault(unc, {})
                        if levels == 2:
                            node.setdefault("metrics", {})[key] = value()
                        else:
                            for agg in v.aggregations:
                                node.setdefault(agg, {}).setdefault(
                                    "metrics", {})[key] = value()
    for path, content in files.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(content))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("reporting")
    small = small_config(root / "a", ["123", "124"])
    write_tree(small, rng)
    lidc = jax_compose(str(EVAL_CONFIGS), "table_config_lidc",
                       [f"base_path={root / 'LIDC'}"]).to_container()
    write_tree(lidc, rng, nan_at=("Ensemble", "ncc"))
    gta = jax_compose(str(EVAL_CONFIGS), "table_config_gta",
                      [f"base_path={root / 'GTA'}"]).to_container()
    write_tree(gta, rng)
    one_seed = jax_compose(str(EVAL_CONFIGS), "table_config_lidc",
                           [f"base_path={root / 'LIDC'}",
                            "LIDC.iter_params.seed=['123']"]).to_container()
    return {"a": small, "b": lidc, "c": gta, "d": one_seed, "root": root}


@pytest.fixture(scope="module")
def tables(trees):
    """Each tree's JAX and port (mean, std) frames and LaTeX texts."""
    out = {}
    for case in "abcd":
        jt, pt = J_TT.DsTaskTable(trees[case]), P_TT.DsTaskTable(trees[case])
        jm, js = jt.create()
        pm, ps = pt.create()
        with contextlib.redirect_stdout(io.StringIO()) as jout:
            jtex = jt.to_latex(jm.copy(), js.copy())
        with contextlib.redirect_stdout(io.StringIO()) as pout:
            ptex = pt.to_latex(pm, ps)
        out[case] = (jm, js, pm, ps, jtex, ptex, jout.getvalue(),
                     pout.getvalue())
    return out


@pytest.mark.parametrize("case", "abcd")
def test_table_cells_match_jax(tables, case):
    jm, js, pm, ps = tables[case][:4]
    for j, p in ((jm, pm), (js, ps)):
        assert p.index == list(j.index)
        assert p.index_names == list(j.index.names)
        assert p.columns == list(j.columns)
        np.testing.assert_array_equal(np.isnan(p.values),
                                      np.isnan(j.to_numpy()))
        np.testing.assert_allclose(p.values, j.to_numpy(), rtol=0,
                                   atol=1e-12)
    if case == "c":
        assert "Dropout" in pm.level(pm.index_names[0])
        assert "Dropout-Final" not in pm.level(pm.index_names[0])
    if case == "d":
        assert np.isnan(ps.values).all()
    if case in "bd":   # al_improvement leaves the aleatoric rows empty
        col = pm.columns.index(("active_learning", "al_improvement ood"))
        alea = [r for r, row in enumerate(pm.index) if row[-2] == UNC[1]]
        assert alea and np.isnan(pm.values[alea, col]).all()


@pytest.mark.parametrize("case", "abcd")
def test_latex_equals_jax(tables, case):
    jtex, ptex, jout, pout = tables[case][4:]
    assert ptex == jtex
    assert pout == jout
    if case in "bd":
        assert r"{\cellcolor[HTML]{D3D3D3}}" in ptex
    if case == "b":
        assert r"\multirow[c]" in ptex and r"\multicolumn{2}{c}" in ptex


def test_colour_data_matches_matplotlib():
    cmap = matplotlib.colormaps["YlOrRd"]
    x = np.concatenate([np.linspace(0, 1, 1001), [np.nan, -1e-9, 1.5]])
    np.testing.assert_array_equal(colors.ylorrd(x), cmap(x))
    for name, hexcode in colors.TABLEAU_COLORS.items():
        assert colors.to_rgba(name) == matplotlib.colors.to_rgba(name)
        assert colors.rgb2hex(colors.to_rgba(hexcode)) == hexcode
    assert list(colors.TAB10_CYCLE) == [
        c["color"] for c in matplotlib.rcParams["axes.prop_cycle"]]
    rgba = cmap(np.linspace(0, 1, 257))
    assert [colors.rgb2hex(c) for c in rgba] == [
        matplotlib.colors.rgb2hex(c) for c in rgba]
    # pandas' background_gradient over one column, NaN and constant maps
    import pandas as pd
    from pandas.io.formats.style import _background_gradient
    rng = np.random.RandomState(2)
    for gmap in ([3.0, np.nan, -1.0, 2.5], [7.0] * 3, [7.0, np.nan],
                 [np.nan] * 2, list(rng.normal(size=50))):
        with np.errstate(all="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = _background_gradient(pd.Series(np.zeros(len(gmap))),
                                        cmap="YlOrRd", gmap=gmap)
        got = [f"background-color: {b};color: {t};"
               for b, t in latex.gradient_styles(gmap)]
        assert got == want


def test_tick_locator_matches_matplotlib():
    """MaxNLocator (as AutoLocator sets it) on ranges of every scale."""
    loc = matplotlib.ticker.MaxNLocator(nbins=9, steps=[1, 2, 2.5, 5, 10])
    rng = np.random.RandomState(1)
    for _ in range(300):
        lo = rng.uniform(-1, 1) * 10 ** rng.randint(-6, 7)
        hi = lo + rng.uniform(0, 1) * 10 ** rng.randint(-8, 7)
        np.testing.assert_array_equal(ticks.tick_values(lo, hi, 9),
                                      loc.tick_values(lo, hi))


FILTERS = {"unc_type": [("pred_model", "Softmax")],
           "pred_model": [("unc_type", UNC[1])],
           "aggregation": [("unc_type", UNC[1]), ("unc_type", UNC[2])]}
ORDERING = {"pred_model": ["SSN", "Softmax", "Dropout", "Ensemble", "TTA"],
            "unc_type": UNC[::-1], "aggregation": AGGS[::-1]}
COLORING = {"pred_model": {"Softmax": "tab:cyan", "Dropout": "#123456",
                           "Ensemble": (0.2, 0.4, 0.6), "TTA": "tab:olive",
                           "SSN": "tab:pink"},
            "unc_type": {UNC[0]: "tab:olive", UNC[1]: "tab:cyan",
                         UNC[2]: "tab:pink"},
            "aggregation": {"patch_level": "tab:red",
                            "threshold": "#0a0b0c80"}}
HATCHES = {"pred_model": {"Softmax": "//", "Dropout": "xx",
                          "Ensemble": "--", "TTA": "\\\\"},
           "unc_type": {UNC[0]: "--", UNC[1]: "//", UNC[2]: "oo"},
           "aggregation": {"patch_level": "//", "threshold": "xx"}}
# option sets, bits filter 1, ordering 2, colouring 4, hatches 8: none, all,
# and four that give each pair of the options all four on/off states
OPTION_SETS = (0, 15, 3, 12, 5, 10)
PLOTS = [(dim, lower, percent, opts)
         for dim in ("pred_model", "unc_type", "aggregation")
         for lower in (True, False) for percent in (False, True)
         for opts in OPTION_SETS]


def jax_figure(**kwargs):
    """The JAX plot's axes, left open (``plt.close`` a no-op), neither
    laid out nor saved (``tight_layout`` and ``savefig`` no-ops: they
    move no number compared here, all set before them)."""
    saved = plt.close, plt.savefig, plt.tight_layout
    plt.close("all")
    plt.close = plt.savefig = plt.tight_layout = lambda *a, **k: None
    try:
        J_BP.generate_barplot(**kwargs)
        return plt.gca()
    finally:
        plt.close, plt.savefig, plt.tight_layout = saved


def figure_numbers(ax):
    bars = [c for c in ax.containers if isinstance(c, BarContainer)]
    out = {"left": [], "width": [], "height": [], "face": [], "hatch": [],
           "hatch_color": [], "center": [], "error": []}
    for c in bars:
        out["left"].append([p.get_x() for p in c.patches])
        out["width"].append([p.get_width() for p in c.patches])
        out["height"].append([p.get_height() for p in c.patches])
        out["face"].append([p.get_facecolor() for p in c.patches])
        out["hatch"].append([p.get_hatch() for p in c.patches])
        out["hatch_color"].append([getattr(p, "_hatch_color", None)
                                   for p in c.patches])
        if c.errorbar is None:
            out["error"].append([np.nan] * len(c.patches))
            out["center"].append([p.get_x() + p.get_width() / 2
                                  for p in c.patches])
        else:
            segs = c.errorbar.lines[2][0].get_segments()
            out["error"].append([(s[1, 1] - s[0, 1]) / 2 for s in segs])
            out["center"].append([s[0, 0] for s in segs])
    out["xticklabels"] = [t.get_text() for t in ax.get_xticklabels()]
    out["yticks"] = list(ax.get_yticks())
    out["yticklabels"] = [t.get_text() for t in ax.get_yticklabels()]
    out["ylim"], out["xlim"] = ax.get_ylim(), ax.get_xlim()
    out["ylabel"] = ax.get_ylabel()
    return out


@pytest.fixture(scope="module")
def two_datasets(tables):
    """The LIDC tree's two shifts, as run_plots splits them."""
    jm, pm = tables["b"][0], tables["b"][2]
    return ({f"LIDC {s.title()}": jm.loc[s] for s in ("texture",
                                                      "malignancy")},
            {f"LIDC {s.title()}": pm.xs(s) for s in ("texture",
                                                     "malignancy")})


@pytest.mark.parametrize("dim,lower,percent,opts", PLOTS)
def test_barplot_data_matches_jax_figure(two_datasets, tmp_path, dim, lower,
                                         percent, opts):
    jax_dfs, port_dfs = two_datasets
    metric = ("failure_detection", "aurc ood") if lower else (
        "ood_detection", "auroc")
    kwargs = dict(
        ds_task=metric[0], metric=metric[1], dimension=dim,
        lower_better=lower, percent=percent,
        df_naming={"LIDC Texture": "LIDC Tex"},
        filter_index=FILTERS[dim] if opts & 1 else None,
        ordering=ORDERING if opts & 2 else None,
        coloring=COLORING if opts & 4 else None,
        hatches=HATCHES if opts & 8 else None)
    ax = jax_figure(dataset_dfs=copy.deepcopy(jax_dfs),
                    results_plot_dir=tmp_path / "jax", **kwargs)
    want = figure_numbers(ax)
    plt.close("all")
    before = {k: v.values.copy() for k, v in port_dfs.items()}
    got = P_BP.barplot_data(dataset_dfs=port_dfs, **kwargs)
    for k, v in port_dfs.items():   # the frames are left as they were
        np.testing.assert_array_equal(v.values, before[k])

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a, dtype=float),
                                   np.asarray(b, dtype=float), rtol=0,
                                   atol=1e-9)

    close(got.left, want["left"])
    close(np.full(got.heights.shape, got.width), want["width"])
    close(got.heights, want["height"])
    close(got.centers, want["center"])
    close(got.errors, want["error"])
    face = [[c] * len(got.labels) for c in got.facecolors]
    close(face, want["face"])
    if kwargs["hatches"] and dim in HATCHES:
        assert [[h] * len(got.labels) for h in got.hatches] == want["hatch"]
        close([[c] * len(got.labels) for c in got.hatch_colors],
              want["hatch_color"])
    else:
        assert got.hatches is None
        assert all(h is None for row in want["hatch"] for h in row)
    assert got.labels == want["xticklabels"]
    close(got.yticks, want["yticks"])
    assert got.yticklabels == want["yticklabels"]
    close(got.ylim, want["ylim"])
    close(got.xlim, want["xlim"])
    assert got.ylabel == want["ylabel"]
    # the figure: one bar a (group, dataset), one error bar a finite std
    out = P_BP.generate_barplot(dataset_dfs=port_dfs,
                                results_plot_dir=tmp_path / "port",
                                **kwargs)
    assert out == (tmp_path / "port" / dim
                   / f"{metric[1].replace(' ', '_')}.svg")
    svg = ET.parse(out).getroot()
    ns = "{http://www.w3.org/2000/svg}"
    bars = [e for e in svg.iter(f"{ns}rect") if e.get("class") == "bar"]
    errors = [e for e in svg.iter(f"{ns}g") if e.get("class") == "errorbar"]
    assert len(bars) == got.heights.size
    assert {(b.get("data-group"), b.get("data-dataset")) for b in bars} == {
        (g, lab) for g in got.groups for lab in got.labels}
    assert len(errors) == np.isfinite(got.errors).sum()
    texts = ["".join(t.itertext()) for t in svg.iter(f"{ns}text")
             if t.get("class") == "ytick"]
    assert texts == [lab for t, lab in zip(got.yticks, got.yticklabels)
                     if got.ylim[0] <= t <= got.ylim[1]]


@pytest.fixture(scope="module")
def cli_runs(trees, tmp_path_factory):
    """The JAX and port mains of both CLIs on the LIDC tree."""
    root = tmp_path_factory.mktemp("cli")
    lidc = str(trees["root"] / "LIDC")
    out = {}
    for name, table_main, plot_main in (
            ("jax", J_TT.main, J_BP.main), ("port", P_TT.main, P_BP.main)):
        save = root / name
        with contextlib.redirect_stdout(io.StringIO()) as text:
            table_main(["-cd", str(EVAL_CONFIGS), "-cn", "table_config_lidc",
                        f"base_path={lidc}"])
        plot_main(["-cd", str(EVAL_CONFIGS), "-cn", "plot_config",
                   f"datasets.LIDC.base_path={lidc}", f"save_path={save}"])
        out[name] = (text.getvalue(), save)
    return out


def _files(root: Path, suffix: str):
    return sorted(str(p.relative_to(root).with_suffix(""))
                  for p in root.rglob(f"*{suffix}"))


def test_cli_mains_match_jax(cli_runs):
    (jtext, jsave), (ptext, psave) = cli_runs["jax"], cli_runs["port"]
    assert ptext == jtext and "\\begin{tabular}" in ptext
    assert _files(psave, ".svg") == _files(jsave, ".png")
    assert len(_files(psave, ".svg")) == 17 and not _files(psave, ".png")
    for path in psave.rglob("*.svg"):
        ET.parse(path)


def test_run_plots_writes_the_jax_file_set(cli_runs, trees, tmp_path):
    cfg = compose(str(EVAL_CONFIGS), "plot_config", [
        f"datasets.LIDC.base_path={trees['root'] / 'LIDC'}",
        f"save_path={tmp_path}"]).to_container()
    paths = P_BP.run_plots(cfg)
    assert sorted(str(p.relative_to(tmp_path).with_suffix(""))
                  for p in paths) == _files(cli_runs["jax"][1], ".png")
