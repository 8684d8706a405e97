"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds it by; a cell added as files alone is
found."""
import json
import re
import shutil

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_contract(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.add(w["name"])
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        moves = next(e for e in bench["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves.get("workloads", cells))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:      # setup_s, another end-to-end and a layer metric
        e2e = [m["name"] for m in harness.cell_metrics(bench, cell,
                                                        "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(bench, cell, "per_layer")
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_name_resolves(bench):
    for w in bench["workloads"]:
        cell, cfg, trf = harness.resolve(bench, w["name"])
        assert harness.driver(trf["driver"]).setup
        assert set(trf["limits"])
        for key in ("source", "reduced", "assumed"):
            assert key in cfg
    for m in bench["end_to_end"]:
        assert harness.reader("end_to_end", m["name"]).read
    for m in bench["per_layer"]:
        assert harness.reader("metrics", m["name"]).read
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()


def test_new_cell_found_from_files_alone(tmp_path, bench):
    """A copy of the benchmark gains a cell by a new traffic file and an
    entry in BENCHMARK.json: the harness finds and runs it unedited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((harness.BENCH_DIR / "traffic" /
                          "score-b32.json").read_text())
    traffic["batch"] = 3
    (root / "benchmark" / "traffic" / "score-b3.json").write_text(
        json.dumps(traffic))
    new = dict(bench)
    new["workloads"] = bench["workloads"] + [
        {"name": "unet3d-ens5-score-b3-bf16", "config": "unet3d-f8-lidc64",
         "traffic": "score-b3", "chips": 1, "why": "three volumes a call"}]
    for m in new["end_to_end"] + new["per_layer"]:
        if "unet3d-ens5-score-b32-bf16" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["unet3d-ens5-score-b3-bf16"]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    loaded = harness.load_benchmark(root)
    cell, cfg, trf = harness.resolve(loaded, "unet3d-ens5-score-b3-bf16",
                                     root)
    assert trf["batch"] == 3 and cfg["scoring"]["members"] == 5
    names = [m["name"] for m in harness.cell_metrics(
        loaded, "unet3d-ens5-score-b3-bf16", "end_to_end")]
    assert names == ["scored_volumes_per_s", "score_batch_ms_p95",
                     "setup_s"]
    from conftest import SMALL
    SMALL[trf["driver"]](cfg, trf)
    trf["batch"] = 3
    out = harness.run_cell(loaded, "unet3d-ens5-score-b3-bf16", 5, 0.2,
                           False, device="cpu", root=root, config=cfg,
                           traffic=trf, log=lambda m: None)
    assert out["correct"] and out["attempted"] % 3 == 0
    assert list(out)[-1] == "checks"
