"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program; names compared whole, since the
program's own name begins with the JAX package's."""
import ast
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "values_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_the_jax_side():
    for path in harness.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        assert "values_tpu_torch" not in set(_imports(path)), path
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.unet3d, benchmark.reference.hrnet, "
            "benchmark.reference.measures, benchmark.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'values_tpu_torch', 'values_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_cell_run_loads_no_jax_side():
    """Every driver's path at a small size, in a process of its own, with
    the whole-name check that run.py makes before it prints a result."""
    code = ("import sys; sys.path.insert(0, %r); "
            "sys.path.insert(0, %r); "
            "from conftest import run_small; "
            "from benchmark import harness; "
            "[run_small(w) for w in ('unet3d-ens5-score-b32-bf16', "
            "'unet3d-train-b8-f32', 'hrnet-w48-ens5-test2d-b6-f32')]; "
            "print(harness.forbidden_modules())"
            % (str(harness.ROOT), str(harness.BENCH_DIR / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "values_tpu_torch_x", sys)
    assert "values_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "values_tpu.core", sys)
    assert harness.forbidden_modules() == ["values_tpu"]


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable,
                          str(harness.BENCH_DIR / "run.py"), "--workload",
                          "unet3d-ens5-score-b32-bf16", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
