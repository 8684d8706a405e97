"""The port stands alone: no module of values_tpu_torch, nor chip_smoke
or the port's probe script, imports jax or the JAX package (nor yaml, until a config is composed),
nor cv2, PIL, scikit-learn, pandas, matplotlib or seaborn, which the
card's machine lacks; and its entry points refuse to run on the CPU
unless asked to."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from torch_parallel_cases import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "values_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "probe_k1_cuda.py"]


def _module_names():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names + ["chip_smoke"]


def test_every_module_imports_with_jax_blocked():
    """Each module imports in a fresh interpreter where ``import jax``,
    ``import yaml``, ``import cv2``, ``import PIL``, ``import sklearn``,
    ``import pandas``, ``import matplotlib`` and ``import seaborn`` fail;
    chip_smoke is imported, not run."""
    code = ("import sys, importlib\n"
            "assert 'jax' not in sys.modules\n"
            "for blocked in ('jax', 'yaml', 'cv2', 'PIL', 'sklearn',"
            " 'pandas', 'matplotlib', 'seaborn'):\n"
            "    sys.modules[blocked] = None\n"
            f"for name in {_module_names()!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'values_tpu' or m.startswith('values_tpu.')"
            " for m in sys.modules), 'the JAX package was imported'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_parallel_package_is_checked_and_imports_inertly():
    """The parallel layer (values_tpu_torch/parallel/) is among the
    modules above, and importing it joins no torch.distributed world and
    starts no process: a world exists only where an entry point was asked
    for several devices."""
    names = _module_names()
    for module in ("collectives", "launch", "mesh", "spatial"):
        assert f"values_tpu_torch.parallel.{module}" in names
    code = ("import multiprocessing, torch.distributed as dist\n"
            "import values_tpu_torch.parallel, "
            "values_tpu_torch.parallel.launch, "
            "values_tpu_torch.parallel.spatial\n"
            "assert not dist.is_initialized()\n"
            "assert not multiprocessing.active_children()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for key in ("WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS"):
        env.pop(key, None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_values_tpu_import(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "values_tpu", "cv2",
                            "PIL", "sklearn", "pandas", "matplotlib",
                            "seaborn"), (
            f"{path.name} imports {name}")


def test_entry_point_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    from values_tpu_torch.core.device import resolve_device
    from values_tpu_torch.inference.score import run_score, score_cli
    from values_tpu_torch.inference import test_3d
    from values_tpu_torch.inference.scoring import (make_aleatoric_scorer,
                                                    make_scorer)
    from values_tpu_torch.training.main import main as train_main
    make_scorer(2, 16, device="cpu")
    make_aleatoric_scorer(2, 16, device="cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    args = score_cli(["--checkpoint_paths", str(tmp_path / "none.ckpt"),
                      "--out", str(tmp_path / "s.json")])
    assert args.device == "cuda"
    test_args = test_3d.test_cli(["--checkpoint_paths",
                                  str(tmp_path / "none.ckpt")])
    assert test_args.device == "cuda"
    if torch.cuda.is_available():
        make_scorer(2, 16)
        make_aleatoric_scorer(2, 16)
        assert resolve_device(None).type == "cuda"
    else:
        for build in (make_scorer, make_aleatoric_scorer):
            with pytest.raises(RuntimeError):
                build(2, 16)
        # the CLI refuses before it reads a checkpoint
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_score(args)
        # the joint ensemble trainer refuses before it builds anything
        from values_tpu_torch.config import make_config
        from values_tpu_torch.training.ensemble import EnsembleTrainer
        with pytest.raises(RuntimeError, match="no CUDA device"):
            EnsembleTrainer(make_config({"model": {
                "_target_": "values_tpu.models.unet3d.UNet3D",
                "num_classes": 2}}), 2)
        # the sliding-window CLI refuses before it reads a checkpoint
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_3d.run_test(test_args)
        # the training CLI refuses before it touches the data
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main([f"data_input_dir={tmp_path / 'none'}",
                        f"save_dir={tmp_path / 'exp'}"])
