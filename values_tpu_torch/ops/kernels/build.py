"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from ``values_tpu_torch/csrc`` into
``build/kernels/`` at the repository root, as a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The file
name carries a hash of the sources and flags, so an edited source builds
anew. nvcc's output, including ``-Xptxas -v``'s register and
shared-memory report, is kept beside the library as ``<name>.log``. A
failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple) -> ctypes.CDLL:
    """Build ``sources`` (csrc file names) into ``lib<name>-<hash>.so``
    when no library of this source hash exists, then load it."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update((CSRC / src).read_bytes())
    path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))
