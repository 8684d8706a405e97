"""ctypes binding of the native host ops (``csrc/volume_ops.cpp``): the
in-place axis mirror and the additive Gaussian noise that
``augment=True`` runs (``values_tpu/native/__init__.py``, :102-123), and
the PNG reader's Average and Paeth unfilters
(:func:`values_tpu_torch.core.image_io.read_png`).

The library is built with g++ at first use into ``build/kernels/`` at the
repository root (never beside the source), under a name that carries a
hash of the source and the flags. A failed build raises with g++'s
output, and an op raises for an array it does not take: nothing falls
back to numpy. The flags are the JAX package's, so both builds give the
same bytes for a seed. :func:`mirror3d_plain` and
:func:`add_gaussian_noise_plain` are the numpy versions the tests hold
each op against (the noise's xoshiro256++ stream and Box-Muller normals
written out in Python, for small volumes).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "volume_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libvolume_ops-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"g++ could not build {SOURCE.name}: "
                               f"{exc!r}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SOURCE.name}:\n"
                               f"$ {' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.mirror3d_f32.argtypes = [fp, ctypes.c_int64, ctypes.c_int]
    lib.mirror3d_i32.argtypes = [ip, ctypes.c_int64, ctypes.c_int]
    lib.add_gaussian_noise_f32.argtypes = [fp, ctypes.c_int64,
                                           ctypes.c_float, ctypes.c_uint64]
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.png_unfilter_row.argtypes = [u8, u8, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int]
    for fn in (lib.mirror3d_f32, lib.mirror3d_i32,
               lib.add_gaussian_noise_f32, lib.png_unfilter_row):
        fn.restype = None
    return lib


def load_library() -> ctypes.CDLL:
    """The built library, built once per process (the loader's worker
    threads may ask together)."""
    with _BUILD_LOCK:
        return _load()


def _check(vol: np.ndarray, dtypes, what: str) -> None:
    if vol.dtype not in dtypes or not vol.flags["C_CONTIGUOUS"] \
            or not vol.flags["WRITEABLE"]:
        raise ValueError(f"{what} takes a writeable C-contiguous array of "
                         f"{[np.dtype(d).name for d in dtypes]}, got "
                         f"{vol.dtype} {vol.flags}")


def mirror3d(vol: np.ndarray, flips: int) -> np.ndarray:
    """Mirror a (p, p, p) float32 or int32 cube in place along the axes
    set in ``flips`` (bit a for axis a); returns ``vol``."""
    _check(vol, (np.float32, np.int32), "mirror3d")
    if vol.ndim != 3 or len(set(vol.shape)) != 1:
        raise ValueError(f"mirror3d takes a cube, got {vol.shape}")
    lib = load_library()
    if vol.dtype == np.float32:
        lib.mirror3d_f32(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         vol.shape[0], int(flips))
    else:
        lib.mirror3d_i32(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         vol.shape[0], int(flips))
    return vol


def add_gaussian_noise(vol: np.ndarray, sigma: float, seed: int
                       ) -> np.ndarray:
    """Add ``sigma`` times the standard normals of the xoshiro256++
    stream of ``seed`` to float32 ``vol`` in place; returns ``vol``."""
    _check(vol, (np.float32,), "add_gaussian_noise")
    load_library().add_gaussian_noise_f32(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vol.size,
        ctypes.c_float(sigma), ctypes.c_uint64(seed))
    return vol


def png_unfilter_row(cur: np.ndarray, prev: np.ndarray, bpp: int,
                     filter_type: int) -> None:
    """Undo PNG filter 3 (Average) or 4 (Paeth) on the uint8 scanline
    ``cur`` in place, given the reconstructed previous row ``prev``."""
    if filter_type not in (3, 4):
        raise ValueError(f"png_unfilter_row takes filters 3 and 4, not "
                         f"{filter_type}")
    _check(cur, (np.uint8,), "png_unfilter_row")
    if prev.dtype != np.uint8 or prev.shape != cur.shape \
            or not prev.flags["C_CONTIGUOUS"]:
        raise ValueError("png_unfilter_row: prev must be a contiguous "
                         "uint8 row of cur's length")
    u8 = ctypes.POINTER(ctypes.c_uint8)
    load_library().png_unfilter_row(cur.ctypes.data_as(u8),
                                    prev.ctypes.data_as(u8), cur.size,
                                    int(bpp), int(filter_type))


# -- plain numpy versions, for the tests ----------------------------------------

_MASK = (1 << 64) - 1


def mirror3d_plain(vol: np.ndarray, flips: int) -> np.ndarray:
    """:func:`mirror3d` in numpy, on a copy."""
    for axis in range(3):
        if flips & (1 << axis):
            vol = np.flip(vol, axis=axis)
    return np.ascontiguousarray(vol)


def _rotl(v: int, k: int) -> int:
    return ((v << k) | (v >> (64 - k))) & _MASK


def xoshiro_uniforms(seed: int, n: int) -> np.ndarray:
    """The first ``n`` doubles in [0, 1) of the library's xoshiro256++
    stream for ``seed`` (splitmix64 seeding)."""
    x, s = seed & _MASK, []
    for _ in range(4):
        x = (x + 0x9E3779B97F4A7C15) & _MASK
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        s.append(z ^ (z >> 31))
    s0, s1, s2, s3 = s
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        out[i] = (((_rotl((s0 + s3) & _MASK, 23) + s0) & _MASK) >> 11) \
            * 2.0 ** -53
        t = (s1 << 17) & _MASK
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = _rotl(s3, 45)
    return out


def add_gaussian_noise_plain(vol: np.ndarray, sigma: float, seed: int
                             ) -> np.ndarray:
    """:func:`add_gaussian_noise` in numpy, on a copy: Box-Muller over
    consecutive uniform pairs, ``u1`` floored at 1e-300, each normal
    rounded to float32; ``vol + sigma * normal`` rounded once, as g++
    contracts it into a fused multiply-add under ``-march=native`` (the
    float32 product is exact in float64)."""
    u = xoshiro_uniforms(seed, 2 * vol.size)
    u1 = np.maximum(u[0::2], 1e-300)
    normals = np.sqrt(-2.0 * np.log(u1)) * np.cos(2 * math.pi * u[1::2])
    noise = np.float64(np.float32(sigma)) * normals.astype(
        np.float32).astype(np.float64)
    return (vol.astype(np.float64) + noise.reshape(vol.shape)).astype(
        np.float32)
