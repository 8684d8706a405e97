"""Minimal NIfTI-1 reader/writer (pure numpy, no medpy/nibabel dependency).

The reference stores every 3D artifact as ``.nii.gz`` via medpy
(reference: uncertainty_modeling/data_carrier_3D.py:224-371,
datasets/preprocess_datasets_3d.py). This module implements the small NIfTI-1
subset those files use: single-file ``.nii``/``.nii.gz``, scalar volumes,
little-endian, no extensions. Data is written in Fortran (column-major) order
per the NIfTI spec, so round-trips preserve array axes exactly.

The port's copy of ``values_tpu/core/nifti.py``, except that ``.nii.gz``
files are written at gzip level 1, nibabel's default and so what the
reference's medpy writes: the same bytes once decompressed, and many
times faster to write than level 9 for smooth probability maps, which
level 9 searches longest for matches.
"""
from __future__ import annotations

import gzip
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_HDR_SIZE = 348

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiHeader:
    """Carries voxel spacing + affine-ish fields between load and save."""

    def __init__(self, pixdim: Optional[np.ndarray] = None,
                 raw: Optional[bytes] = None):
        self.pixdim = np.ones(8, dtype=np.float32) if pixdim is None else pixdim
        self.raw = raw

    @property
    def spacing(self) -> Tuple[float, ...]:
        return tuple(float(x) for x in self.pixdim[1:4])


def _open(path: Union[str, Path], mode: str):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode, compresslevel=1)
    return open(path, mode)


def load(path: Union[str, Path]) -> Tuple[np.ndarray, NiftiHeader]:
    """Load a NIfTI-1 volume. Returns (array, header) like medpy.io.load."""
    with _open(path, "rb") as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = int(np.frombuffer(hdr, "<i4", 1, 0)[0])
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
        dim = np.frombuffer(hdr, "<i2", 8, 40)
        datatype = int(np.frombuffer(hdr, "<i2", 1, 70)[0])
        pixdim = np.frombuffer(hdr, "<f4", 8, 76).copy()
        vox_offset = float(np.frombuffer(hdr, "<f4", 1, 108)[0])
        scl_slope = float(np.frombuffer(hdr, "<f4", 1, 112)[0])
        scl_inter = float(np.frombuffer(hdr, "<f4", 1, 116)[0])
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        ndim = int(dim[0])
        shape = tuple(int(d) for d in dim[1:1 + ndim])
        dtype = _DTYPES.get(datatype)
        if dtype is None:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        f.read(max(0, int(vox_offset) - _HDR_SIZE))
        count = int(np.prod(shape)) if shape else 1
        data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize),
                             dtype=dtype, count=count)
    arr = data.reshape(shape, order="F").copy()
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        arr = arr * (scl_slope if scl_slope != 0.0 else 1.0) + scl_inter
    return arr, NiftiHeader(pixdim=pixdim, raw=hdr)


def save(arr: np.ndarray, path: Union[str, Path],
         header: Union[NiftiHeader, bool, None] = None) -> None:
    """Save a volume as NIfTI-1 (.nii or .nii.gz), medpy.io.save-style."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _CODES:
        arr = arr.astype(np.float32)
    code = _CODES[arr.dtype]

    hdr = bytearray(_HDR_SIZE)
    hdr[0:4] = np.int32(_HDR_SIZE).tobytes()
    hdr[39] = 114  # dim_info: arbitrary nonzero regular byte ('r')
    dim = np.zeros(8, dtype="<i2")
    dim[0] = arr.ndim
    dim[1:1 + arr.ndim] = arr.shape
    dim[1 + arr.ndim:] = 1
    hdr[40:56] = dim.tobytes()
    hdr[70:72] = np.int16(code).tobytes()
    hdr[72:74] = np.int16(arr.dtype.itemsize * 8).tobytes()
    pixdim = np.ones(8, dtype="<f4")
    if isinstance(header, NiftiHeader):
        pixdim[:] = header.pixdim
    hdr[76:108] = pixdim.tobytes()
    hdr[108:112] = np.float32(352.0).tobytes()  # vox_offset
    hdr[112:116] = np.float32(1.0).tobytes()    # scl_slope
    # sform: identity orientation so ordinary viewers accept the file
    hdr[252:254] = np.int16(1).tobytes()  # qform_code
    hdr[254:256] = np.int16(1).tobytes()  # sform_code
    srow = np.zeros((3, 4), dtype="<f4")
    for i in range(3):
        srow[i, i] = pixdim[i + 1]
    hdr[280:328] = srow.tobytes()
    hdr[344:348] = b"n+1\x00"

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(arr).tobytes(order="F"))
