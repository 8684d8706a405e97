"""The 2D tester's image writers, in numpy and the standard library.

The JAX package writes its 2D maps with ``cv2.imwrite``
(``values_tpu/inference/test_2d.py:255-282``); the card's machine has
neither cv2 nor PIL, so the port writes the two formats itself:

- :func:`write_png_rgb`: an 8-bit RGB PNG (colour type 2, zlib, filter
  0 on every row);
- :func:`write_tiff_float32`: an uncompressed single-channel float32
  TIFF (little-endian, one strip, ``SampleFormat`` 3).

Files decode (cv2, PIL) to the arrays the JAX tester's files decode to;
they need not be byte-equal to them.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png_rgb(path: str, rgb: np.ndarray, level: int = 1) -> None:
    """Write an (H, W, 3) uint8 array, channels in R, G, B order."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} "
                         f"{rgb.dtype}")
    h, w = rgb.shape[:2]
    rows = np.empty((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _png_chunk(b"IEND", b""))


# (tag, type, value): type 3 SHORT, 4 LONG
def _tiff_tags(h: int, w: int, offset: int, nbytes: int):
    return [(256, 4, w), (257, 4, h), (258, 3, 32), (259, 3, 1),
            (262, 3, 1), (273, 4, offset), (277, 3, 1), (278, 4, h),
            (279, 4, nbytes), (284, 3, 1), (339, 3, 3)]


def write_tiff_float32(path: str, image: np.ndarray) -> None:
    """Write an (H, W) array as float32: the header, the pixels as one
    strip, then the image file directory."""
    data = np.ascontiguousarray(image, dtype="<f4")
    if data.ndim != 2:
        raise ValueError(f"expected an (H, W) map, got {data.shape}")
    h, w = data.shape
    offset = 8
    ifd = offset + data.nbytes + (data.nbytes % 2)
    tags = _tiff_tags(h, w, offset, data.nbytes)
    entries = b"".join(
        struct.pack("<HHIHH", tag, kind, 1, value, 0) if kind == 3
        else struct.pack("<HHII", tag, kind, 1, value)
        for tag, kind, value in tags)
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd))
        f.write(data.tobytes())
        f.write(b"\x00" * (data.nbytes % 2))
        f.write(struct.pack("<H", len(tags)) + entries
                + struct.pack("<I", 0))
