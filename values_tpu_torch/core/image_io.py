"""The 2D path's image readers and writers, in numpy and the standard
library.

The JAX package reads and writes its 2D images with cv2
(``values_tpu/inference/test_2d.py:255-282``,
``values_tpu/data/gta_preprocess.py``,
``values_tpu/evaluation/experiment_dataloader.py``); the card's machine
has neither cv2 nor PIL, so the port handles the two formats itself:

- :func:`write_png_rgb`: an 8-bit RGB PNG (colour type 2, zlib, filter
  0 on every row);
- :func:`write_tiff_float32`: an uncompressed single-channel float32
  TIFF (little-endian, one strip, ``SampleFormat`` 3);
- :func:`read_png`: 8-bit grey, grey + alpha, RGB and RGBA PNGs and
  palette PNGs of 1 to 8 bits, every filter type, not interlaced; it
  returns what ``cv2.imread(path, -1)`` returns (colour in B, G, R
  order, alpha last, a palette expanded to BGR, or BGRA with a ``tRNS``
  chunk). Sub and Up are undone in numpy, Average and Paeth (sequential
  along a row) in the native host library
  (:func:`values_tpu_torch.data.native.png_unfilter_row`);
- :func:`read_tiff_float32`: uncompressed single-channel float32 TIFFs
  (the files :func:`write_tiff_float32` writes, and cv2's uncompressed
  ones, in any number of strips).

Files written here decode (cv2, PIL) to the arrays the JAX tester's files
decode to; they need not be byte-equal to them.
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


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples


def _png_chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """The reconstructed (h, stride) scanlines of the filtered stream."""
    from ..data.native import png_unfilter_row
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data of {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:].copy()
        if kind == 1:  # Sub: running sums of each byte of a pixel
            pad = (-stride) % bpp
            lanes = np.concatenate([cur, np.zeros(pad, np.uint8)]
                                   ).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[
                :stride]
        elif kind == 2:  # Up
            cur += prev
        elif kind in (3, 4):  # Average, Paeth
            png_unfilter_row(cur, prev, bpp, kind)
        elif kind != 0:
            raise ValueError(f"{path}: row {y} has PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path) -> np.ndarray:
    """The image of an 8-bit PNG as ``cv2.imread(path, -1)`` gives it:
    (H, W) uint8 for grey, (H, W, 3) BGR, (H, W, 4) BGRA (RGBA, grey +
    alpha with grey in all three colours, a palette with ``tRNS``).
    Raises ValueError for 16-bit, sub-8-bit non-palette and interlaced
    files."""
    path = str(path)
    with open(path, "rb") as f:
        data = f.read()
    header, palette, alpha, idat = None, None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if colour not in _PNG_CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {colour}")
    if depth != 8 and not (colour == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{path}: {depth}-bit PNGs of colour type "
                         f"{colour} are not read (8-bit, or a palette of "
                         "1 to 8 bits)")
    if alpha is not None and colour != 3:
        raise ValueError(f"{path}: a tRNS chunk is read on palette PNGs "
                         "only")
    samples = _PNG_CHANNELS[colour]
    stride = -(-w * samples * depth // 8)
    rows = _unfilter(np.frombuffer(zlib.decompress(b"".join(idat)),
                                   np.uint8), h, stride,
                     max(1, samples * depth // 8), path)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        index = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(
            h, w, depth) if depth < 8 else rows[..., None]
        if depth < 8:
            index = (index * (1 << np.arange(depth - 1, -1, -1))).sum(
                -1).astype(np.intp)
        else:
            index = index[..., 0].astype(np.intp)
        if index.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        bgr = palette[index][..., ::-1]
        if alpha is None:
            return np.ascontiguousarray(bgr)
        table = np.full(len(palette), 255, np.uint8)
        table[:len(alpha)] = alpha[:len(palette)]
        return np.ascontiguousarray(np.concatenate(
            [bgr, table[index][..., None]], axis=-1))
    pixels = rows.reshape(h, w, samples)
    if colour == 0:
        return np.ascontiguousarray(pixels[..., 0])
    if colour == 4:
        grey = pixels[..., :1]
        return np.ascontiguousarray(np.concatenate(
            [grey, grey, grey, pixels[..., 1:]], axis=-1))
    order = [2, 1, 0] + ([3] if samples == 4 else [])
    return np.ascontiguousarray(pixels[..., order])


_TIFF_TYPES = {3: "H", 4: "I"}  # SHORT, LONG


def read_tiff_float32(path) -> np.ndarray:
    """The (H, W) float32 map of an uncompressed single-channel float32
    TIFF (either byte order, any number of strips). Raises ValueError
    for a compressed file or another pixel type."""
    path = str(path)
    with open(path, "rb") as f:
        data = f.read()
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path} is not a TIFF file")
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (count,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(count):
        tag, kind, n, value = struct.unpack(
            order + "HHI4s", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        if kind not in _TIFF_TYPES:
            continue
        fmt = _TIFF_TYPES[kind]
        size = struct.calcsize(fmt) * n
        raw = value[:size] if size <= 4 else data[
            struct.unpack(order + "I", value)[0]:][:size]
        tags[tag] = struct.unpack(order + fmt * n, raw)
    w, h = tags[256][0], tags[257][0]
    compression = tags.get(259, (1,))[0]
    if compression != 1:
        raise ValueError(f"{path}: compressed TIFF (compression "
                         f"{compression}); only uncompressed files are read")
    if tags.get(258, (0,))[0] != 32 or tags.get(339, (1,))[0] != 3 \
            or tags.get(277, (1,))[0] != 1:
        raise ValueError(f"{path}: not a single-channel float32 TIFF")
    strips = b"".join(data[o:o + n] for o, n in zip(tags[273], tags[279]))
    return np.frombuffer(strips, order + "f4", count=h * w).reshape(
        h, w).astype(np.float32)
