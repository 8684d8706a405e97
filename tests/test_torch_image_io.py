"""The port's PNG and TIFF readers (values_tpu_torch.core.image_io::
read_png, read_tiff_float32) against ``cv2.imread(path, -1)``: files
written by cv2 and PIL (grey, RGB, RGBA, grey + alpha, palettes of 1 to 8
bits with and without ``tRNS``) and files written here with each of the
five PNG filters on every row and all five mixed, decode to the same
arrays exactly; the evaluation's map reader uses them; what they do not
take raises."""
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_parallel_cases import one_torch_thread  # noqa: F401
from values_tpu_torch.core.image_io import (read_png, read_tiff_float32,
                                            write_png_rgb,
                                            write_tiff_float32)
from values_tpu_torch.evaluation.experiment_dataloader import _load_map


def _image(h=23, w=37, channels=3, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
    img[:, : w // 3] = img[:, :1]  # flat runs, where filters differ
    img[h // 2:] //= 3
    return img[..., 0] if channels == 1 else img


def filter_rows(pixels: np.ndarray, bpp: int, types) -> bytes:
    """Filtered PNG scanlines of (H, stride) uint8 ``pixels``, row y with
    filter ``types[y]`` (the encoder's side of the specification, section
    9; vectorised: it reads only the unfiltered rows)."""
    raw = pixels.astype(np.int32)
    h, n = raw.shape
    out = np.empty((h, n + 1), dtype=np.uint8)
    for y in range(h):
        x = raw[y]
        b = raw[y - 1] if y else np.zeros(n, np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        kind = types[y]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out[y, 0] = kind
        out[y, 1:] = (x - pred) % 256
    return out.tobytes()


def write_png(path, pixels: np.ndarray, colour: int, types, depth=8,
              palette=None, trns=None) -> None:
    """A PNG of the given colour type whose rows carry ``types``."""
    h, w = pixels.shape[:2]
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    rows = pixels.reshape(h, -1)
    if depth < 8:
        bits = np.unpackbits(rows[..., None], axis=-1)[..., 8 - depth:]
        rows = np.packbits(bits.reshape(h, -1), axis=-1)
    bpp = max(1, samples * depth // 8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0,
                                      0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", bytes(trns))
    data = zlib.compress(filter_rows(rows, bpp, types), 6)
    half = len(data) // 2  # two IDAT chunks
    body += chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:])
    body += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body)


def _same(path):
    want = cv2.imread(str(path), -1)
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want)


COLOURS = {"grey": (0, 1), "rgb": (2, 3), "grey_alpha": (4, 2),
           "rgba": (6, 4)}


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("colour", sorted(COLOURS))
def test_each_filter_and_colour_decodes_as_cv2(tmp_path, colour, filters):
    kind, channels = COLOURS[colour]
    img = _image(channels=channels)
    h = img.shape[0]
    types = ([int(filters)] * h if filters != "mixed"
             else [y % 5 for y in range(h)])
    # PNG samples are R, G, B(, A); cv2 gives B, G, R(, A)
    write_png(tmp_path / "f.png", img, kind, types)
    _same(tmp_path / "f.png")


@pytest.mark.parametrize("depth,n", [(1, 2), (2, 4), (4, 16), (8, 200)])
@pytest.mark.parametrize("trns", [False, True])
def test_palettes_decode_as_cv2(tmp_path, depth, n, trns):
    rng = np.random.RandomState(depth)
    index = rng.randint(0, n, (19, 29)).astype(np.uint8)
    palette = rng.randint(0, 256, (n, 3))
    write_png(tmp_path / "p.png", index, 3, [y % 5 for y in range(19)],
              depth=depth, palette=palette,
              trns=[0, 128][: min(2, n)] if trns else None)
    _same(tmp_path / "p.png")
    im = Image.fromarray(index, "P")
    im.putpalette(palette.astype(np.uint8).reshape(-1).tolist())
    im.save(tmp_path / "pil.png", **({"transparency": 1} if trns else {}))
    _same(tmp_path / "pil.png")


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_and_pil_files_decode_as_cv2(tmp_path, channels, level):
    img = _image(channels=channels, seed=channels)
    cv2.imwrite(str(tmp_path / "c.png"), img,
                [cv2.IMWRITE_PNG_COMPRESSION, level])
    _same(tmp_path / "c.png")
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img, mode).save(tmp_path / "pil.png",
                                    compress_level=level)
    _same(tmp_path / "pil.png")
    rgb = _image(seed=9)
    write_png_rgb(str(tmp_path / "w.png"), rgb)
    _same(tmp_path / "w.png")


def test_what_read_png_refuses(tmp_path):
    img = (np.arange(64).reshape(8, 8) * 1000).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "16.png"), img)
    with pytest.raises(ValueError, match="16-bit"):
        read_png(tmp_path / "16.png")
    Image.fromarray(_image()).save(tmp_path / "i.png", interlace=1)
    with open(tmp_path / "i.png", "rb") as f:
        interlaced = f.read()[:29]
    if interlaced[28] == 1:
        with pytest.raises(ValueError, match="interlaced"):
            read_png(tmp_path / "i.png")
    raw = bytearray((tmp_path / "16.png").read_bytes())
    raw[:8] = b"notapng!"
    (tmp_path / "bad.png").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "bad.png")


def test_tiffs_decode_as_cv2(tmp_path):
    rng = np.random.RandomState(3)
    for shape in ((13, 17), (300, 500)):
        m = rng.standard_normal(shape).astype(np.float32)
        cv2.imwrite(str(tmp_path / "c.tif"), m,
                    [cv2.IMWRITE_TIFF_COMPRESSION, 1])
        np.testing.assert_array_equal(read_tiff_float32(tmp_path / "c.tif"),
                                      cv2.imread(str(tmp_path / "c.tif"),
                                                 -1))
        write_tiff_float32(str(tmp_path / "w.tif"), m)
        np.testing.assert_array_equal(read_tiff_float32(tmp_path / "w.tif"),
                                      m)
    cv2.imwrite(str(tmp_path / "z.tif"), m,
                [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    with pytest.raises(ValueError, match="compressed"):
        read_tiff_float32(tmp_path / "z.tif")


def test_the_evaluation_map_reader_uses_them(tmp_path):
    img = _image(seed=4)
    cv2.imwrite(str(tmp_path / "m.png"), img)
    np.testing.assert_array_equal(_load_map(tmp_path / "m.png"),
                                  cv2.imread(str(tmp_path / "m.png"), -1))
    m = np.random.RandomState(5).rand(9, 7).astype(np.float32)
    write_tiff_float32(str(tmp_path / "m.tif"), m)
    np.testing.assert_array_equal(_load_map(tmp_path / "m.tif"), m)
