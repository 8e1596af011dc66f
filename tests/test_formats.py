"""PNM / PNG / VTK reader tests (NrrdIO's other input formats:
``extern/NrrdIO/formatPNM.c``, ``formatPNG.c``, ``formatVTK.c``).

Fixtures are written byte-by-byte by the tests themselves (the PNG
encoder here mirrors the spec directly: zlib-compressed filter-0
scanlines), so every reader is checked against an independent
construction of the format, not against itself.
"""

import struct
import zlib

import numpy as np
import pytest

from volumetric_renderer.data.formats import (
    read_png_image, read_pnm_image, read_vtk, write_png_rgb,
)
from volumetric_renderer.data.importer import (
    VolumeImportError, import_volume,
)


def _write_png(path, arr, *, color=False, depth=8, filters=None):
    """Minimal PNG writer: gray or RGB, 8/16-bit, per-row filter types."""
    h, w = arr.shape[:2]
    ctype = 2 if color else 0
    nch = 3 if color else 1
    if depth == 8:
        flat = np.asarray(arr, np.uint8).reshape(h, w * nch)
        bpp = nch
    else:
        a16 = np.asarray(arr, np.uint16)
        flat = np.zeros((h, w * nch * 2), np.uint8)
        flat[:, 0::2] = (a16.reshape(h, -1) >> 8).astype(np.uint8)
        flat[:, 1::2] = (a16.reshape(h, -1) & 0xFF).astype(np.uint8)
        bpp = nch * 2
    filters = filters or [0] * h
    raw = bytearray()
    prev = np.zeros(flat.shape[1], np.int32)
    for y, ft in enumerate(filters):
        row = flat[y].astype(np.int32)
        if ft == 0:
            enc = row
        elif ft == 2:  # Up
            enc = (row - prev) & 0xFF
        elif ft == 1:  # Sub
            enc = row.copy()
            enc[bpp:] = (row[bpp:] - row[:-bpp]) & 0xFF
        else:
            raise ValueError(ft)
        raw.append(ft)
        raw.extend(enc.astype(np.uint8).tobytes())
        prev = row

    def chunk(ctag, data):
        c = struct.pack(">I", len(data)) + ctag + data
        return c + struct.pack(">I", zlib.crc32(ctag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    blob = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))
    path.write_bytes(blob)


def test_pgm_binary_roundtrip(tmp_path):
    img = np.arange(20, dtype=np.uint8).reshape(4, 5)
    p = tmp_path / "x.pgm"
    p.write_bytes(b"P5\n# comment\n5 4\n255\n" + img.tobytes())
    got = read_pnm_image(str(p))
    np.testing.assert_allclose(got, img / 255.0, atol=1e-7)


def test_pgm_ascii_and_16bit(tmp_path):
    p = tmp_path / "a.pgm"
    p.write_bytes(b"P2\n3 2\n1000\n0 100 200\n300 999 1000\n")
    got = read_pnm_image(str(p))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(
        got, np.asarray([[0, 100, 200], [300, 999, 1000]]) / 1000.0,
        atol=1e-6)
    img = np.asarray([[256, 65535]], np.uint16)
    b = tmp_path / "b.pgm"
    b.write_bytes(b"P5\n2 1\n65535\n" + img.astype(">u2").tobytes())
    np.testing.assert_allclose(read_pnm_image(str(b)), img / 65535.0,
                               atol=1e-7)


def test_ppm_color_luminance(tmp_path):
    p = tmp_path / "c.ppm"
    pix = np.asarray([[[255, 0, 0], [0, 255, 0]]], np.uint8)
    p.write_bytes(b"P6\n2 1\n255\n" + pix.tobytes())
    got = read_pnm_image(str(p))
    np.testing.assert_allclose(got, [[0.2126, 0.7152]], atol=1e-4)


def test_pbm_bitmap(tmp_path):
    # P4: packed bits, 1 = black -> inverted to 0.0
    p = tmp_path / "d.pbm"
    p.write_bytes(b"P4\n10 1\n" + bytes([0b10110000, 0b01000000]))
    got = read_pnm_image(str(p))
    np.testing.assert_allclose(
        got[0], [0, 1, 0, 0, 1, 1, 1, 1, 1, 0], atol=1e-7)


def test_png_gray8_filters(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (6, 7), dtype=np.uint8)
    p = tmp_path / "g.png"
    _write_png(p, img, filters=[0, 1, 2, 0, 2, 1])
    got = read_png_image(str(p))
    np.testing.assert_allclose(got, img / 255.0, atol=1e-7)


def test_png_rgb_and_16bit(tmp_path):
    img = np.asarray([[[255, 0, 0], [0, 0, 255]]], np.uint8)
    p = tmp_path / "rgb.png"
    _write_png(p, img, color=True)
    np.testing.assert_allclose(read_png_image(str(p)),
                               [[0.2126, 0.0722]], atol=1e-4)
    g16 = np.asarray([[0, 32768, 65535]], np.uint16)
    q = tmp_path / "g16.png"
    _write_png(q, g16, depth=16)
    np.testing.assert_allclose(read_png_image(str(q)),
                               g16 / 65535.0, atol=1e-7)


def test_png_paeth_average_roundtrip(tmp_path):
    """Filters 3/4 exercised via an externally-encoded fixture: encode
    with filter 0, then re-encode rows manually with Average/Paeth."""
    img = np.asarray([[10, 20, 30], [40, 60, 80]], np.uint8)
    h, w = img.shape
    raw = bytearray()
    prev = np.zeros(w, np.int32)
    for y, ft in enumerate([3, 4]):
        row = img[y].astype(np.int32)
        enc = row.copy()
        for x in range(w):
            a = int(row[x - 1]) if x else 0  # reconstructed left = original
            b = int(prev[x])
            c = int(prev[x - 1]) if x else 0
            if ft == 3:
                pred = (a + b) >> 1
            else:
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else \
                    (b if pb <= pc else c)
            enc[x] = (row[x] - pred) & 0xFF
            # note: predictor uses *reconstructed* neighbors == row here
        raw.append(ft)
        raw.extend(enc.astype(np.uint8).tobytes())
        prev = row

    def chunk(ctag, data):
        c = struct.pack(">I", len(data)) + ctag + data
        return c + struct.pack(">I", zlib.crc32(ctag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    p = tmp_path / "pf.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                  + chunk(b"IDAT", zlib.compress(bytes(raw)))
                  + chunk(b"IEND", b""))
    np.testing.assert_allclose(read_png_image(str(p)), img / 255.0,
                               atol=1e-7)


def test_vtk_binary_and_ascii(tmp_path):
    vol = np.arange(24, dtype=np.float32).reshape(2, 3, 4)  # z,y,x
    hdr = (b"# vtk DataFile Version 3.0\ntest\nBINARY\n"
           b"DATASET STRUCTURED_POINTS\nDIMENSIONS 4 3 2\n"
           b"SPACING 1 1 1\nORIGIN 0 0 0\nPOINT_DATA 24\n"
           b"SCALARS density float 1\nLOOKUP_TABLE default\n")
    p = tmp_path / "v.vtk"
    p.write_bytes(hdr + vol.astype(">f4").tobytes())
    got = read_vtk(str(p))
    np.testing.assert_allclose(got.data, vol, atol=1e-7)
    assert got.vmin == 0.0 and got.vmax == 23.0

    a = tmp_path / "a.vtk"
    body = " ".join(str(int(v)) for v in vol.ravel())
    a.write_bytes(
        b"# vtk DataFile Version 2.0\nt\nASCII\n"
        b"DATASET STRUCTURED_POINTS\nDIMENSIONS 4 3 2\nPOINT_DATA 24\n"
        b"SCALARS d unsigned_short\n" + body.encode())
    np.testing.assert_allclose(read_vtk(str(a)).data, vol, atol=1e-7)


def test_vtk_rejects_wrong_dataset(tmp_path):
    p = tmp_path / "bad.vtk"
    p.write_bytes(b"# vtk DataFile Version 3.0\nt\nASCII\n"
                  b"DATASET POLYDATA\n")
    with pytest.raises(ValueError):
        read_vtk(str(p))


def test_import_volume_dispatch(tmp_path):
    img0 = np.asarray([[0, 128], [255, 64]], np.uint8)
    img1 = np.asarray([[1, 2], [3, 4]], np.uint8)
    for i, img in enumerate((img0, img1)):
        (tmp_path / f"s{i}.pgm").write_bytes(
            b"P5\n2 2\n255\n" + img.tobytes())
    v = import_volume([str(tmp_path / "s0.pgm"), str(tmp_path / "s1.pgm")])
    assert v.data.shape == (2, 2, 2)
    np.testing.assert_allclose(v.data[0], img0 / 255.0, atol=1e-7)

    _write_png(tmp_path / "one.png", img0)
    v = import_volume(str(tmp_path / "one.png"))
    assert v.data.shape == (1, 2, 2)

    with pytest.raises(VolumeImportError):
        import_volume(str(tmp_path / "nope.xyz"))
    # stack with mismatched slice shapes -> import error
    (tmp_path / "s2.pgm").write_bytes(b"P5\n3 1\n255\n" + bytes(3))
    with pytest.raises(VolumeImportError):
        import_volume([str(tmp_path / "s0.pgm"), str(tmp_path / "s2.pgm")])


def test_write_png_rgb_roundtrip(tmp_path):
    """The stdlib PNG writer (render CLI output) reads back exactly
    through the PNG reader's luminance conversion."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    p = tmp_path / "w.png"
    write_png_rgb(str(p), rgb)
    want = (rgb.astype(np.float32) / 255.0 * np.asarray(
        [0.2126, 0.7152, 0.0722], np.float32)).sum(axis=-1)
    np.testing.assert_allclose(read_png_image(str(p)), want, atol=1e-6)
    with pytest.raises(ValueError):
        write_png_rgb(str(p), rgb[..., :2])
