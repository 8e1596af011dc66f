"""Data layer tests: NRRD round-trips in every encoding/type, detached
headers, skips, endianness, CSV slice stacks, native decode parity."""

import gzip
import os

import numpy as np
import pytest

from volumetric_renderer.data import _native
from volumetric_renderer.data.csv_stack import CsvParseError, read_csv_stack
from volumetric_renderer.data.importer import VolumeImportError, import_volume
from volumetric_renderer.data.nrrd import (
    NrrdError,
    read_nrrd,
    read_nrrd_raw,
    write_nrrd,
)
from volumetric_renderer.data.volume import Volume

DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32",
          "int64", "uint64", "float32", "float64"]
ENCODINGS = ["raw", "ascii", "hex", "gzip", "bzip2"]


def rand_volume(rng, dtype, shape=(3, 4, 5)):
    if np.issubdtype(np.dtype(dtype), np.floating):
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    lo = max(info.min, -1000)
    hi = min(info.max, 1000)
    return rng.integers(lo, hi, size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("encoding", ENCODINGS)
def test_nrrd_roundtrip(tmp_path, dtype, encoding):
    rng = np.random.default_rng(7)
    arr = rand_volume(rng, dtype)
    p = str(tmp_path / "t.nrrd")
    write_nrrd(p, arr, encoding=encoding)
    h, back = read_nrrd_raw(p)
    assert h.sizes == [5, 4, 3]  # fastest axis first
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("encoding", ["raw", "gzip", "ascii"])
def test_nrrd_detached_roundtrip(tmp_path, encoding):
    rng = np.random.default_rng(8)
    arr = rand_volume(rng, "uint16")
    p = str(tmp_path / "t.nhdr")
    write_nrrd(p, arr, encoding=encoding, detached=True)
    assert os.path.exists(p)
    h, back = read_nrrd_raw(p)
    assert h.data_files is not None
    np.testing.assert_array_equal(back, arr)


def test_nrrd_big_endian(tmp_path):
    arr = np.arange(24, dtype=">u2").reshape(2, 3, 4)
    header = (
        b"NRRD0004\n"
        b"type: ushort\ndimension: 3\nsizes: 4 3 2\n"
        b"encoding: raw\nendian: big\n\n"
    )
    p = tmp_path / "be.nrrd"
    p.write_bytes(header + arr.tobytes())
    _, back = read_nrrd_raw(str(p))
    np.testing.assert_array_equal(back.astype(np.uint16), np.arange(24).reshape(2, 3, 4))


def test_nrrd_line_and_byte_skip(tmp_path):
    arr = np.arange(6, dtype=np.uint8).reshape(1, 2, 3)
    header = (
        b"NRRD0001\n"
        b"type: uchar\ndimension: 3\nsizes: 3 2 1\n"
        b"encoding: raw\nline skip: 2\nbyte skip: 3\n\n"
        b"junk line 1\njunk 2\nXYZ"
    )
    p = tmp_path / "skip.nrrd"
    p.write_bytes(header + arr.tobytes())
    _, back = read_nrrd_raw(str(p))
    np.testing.assert_array_equal(back, arr)


def test_nrrd_byte_skip_minus_one(tmp_path):
    arr = np.arange(6, dtype=np.uint8).reshape(1, 2, 3)
    header = (
        b"NRRD0001\n"
        b"type: uchar\ndimension: 3\nsizes: 3 2 1\n"
        b"encoding: raw\nbyte skip: -1\n\n"
        b"GARBAGEGARBAGE"
    )
    p = tmp_path / "tail.nrrd"
    p.write_bytes(header + arr.tobytes())
    _, back = read_nrrd_raw(str(p))
    np.testing.assert_array_equal(back, arr)


def test_nrrd_header_fields_and_kvp(tmp_path):
    arr = np.zeros((2, 2, 2), dtype=np.float32)
    header = (
        b"NRRD0005\n"
        b"# a comment\n"
        b"content: test vol\n"
        b"type: float\ndimension: 3\nsizes: 2 2 2\n"
        b"encoding: raw\nendian: little\n"
        b"spacings: 1.0 2.0 3.0\n"
        b"space: left-posterior-superior\n"
        b"space directions: (1,0,0) (0,1,0) (0,0,1)\n"
        b"space origin: (-1.5,-1.5,-1.5)\n"
        b'labels: "x" "y" "z"\n'
        b"kinds: domain domain domain\n"
        b"centers: cell cell cell\n"
        b"mykey:=myvalue\n\n"
    )
    p = tmp_path / "full.nrrd"
    p.write_bytes(header + arr.tobytes())
    h, back = read_nrrd_raw(str(p))
    assert h.spacings == [1.0, 2.0, 3.0]
    assert h.space == "left-posterior-superior"
    assert h.space_directions == [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    assert h.space_origin == (-1.5, -1.5, -1.5)
    assert h.labels == ["x", "y", "z"]
    assert h.keyvalue == {"mykey": "myvalue"}
    assert h.comments == ["a comment"]


def test_nrrd_multi_datafile_list(tmp_path):
    arr = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    (tmp_path / "a.raw").write_bytes(arr[0].tobytes())
    (tmp_path / "b.raw").write_bytes(arr[1].tobytes())
    hdr = (
        "NRRD0005\ntype: uchar\ndimension: 3\nsizes: 3 2 2\n"
        "encoding: raw\ndata file: LIST\na.raw\nb.raw\n"
    )
    p = tmp_path / "list.nhdr"
    p.write_text(hdr)
    _, back = read_nrrd_raw(str(p))
    np.testing.assert_array_equal(back, arr)


def test_nrrd_multi_datafile_sprintf(tmp_path):
    arr = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    (tmp_path / "s0.raw").write_bytes(arr[0].tobytes())
    (tmp_path / "s1.raw").write_bytes(arr[1].tobytes())
    hdr = (
        "NRRD0005\ntype: uchar\ndimension: 3\nsizes: 3 2 2\n"
        "encoding: raw\ndata file: s%d.raw 0 1 1\n"
    )
    p = tmp_path / "sp.nhdr"
    p.write_text(hdr)
    _, back = read_nrrd_raw(str(p))
    np.testing.assert_array_equal(back, arr)


def test_nrrd_gzip_interop(tmp_path):
    """Payload written with the stdlib gzip module (not our writer)."""
    arr = np.arange(8, dtype=np.int16).reshape(2, 2, 2)
    hdr = (
        b"NRRD0004\ntype: short\ndimension: 3\nsizes: 2 2 2\n"
        b"encoding: gzip\nendian: little\n\n"
    )
    p = tmp_path / "z.nrrd"
    p.write_bytes(hdr + gzip.compress(arr.astype("<i2").tobytes()))
    _, back = read_nrrd_raw(str(p))
    np.testing.assert_array_equal(back.astype(np.int16), arr)


def test_nrrd_errors(tmp_path):
    p = tmp_path / "bad.nrrd"
    p.write_bytes(b"NOTNRRD\n")
    with pytest.raises(NrrdError):
        read_nrrd_raw(str(p))
    p.write_bytes(b"NRRD0001\ntype: float\ndimension: 2\nsizes: 2 2\nencoding: raw\nendian: little\n\n" + b"\0" * 16)
    with pytest.raises(NrrdError):
        read_nrrd(str(p))  # dim != 3 (nrrd_file_parser.cpp:28-30)
    p.write_bytes(b"NRRD0001\ntype: float\ndimension: 3\nsizes: 2 2 2\nencoding: raw\nendian: little\n\n" + b"\0" * 4)
    with pytest.raises(NrrdError):
        read_nrrd(str(p))  # truncated data


def test_read_nrrd_widens_and_minmax(tmp_path):
    arr = np.array([[[5, -3], [100, 7]], [[0, 1], [2, 3]]], dtype=np.int16)
    p = str(tmp_path / "v.nrrd")
    write_nrrd(p, arr, encoding="raw")
    vol = import_volume(p)
    assert isinstance(vol, Volume)
    assert vol.data.dtype == np.float32
    assert vol.vmin == -3.0 and vol.vmax == 100.0
    assert vol.dimensions == (2, 2, 2)


# -- CSV -------------------------------------------------------------------

def test_csv_stack(tmp_path):
    a = tmp_path / "a.csv"
    b = tmp_path / "b.csv"
    a.write_text("1,2,3\n4,5,6\n")
    b.write_text("7,8,9\n10,11,12\n")
    vol = read_csv_stack([str(a), str(b)])
    assert vol.data.shape == (2, 2, 3)  # (Z, Y, X)
    assert vol.dimensions == (3, 2, 2)
    assert vol.vmin == 1.0 and vol.vmax == 12.0
    np.testing.assert_array_equal(vol.data[0, 0], [1, 2, 3])


def test_csv_inconsistent_dims(tmp_path):
    a = tmp_path / "a.csv"
    b = tmp_path / "b.csv"
    a.write_text("1,2\n3,4\n")
    b.write_text("1,2,3\n4,5,6\n")
    with pytest.raises(CsvParseError):
        read_csv_stack([str(a), str(b)])


def test_csv_reference_minmax_quirk(tmp_path):
    a = tmp_path / "a.csv"
    a.write_text("5,6\n7,8\n")
    assert read_csv_stack([str(a)]).vmin == 5.0
    assert read_csv_stack([str(a)], reference_minmax=True).vmin == 0.0


def test_importer_dispatch(tmp_path):
    a = tmp_path / "a.csv"
    a.write_text("1,2\n")
    vol = import_volume([str(a)])
    assert vol.data.shape == (1, 1, 2)
    with pytest.raises(VolumeImportError):
        import_volume(str(tmp_path / "nope.xyz"))
    with pytest.raises(VolumeImportError):
        import_volume(str(tmp_path / "missing.nrrd"))


# -- native decode ---------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_native_widen_matches_numpy(dtype):
    rng = np.random.default_rng(3)
    arr = rand_volume(rng, dtype, shape=(4, 4, 4))
    out, mn, mx = _native.widen_to_f32_minmax(arr)
    np.testing.assert_array_equal(out, arr.astype(np.float32).reshape(-1))
    assert mn == float(arr.astype(np.float32).min())
    assert mx == float(arr.astype(np.float32).max())


def test_native_widen_bigendian():
    arr = np.arange(10, dtype=">i4")
    out, mn, mx = _native.widen_to_f32_minmax(arr)
    np.testing.assert_array_equal(out, np.arange(10, dtype=np.float32))
    assert (mn, mx) == (0.0, 9.0)


def test_native_lib_builds():
    # informational: the C path should be available in this environment
    assert _native.have_native(), "libvolio.so failed to build/load"
