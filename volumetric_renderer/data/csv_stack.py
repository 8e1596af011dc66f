"""CSV slice-stack reader.

Mirrors ``src/data/csv_file_parser.cpp:14-50``: each CSV file is one Z
slice; rows are Y, comma-separated values are X.  X/Y dimensions must be
consistent across rows and files ("Inconsistant dimensions" — the
reference's spelling — ``csv_file_parser.cpp:37,43``).

One deliberate fix over the reference: its running min/max starts from the
value-initialized ``Dataset{}`` (0.0), so all-positive data gets min 0 and
all-negative data gets max 0 (``csv_file_parser.cpp:16,28-29``).  Here
min/max come from the data alone; pass ``reference_minmax=True`` for
bug-compatible behavior.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from volumetric_renderer.data.volume import Volume


class CsvParseError(RuntimeError):
    pass


def _parse_slice_python(text: str, x_dim) -> np.ndarray:
    rows: List[np.ndarray] = []
    for line in text.splitlines():
        line = line.strip("\r")
        if line == "":
            continue
        try:
            vals = np.array([float(v) for v in line.split(",")],
                            dtype=np.float32)
        except ValueError as e:
            raise CsvParseError(str(e)) from e
        if x_dim is None:
            x_dim = vals.size
        elif vals.size != x_dim:
            raise CsvParseError("Inconsistant dimensions")
        rows.append(vals)
    if not rows:
        raise CsvParseError("empty CSV slice")
    return np.stack(rows)


def _parse_slice(path: str, x_dim) -> np.ndarray:
    """One CSV file -> (Y, X) f32 array.  Native C fast path
    (``native/volio.c`` ``vio_parse_csv``, mirroring the reference's C++
    cell loop) with a pure-Python fallback."""
    from volumetric_renderer.data import _native

    with open(os.fspath(path), "rb") as f:
        raw = f.read()
    try:
        parsed = _native.parse_csv(raw)
    except ValueError as e:
        raise CsvParseError(str(e)) from e
    if parsed is None:
        return _parse_slice_python(raw.decode("utf-8", "replace"), x_dim)
    flat, cols = parsed
    if cols == 0 or flat.size == 0:
        raise CsvParseError("empty CSV slice")
    if x_dim is not None and cols != x_dim:
        raise CsvParseError("Inconsistant dimensions")
    return flat.reshape(-1, cols)


def read_csv_stack(paths: Sequence[str], reference_minmax: bool = False) -> Volume:
    slices: List[np.ndarray] = []
    x_dim = y_dim = None
    for path in paths:
        sl = _parse_slice(path, x_dim)
        if x_dim is None:
            x_dim = sl.shape[1]
        if y_dim is None:
            y_dim = sl.shape[0]
        elif sl.shape[0] != y_dim:
            raise CsvParseError("Inconsistant dimensions")
        slices.append(sl)

    if not slices:
        raise CsvParseError("no CSV files given")
    data = np.stack(slices)  # (Z, Y, X)
    vmin, vmax = float(data.min()), float(data.max())
    if reference_minmax:
        vmin, vmax = min(vmin, 0.0), max(vmax, 0.0)
    return Volume(data=data, vmin=vmin, vmax=vmax)
