"""Point-cloud file IO, numpy only (port of ``mccnn_tpu/utils/io.py:21-65``).

The port's own copy: it imports nothing of the JAX package. Where the
reference parses text tables with its native C++ scanner
(``mccnn_tpu/native/fastparse.cpp``), this copy parses with numpy, which is
the reference's own fallback when that library is not built.
"""

from __future__ import annotations

import io

import numpy as np

_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def read_points_txt(path: str, delimiter: str | None = None) -> np.ndarray:
    """Read an ``(n, d)`` float table (.txt / .pts / .xyz); the delimiter is a
    comma when the first line holds one, else whitespace."""
    with open(path, "rb") as f:
        data = f.read()
    if delimiter is None:
        delimiter = "," if b"," in data.split(b"\n", 1)[0] else None
    return np.loadtxt(io.BytesIO(data), delimiter=delimiter, dtype=np.float32, ndmin=2)


def write_points_txt(path: str, points: np.ndarray, delimiter: str = ",") -> None:
    np.savetxt(path, points, fmt="%.6f", delimiter=delimiter)


def read_ply(path: str) -> dict:
    """Minimal PLY reader (ascii and binary_little_endian, vertex properties)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        element = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header has no end_header")
            parts = line.split()
            if not parts:
                continue
            if parts[0] == b"end_header":
                break
            if parts[0] == b"format":
                fmt = parts[1].decode()
            elif parts[0] == b"element":
                element = parts[1]
                if element == b"vertex":
                    n_vertex = int(parts[2])
            elif parts[0] == b"property" and element == b"vertex" and parts[1] != b"list":
                props.append((parts[2].decode(), parts[1].decode()))
        if fmt == "ascii":
            rows = np.atleast_2d(np.loadtxt(f, max_rows=n_vertex))
            return {name: rows[:, i] for i, (name, _) in enumerate(props)}
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
        dtype = np.dtype([(n, "<" + _PLY_TYPES[t]) for n, t in props])
        raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
        return {name: np.asarray(raw[name]) for name, _ in props}
