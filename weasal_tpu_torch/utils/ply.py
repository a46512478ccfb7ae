"""PLY reading (binary little/big endian and ascii, named scalar vertex
properties). Counterpart of weasal_tpu/utils/ply.py `read_ply`; the port
reads the shipped kernel disposition with it and writes no PLY yet."""

from __future__ import annotations

import numpy as np

_PLY_TO_NUMPY = {
    "int8": "i1", "char": "i1",
    "uint8": "u1", "uchar": "u1",
    "int16": "i2", "short": "i2",
    "uint16": "u2", "ushort": "u2",
    "int32": "i4", "int": "i4",
    "uint32": "u4", "uint": "u4",
    "int64": "i8",
    "uint64": "u8",
    "float32": "f4", "float": "f4",
    "float64": "f8", "double": "f8",
}


def _parse_header(f):
    """Returns (fmt, num_points, [(name, numpy type code), ...])."""
    if f.readline().strip() != b"ply":
        raise ValueError("Not a PLY file (missing 'ply' magic)")
    fmt = None
    num_points = None
    properties = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("Unexpected end of PLY header")
        tokens = line.strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == b"end_header":
            break
        if key == b"format":
            fmt = tokens[1].decode()
        elif key == b"element":
            in_vertex = tokens[1] == b"vertex"
            if in_vertex:
                num_points = int(tokens[2])
        elif key == b"property" and in_vertex:
            if tokens[1] == b"list":
                raise ValueError("List properties on vertices are not supported")
            ply_type = tokens[1].decode()
            if ply_type not in _PLY_TO_NUMPY:
                raise ValueError(f"Unknown PLY property type: {ply_type}")
            properties.append((tokens[2].decode(), _PLY_TO_NUMPY[ply_type]))
    if fmt is None or num_points is None:
        raise ValueError("Malformed PLY header (missing format or vertex element)")
    return fmt, num_points, properties


def read_ply(filename: str) -> np.ndarray:
    """Read a PLY file; returns a structured array of the vertex element."""
    with open(filename, "rb") as f:
        fmt, n, properties = _parse_header(f)
        if fmt == "ascii":
            data = np.empty(n, dtype=[(name, "<" + t) for name, t in properties])
            if n == 0:
                return data
            rows = np.loadtxt(f, max_rows=n, ndmin=2)
            for i, (name, _) in enumerate(properties):
                data[name] = rows[:, i]
            return data
        endian = "<" if fmt == "binary_little_endian" else ">"
        data = np.fromfile(f, dtype=[(name, endian + t) for name, t in properties],
                           count=n)
        if endian == ">":
            data = data.astype([(name, "<" + t) for name, t in properties])
        return data
