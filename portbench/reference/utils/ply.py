"""PLY reading and writing (binary little/big endian and ascii, named
scalar vertex properties). Counterpart of weasal_tpu/utils/ply.py
`read_ply` and `write_ply` (:138): the same files, byte for byte."""

from __future__ import annotations

from typing import List, Sequence

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

_NUMPY_TO_PLY = {
    np.dtype("int8"): "char",
    np.dtype("uint8"): "uchar",
    np.dtype("int16"): "short",
    np.dtype("uint16"): "ushort",
    np.dtype("int32"): "int",
    np.dtype("uint32"): "uint",
    np.dtype("int64"): "int",      # PLY has no portable 64-bit int; narrow
    np.dtype("uint64"): "uint",
    np.dtype("float32"): "float",
    np.dtype("float64"): "double",
    np.dtype("bool"): "uchar",
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


def _as_field_list(fields) -> List[np.ndarray]:
    """Normalize user fields to a list of 2-D arrays."""
    if isinstance(fields, np.ndarray):
        fields = [fields]
    fields = list(fields)
    out = []
    for field in fields:
        field = np.asarray(field)
        if field.ndim == 1:
            field = field[:, None]
        if field.ndim != 2:
            raise ValueError("PLY fields must be 1-D or 2-D arrays")
        out.append(field)
    return out


def write_ply(filename: str,
              fields,
              field_names: Sequence[str],
              as_ascii: bool = False) -> bool:
    """Write a PLY file.

    :param filename: destination path ('.ply' appended if absent)
    :param fields: array or list of arrays; total column count must equal
        len(field_names). Columns of each array share its dtype.
    :param field_names: one name per column.
    :param as_ascii: write ascii instead of binary little-endian.
    """
    fields = _as_field_list(fields)

    n_points = fields[0].shape[0]
    for field in fields:
        if field.shape[0] != n_points:
            raise ValueError("All PLY fields must have the same number of rows")

    n_cols = sum(field.shape[1] for field in fields)
    if n_cols != len(field_names):
        raise ValueError(
            f"Field names ({len(field_names)}) do not match columns ({n_cols})")

    if not filename.endswith(".ply"):
        filename += ".ply"

    # Build the structured dtype: one entry per column
    columns = []
    for field in fields:
        dt = field.dtype
        if dt == np.dtype("bool"):
            field = field.astype(np.uint8)
            dt = field.dtype
        if dt not in _NUMPY_TO_PLY:
            raise ValueError(f"Unsupported dtype for PLY: {dt}")
        for c in range(field.shape[1]):
            columns.append((field[:, c], dt))

    # int64/uint64 narrow to 32-bit on disk
    disk_dtypes = []
    for _, dt in columns:
        if dt == np.dtype("int64"):
            disk_dtypes.append(np.dtype("int32"))
        elif dt == np.dtype("uint64"):
            disk_dtypes.append(np.dtype("uint32"))
        else:
            disk_dtypes.append(dt)

    header = ["ply"]
    header.append("format ascii 1.0" if as_ascii
                  else "format binary_little_endian 1.0")
    header.append(f"element vertex {n_points}")
    for name, dt in zip(field_names, disk_dtypes):
        header.append(f"property {_NUMPY_TO_PLY[dt]} {name}")
    header.append("end_header\n")

    if as_ascii:
        with open(filename, "w") as f:
            f.write("\n".join(header))
            stacked = np.column_stack([col.astype(np.float64)
                                       for col, _ in columns])
            fmts = ["%d" if np.issubdtype(col.dtype, np.integer)
                    else "%.8g" for col, _ in columns]
            np.savetxt(f, stacked, fmt=fmts)
    else:
        dtype = np.dtype([(name, dt.newbyteorder("<"))
                          for name, dt in zip(field_names, disk_dtypes)])
        data = np.empty(n_points, dtype=dtype)
        for name, (col, _), ddt in zip(field_names, columns, disk_dtypes):
            if np.issubdtype(col.dtype, np.integer) and \
                    col.dtype.itemsize > ddt.itemsize and col.size:
                info = np.iinfo(ddt)
                lo, hi = int(col.min()), int(col.max())
                if lo < info.min or hi > info.max:
                    raise OverflowError(
                        f"column {name!r} range [{lo}, {hi}] does not fit "
                        f"the PLY disk type {ddt} — values would wrap")
            data[name] = col.astype(ddt)
        with open(filename, "wb") as f:
            f.write("\n".join(header).encode("ascii"))
            data.tofile(f)

    return True
