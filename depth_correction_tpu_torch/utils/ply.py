"""Structured PLY point reader and writer (the port's copy of
``depth_correction_tpu/utils/ply.py``; numpy only, no Open3D or plyfile).

Reads the vertex element of ascii / binary little-endian PLY files with
arbitrary scalar properties into a numpy structured array. Used for the
KITTI-360 semantic window clouds (reference: datasets/kitti360.py:266-278
reads them with kitti360scripts' read_ply) and the Newer College prior map
(reference: datasets/newer_college.py:216-229 reads it with Open3D).
"""
from __future__ import annotations

import numpy as np

__all__ = ["read_ply_structured", "write_ply_points"]

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_structured(path: str) -> np.ndarray:
    """Read the ``vertex`` element of a PLY file as a structured array.

    Supports ``ascii`` and ``binary_little_endian`` formats with scalar
    vertex properties (list properties end the vertex block in practice —
    faces follow vertices and are skipped).
    """
    with open(path, "rb") as f:
        line = f.readline().decode("ascii", errors="replace").strip()
        if line != "ply":
            raise ValueError("not a PLY file: %s" % path)
        fmt = None
        counts = {}
        props = {}
        current = None
        order = []
        while True:
            raw_line = f.readline()
            if not raw_line:
                raise ValueError("truncated PLY header (no end_header): %s" % path)
            line = raw_line.decode("ascii", errors="replace").strip()
            if line == "end_header":
                break
            parts = line.split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                current = parts[1]
                counts[current] = int(parts[2])
                props[current] = []
                order.append(current)
            elif parts[0] == "property" and current is not None:
                props[current].append(parts[1:])

        if "vertex" not in counts:
            raise ValueError("PLY without a vertex element: %s" % path)
        if order and order[0] != "vertex":
            raise ValueError("vertex is not the first element: %s" % path)
        vprops = props["vertex"]
        if any(p[0] == "list" for p in vprops):
            raise ValueError("list-typed vertex properties are unsupported")
        n = counts["vertex"]

        if fmt == "ascii":
            dtype = np.dtype([(p[1], _PLY_TYPES[p[0]]) for p in vprops])
            rows = [f.readline().split() for _ in range(n)]
            arr = np.zeros(n, dtype)
            table = np.asarray(rows)
            for i, p in enumerate(vprops):
                arr[p[1]] = table[:, i].astype(dtype[i])
            return arr
        if fmt == "binary_little_endian":
            dtype = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]]) for p in vprops])
            return np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        raise ValueError("unsupported PLY format: %s" % fmt)


def write_ply_points(path: str, arr: np.ndarray, binary: bool = True) -> None:
    """Write a structured array of scalar fields as a PLY vertex cloud."""
    inv_types = {
        "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
        "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
    }
    names = arr.dtype.names
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append("element vertex %d" % len(arr))
    for name in names:
        header.append(
            "property %s %s" % (inv_types[arr.dtype[name].name], name)
        )
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            out = np.zeros(
                len(arr),
                np.dtype([(nm, arr.dtype[nm].newbyteorder("<")) for nm in names]),
            )
            for nm in names:
                out[nm] = arr[nm]
            f.write(out.tobytes())
        else:
            for row in arr:
                f.write(
                    (" ".join(str(np.asarray(v).item()) for v in row) + "\n").encode()
                )
