"""Minimal triangle-mesh IO and surface sampling (the port's copy of
``depth_correction_tpu/utils/mesh.py``; numpy only).

Replaces the reference's pytorch3d mesh path (reference: utils.py:241-250
``load_mesh`` and dataset.py:450 ``sample_points_from_meshes``) without the
dependency: OBJ and PLY (ascii + binary_little_endian) loading plus
area-weighted point/normal sampling.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_mesh", "sample_points_from_mesh"]


def _load_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                # Faces may be v, v/vt, v/vt/vn, v//vn; indices 1-based
                # (negative = relative). Fan-triangulate polygons.
                idx = [
                    int(tok.split("/")[0]) for tok in line.split()[1:]
                ]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for a, b in zip(idx[1:-1], idx[2:]):
                    faces.append([idx[0], a, b])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def _load_ply(path: str):
    with open(path, "rb") as f:
        header = []
        while True:
            raw_line = f.readline()
            if not raw_line:
                raise ValueError("truncated PLY header (no end_header): %s" % path)
            line = raw_line.decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        counts = {}
        props = {}
        current = None
        for line in header:
            parts = line.split()
            if parts[0] == "element":
                current = parts[1]
                counts[current] = int(parts[2])
                props[current] = []
            elif parts[0] == "property" and current:
                props[current].append(parts[1:])

        n_v = counts.get("vertex", 0)
        n_f = counts.get("face", 0)
        if fmt == "ascii":
            verts = []
            for _ in range(n_v):
                vals = f.readline().split()
                verts.append([float(v) for v in vals[:3]])
            faces = []
            for _ in range(n_f):
                vals = [int(v) for v in f.readline().split()]
                idx = vals[1 : 1 + vals[0]]
                for a, b in zip(idx[1:-1], idx[2:]):
                    faces.append([idx[0], a, b])
            return np.asarray(verts, np.float64), np.asarray(faces, np.int64)

        assert fmt == "binary_little_endian", "unsupported PLY format: %s" % fmt
        type_size = {"float": 4, "float32": 4, "double": 8, "float64": 8,
                     "int": 4, "int32": 4, "uint": 4, "uint32": 4,
                     "short": 2, "ushort": 2, "char": 1, "uchar": 1,
                     "int8": 1, "uint8": 1}
        vprops = props["vertex"]
        stride = sum(type_size[p[0]] for p in vprops)
        raw = f.read(n_v * stride)
        # x/y/z offsets within the vertex record.
        off = 0
        offsets = {}
        fmts = {"float": "f", "float32": "f", "double": "d", "float64": "d"}
        for p in vprops:
            offsets[p[1]] = (off, p[0])
            off += type_size[p[0]]
        verts = np.empty((n_v, 3))
        for c, name in enumerate("xyz"):
            o, t = offsets[name]
            verts[:, c] = np.ndarray(
                (n_v,), dtype="<" + fmts[t], buffer=raw,
                offset=o, strides=(stride,),
            )
        # Face list types per the header declaration (exporters vary:
        # "list uchar int" is common but "list int int" etc. are legal).
        int_fmt = {"char": "b", "int8": "b", "uchar": "B", "uint8": "B",
                   "short": "h", "int16": "h", "ushort": "H", "uint16": "H",
                   "int": "i", "int32": "i", "uint": "I", "uint32": "I"}
        list_p = next(
            (p for p in props.get("face", []) if p[0] == "list"), None
        )
        cf = int_fmt[list_p[1]] if list_p else "B"
        xf = int_fmt[list_p[2]] if list_p else "i"
        cs, xs = struct.calcsize(cf), struct.calcsize(xf)
        faces = []
        for _ in range(n_f):
            (cnt,) = struct.unpack("<" + cf, f.read(cs))
            idx = struct.unpack("<%d%s" % (cnt, xf), f.read(xs * cnt))
            for a, b in zip(idx[1:-1], idx[2:]):
                faces.append([idx[0], a, b])
        return verts, np.asarray(faces, np.int64)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a triangle mesh: (vertices (V, 3), faces (F, 3) int)."""
    if path.endswith(".obj"):
        return _load_obj(path)
    if path.endswith(".ply"):
        return _load_ply(path)
    raise ValueError("Supported mesh formats are *.obj or *.ply")


def sample_points_from_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    num_samples: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform area-weighted surface samples with face normals.

    :return: (points (N, 3), normals (N, 3) unit face normals).
    """
    rng = rng or np.random.default_rng(135)
    tri = verts[faces]  # (F, 3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    cross = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    prob = area / max(area.sum(), 1e-30)
    pick = rng.choice(len(faces), size=num_samples, p=prob)
    # Uniform barycentric sampling.
    u = rng.random(num_samples)
    v = rng.random(num_samples)
    flip = u + v > 1.0
    u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
    pts = tri[pick, 0] + u[:, None] * e1[pick] + v[:, None] * e2[pick]
    normals = cross[pick]
    normals = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-30)
    return pts, normals
