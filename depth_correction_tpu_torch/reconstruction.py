"""Surface reconstruction: TSDF fusion + marching tetrahedra (counterpart of
``depth_correction_tpu/reconstruction.py``, numpy and scipy on the host).

Own replacement for the reference's Open3D Poisson meshing
(reference: depth_cloud.py:655-682 ``to_mesh``/``to_pytorch3d_mesh``): build
a truncated signed-distance field from an oriented point cloud (signed
point-to-tangent-plane distance to the nearest surface point) and extract
the zero isosurface with marching *tetrahedra* — the tables-free variant of
marching cubes (each voxel splits into 6 tetrahedra; a tetrahedron's 16
sign cases emit 0-2 triangles), fully vectorized in numpy.

Offline tooling (meshes feed the lidar simulator and visual inspection),
so it runs host-side like the reference's Open3D call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["tsdf_from_cloud", "marching_tetrahedra", "cloud_to_mesh",
           "save_mesh_obj"]

# Unit-cube corner offsets and the canonical 6-tetrahedra split around the
# 0-6 diagonal (every tet contains corners 0 and 6, so faces between tets
# match up and the extracted surface is crack-free).
_CORNERS = np.asarray(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.int64,
)
_TETS = np.asarray(
    [
        [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
        [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
    ],
    np.int64,
)


def tsdf_from_cloud(
    points: np.ndarray,
    normals: np.ndarray,
    grid_res: float = 0.1,
    trunc: Optional[float] = None,
    pad_cells: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncated signed distance field of an oriented cloud.

    sdf(v) = (v - p_nn) . n_nn for the nearest surface point p_nn — the
    first-order (tangent-plane) signed distance, valid within ``trunc`` of
    the surface (beyond it the cell is marked invalid).

    :return: (sdf (X, Y, Z), valid (X, Y, Z) bool, origin (3,)).
    """
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    trunc = float(trunc if trunc is not None else 2.0 * grid_res)

    lo = points.min(axis=0) - pad_cells * grid_res
    hi = points.max(axis=0) + pad_cells * grid_res
    dims = np.maximum(np.ceil((hi - lo) / grid_res).astype(np.int64) + 1, 2)
    axes = [lo[a] + grid_res * np.arange(dims[a]) for a in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    voxels = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    tree = cKDTree(points)
    d, idx = tree.query(voxels, k=1, workers=-1)
    delta = voxels - points[idx]
    sdf = np.einsum("ij,ij->i", delta, normals[idx])
    valid = d <= trunc
    return (
        sdf.reshape(*dims),
        valid.reshape(*dims),
        lo,
    )


def marching_tetrahedra(
    sdf: np.ndarray,
    valid: Optional[np.ndarray],
    origin: np.ndarray,
    grid_res: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-isosurface triangles of an SDF grid (marching tetrahedra).

    :param sdf: (X, Y, Z) signed distances.
    :param valid: (X, Y, Z) bool; cubes with any invalid corner are skipped.
    :return: (verts (V, 3) float64, faces (F, 3) int64 into verts).
    """
    sdf = np.asarray(sdf, np.float64)
    dims = np.asarray(sdf.shape)
    if valid is None:
        valid = np.ones_like(sdf, bool)

    # All cube origins whose 8 corners are in range and valid.
    cx, cy, cz = [np.arange(dims[a] - 1) for a in range(3)]
    ox, oy, oz = np.meshgrid(cx, cy, cz, indexing="ij")
    cubes = np.stack([ox, oy, oz], axis=-1).reshape(-1, 3)  # (C, 3)

    corner_idx = cubes[:, None, :] + _CORNERS[None]  # (C, 8, 3)
    s8 = sdf[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    v8 = valid[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    keep = v8.all(axis=1)
    cubes, corner_idx, s8 = cubes[keep], corner_idx[keep], s8[keep]
    pos8 = origin + corner_idx * grid_res  # (C, 8, 3)

    tris = []

    def edge_point(p1, s1, p2, s2):
        den = s1 - s2  # opposite signs on a crossing edge -> never ~0,
        den = np.where(np.abs(den) < 1e-30, np.copysign(1e-30, den), den)
        t = np.clip(s1 / den, 0.0, 1.0)
        return p1 + t[:, None] * (p2 - p1)

    def orient(tri, p_rows, neg_rows):
        """Flip triangles whose geometric normal opposes the local outward
        direction (negative -> positive SDF corners), so winding-derived
        face normals are globally consistent and point outward — required
        when a reconstructed mesh feeds back into the renderer."""
        wpos = (~neg_rows).astype(np.float64)
        wneg = neg_rows.astype(np.float64)
        mp = (p_rows * wpos[..., None]).sum(1) / wpos.sum(1)[:, None]
        mn = (p_rows * wneg[..., None]).sum(1) / wneg.sum(1)[:, None]
        outward = mp - mn
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        flip = np.sum(n * outward, axis=1) < 0.0
        tri[flip] = tri[flip, ::-1]
        return tri

    for tet in _TETS:
        s = s8[:, tet]  # (C, 4)
        p = pos8[:, tet]  # (C, 4, 3)
        neg = s < 0.0
        count = neg.sum(axis=1)

        # One corner inside (or one outside): triangle on its three edges.
        for target in (1, 3):
            rows = np.flatnonzero(count == target)
            if not len(rows):
                continue
            inside = neg[rows] if target == 1 else ~neg[rows]
            i = inside.argmax(axis=1)
            others = np.argsort(~inside, axis=1)[:, 1:]  # the 3 remaining
            pi = p[rows, i]
            si = s[rows, i]
            vs = [
                edge_point(pi, si, p[rows, others[:, j]], s[rows, others[:, j]])
                for j in range(3)
            ]
            tri = np.stack(vs, axis=1)
            tris.append(orient(tri, p[rows], neg[rows]))

        # Two corners inside: quad over the four crossing edges -> 2 tris.
        rows = np.flatnonzero(count == 2)
        if len(rows):
            nr = neg[rows]
            order = np.argsort(~nr, axis=1)
            i1, i2 = order[:, 0], order[:, 1]  # negative pair
            j1, j2 = order[:, 2], order[:, 3]  # positive pair
            e11 = edge_point(p[rows, i1], s[rows, i1], p[rows, j1], s[rows, j1])
            e12 = edge_point(p[rows, i1], s[rows, i1], p[rows, j2], s[rows, j2])
            e22 = edge_point(p[rows, i2], s[rows, i2], p[rows, j2], s[rows, j2])
            e21 = edge_point(p[rows, i2], s[rows, i2], p[rows, j1], s[rows, j1])
            tris.append(orient(np.stack([e11, e12, e22], axis=1), p[rows], nr))
            tris.append(orient(np.stack([e11, e22, e21], axis=1), p[rows], nr))

    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri = np.concatenate(tris, axis=0)  # (F, 3, 3)

    # Weld vertices (quantized) so faces share indices.
    flat = tri.reshape(-1, 3)
    key = np.round(flat / (grid_res * 1e-6)).astype(np.int64)
    _, first, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[first]
    faces = inv.reshape(-1, 3)
    # Drop degenerate faces (two welded corners equal).
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


def cloud_to_mesh(
    points: np.ndarray,
    normals: np.ndarray,
    grid_res: float = 0.1,
    trunc: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Oriented cloud -> triangle mesh (the reference's ``to_mesh`` role,
    depth_cloud.py:655-682, without the Open3D Poisson dependency)."""
    sdf, valid, origin = tsdf_from_cloud(points, normals, grid_res, trunc)
    return marching_tetrahedra(sdf, valid, origin, grid_res)


def save_mesh_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a Wavefront OBJ (consumable by MeshDataset / utils.mesh)."""
    with open(path, "w") as f:
        for v in np.asarray(verts, np.float64):
            f.write("v %.9g %.9g %.9g\n" % tuple(v))
        for a, b, c in np.asarray(faces, np.int64) + 1:
            f.write("f %d %d %d\n" % (a, b, c))
