"""Batched ray-triangle casting, Moller-Trumbore (counterpart of
``depth_correction_tpu/ops/raycast.py``).

The lidar-simulation primitive behind the rendered-mesh dataset. The
reference composes pytorch3d perspective rasterizations (reference:
dataset.py:1073-1130); here rays intersect triangles directly, in component
form (every intermediate is a (rays, faces) block), chunked over rays and
faces so memory stays O(chunk * face_chunk) for any mesh. Plain torch on the
tensors' device: the JAX package computes this in XLA, not in a kernel.
"""
from __future__ import annotations

import torch

__all__ = ["raycast_mesh"]


def raycast_mesh(origins: torch.Tensor, dirs: torch.Tensor, verts: torch.Tensor,
                 faces: torch.Tensor, t_max: float = 1e9, chunk: int = 4096,
                 face_chunk: int = 2048):
    """Closest hit of each ray on a triangle mesh.

    :param origins: (R, 3) ray origins.
    :param dirs: (R, 3) unit ray directions.
    :param verts: (V, 3) mesh vertices, in the rays' dtype and device.
    :param faces: (F, 3) integer triangle indices.
    :return: (t (R,) hit distances, inf on a miss; tri (R,) int32 triangle
        index, -1 on a miss). Of equal distances the lowest triangle index
        wins, as in the JAX package.
    """
    faces = faces.long()
    tri = verts[faces]  # (F, 3, 3)
    v0 = tri[:, 0]
    e1 = (tri[:, 1] - v0).T.contiguous()  # (3, F)
    e2 = (tri[:, 2] - v0).T.contiguous()
    v0 = v0.T.contiguous()
    eps = 1e-9
    n_faces = faces.shape[0]
    inf = torch.tensor(float("inf"), dtype=origins.dtype, device=origins.device)
    ts, tris = [], []
    for r0 in range(0, origins.shape[0], chunk):
        o, d = origins[r0:r0 + chunk], dirs[r0:r0 + chunk]
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # (C, 1)
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        t_best = torch.full((o.shape[0],), float("inf"), dtype=o.dtype, device=o.device)
        tri_best = torch.full((o.shape[0],), -1, dtype=torch.int32, device=o.device)
        for f0 in range(0, n_faces, face_chunk):
            f1 = min(f0 + face_chunk, n_faces)
            v0x, v0y, v0z = (v0[i, None, f0:f1] for i in range(3))  # (1, FC)
            e1x, e1y, e1z = (e1[i, None, f0:f1] for i in range(3))
            e2x, e2y, e2z = (e2[i, None, f0:f1] for i in range(3))
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            a = e1x * hx + e1y * hy + e1z * hz
            parallel = torch.abs(a) < eps
            f = 1.0 / torch.where(parallel, torch.ones_like(a), a)
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            u = f * (sx * hx + sy * hy + sz * hz)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = f * (dx * qx + dy * qy + dz * qz)
            t = f * (e2x * qx + e2y * qy + e2z * qz)
            ok = (~parallel & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
                  & (t > eps) & (t <= t_max))
            t = torch.where(ok, t, inf)
            best = torch.argmin(t, dim=-1)  # the first of equal distances
            tb = t.gather(1, best[:, None])[:, 0]
            trib = torch.where(torch.isinf(tb), -1, best + f0).to(torch.int32)
            # Strict '<' keeps the lowest-index face on ties across blocks.
            better = tb < t_best
            t_best = torch.where(better, tb, t_best)
            tri_best = torch.where(better, trib, tri_best)
        ts.append(t_best)
        tris.append(tri_best)
    if not ts:
        return (torch.empty(0, dtype=origins.dtype, device=origins.device),
                torch.empty(0, dtype=torch.int32, device=origins.device))
    return torch.cat(ts), torch.cat(tris)
