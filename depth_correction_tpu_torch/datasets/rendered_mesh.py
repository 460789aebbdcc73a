"""Rendered-mesh dataset: a lidar simulator over a triangle mesh (the
port's counterpart of ``depth_correction_tpu/datasets/rendered_mesh.py``).

Counterpart of the reference's RenderedMeshDataset
(reference: dataset.py:490-715), which composites pytorch3d perspective
rasterizations into 360-degree scans. Here each scan is cast directly: a
spherical beam grid (azimuth x elevation) of rays from the sensor pose,
intersected against the mesh (ops/raycast.py, in float32 on ``device``:
the card unless the caller names the CPU); per-point normals come from the
hit triangle. Scans are cached in memory per id and, with ``cache_dir``, on
disk.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.raycast import raycast_mesh
from ..utils.mesh import load_mesh
from .synthetic import _DatasetBase, make_structured


__all__ = ["RenderedMeshDataset"]


class RenderedMeshDataset(_DatasetBase):
    def __init__(self, mesh_name: str, n_poses: int = 8, height: float = 1.5,
                 radius: float = 3.0, h_beams: int = 64, v_beams: int = 32,
                 fov_up: float = 0.4, fov_down: float = -0.4,
                 max_range: float = 50.0, cache_dir: Optional[str] = None,
                 device="cuda", **_unused):
        """
        :param mesh_name: path to an .obj/.ply scene (``rendered_mesh/<path>``
            names accepted).
        :param n_poses: viewpoints along a circle of ``radius``.
        :param h_beams: azimuth beams per revolution.
        :param v_beams: elevation beams in [fov_down, fov_up].
        :param device: where the rays are cast.
        """
        self.cache_dir = cache_dir
        self.device = torch.device(device)
        if mesh_name.startswith("rendered_mesh/"):
            mesh_name = mesh_name[len("rendered_mesh/"):]
        path = mesh_name
        if not os.path.isabs(path):
            root = os.environ.get(
                "DEPTH_CORRECTION_DATA",
                os.path.join(os.path.dirname(__file__), "..", "..", "data"),
            )
            candidate = os.path.join(root, "meshes", mesh_name)
            path = candidate if os.path.exists(candidate) else mesh_name
        verts, faces = load_mesh(path)
        self.verts = np.asarray(verts, np.float32)
        self.faces = np.asarray(faces, np.int64)
        tri = self.verts[self.faces]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        self.face_normals = fn / np.maximum(
            np.linalg.norm(fn, axis=1, keepdims=True), 1e-30
        )
        self.name = mesh_name
        self.path = path  # resolved mesh location (cache identity)
        self.n_poses = n_poses
        self.height = height
        self.radius = radius
        self.h_beams = h_beams
        self.v_beams = v_beams
        self.fov_up = fov_up
        self.fov_down = fov_down
        self.max_range = max_range
        self.ids = list(range(n_poses))
        self._cache = {}

        az = np.linspace(-np.pi, np.pi, h_beams, endpoint=False)
        el = np.linspace(fov_down, fov_up, v_beams)
        aa, ee = np.meshgrid(az, el, indexing="xy")
        self._beam_dirs = np.stack(
            [
                np.cos(ee) * np.cos(aa),
                np.cos(ee) * np.sin(aa),
                np.sin(ee),
            ],
            axis=-1,
        ).reshape(-1, 3).astype(np.float32)

    def cloud_pose(self, i):
        a = i * 2 * np.pi / self.n_poses
        pose = np.eye(4)
        # Sensor on a circle, yawed along the tangent.
        pose[:3, :3] = np.array(
            [[np.cos(a), -np.sin(a), 0.0],
             [np.sin(a), np.cos(a), 0.0],
             [0.0, 0.0, 1.0]]
        )
        pose[:3, 3] = [self.radius * np.cos(a), self.radius * np.sin(a), self.height]
        return pose

    def _disk_cache_path(self, i) -> Optional[str]:
        """Per-scan disk cache (reference: dataset.py:669-683 caches rendered
        scans so re-runs skip the expensive rendering) keyed by the render
        parameters."""
        if not self.cache_dir:
            return None
        # Key on the RESOLVED mesh path (hashed — distinct paths must not
        # collide, including same-named meshes found via different data
        # roots) plus the render parameters.
        import hashlib

        digest = hashlib.sha1(
            os.path.abspath(self.path).encode()
        ).hexdigest()[:12]
        key = "%s_%s_n%d_h%g_r%g_b%dx%d_f%g_%g_m%g" % (
            os.path.basename(self.name), digest, self.n_poses,
            self.height, self.radius, self.h_beams, self.v_beams,
            self.fov_up, self.fov_down, self.max_range,
        )
        return os.path.join(self.cache_dir, key, "%04d.npz" % i)

    def render_all(self) -> int:
        """Pre-render every scan into the disk cache (the ``render_meshes``
        verb's work, reference main.py:396-453)."""
        for i in self.ids:
            self.local_cloud(i)
        return len(self.ids)

    def rays(self, i):
        """Scan ``i``'s ray origins and world directions, (R, 3) float32 on
        ``device``."""
        pose = self.cloud_pose(i)
        dirs = (self._beam_dirs @ pose[:3, :3].T).astype(np.float32)
        origins = np.broadcast_to(pose[:3, 3], dirs.shape).astype(np.float32)
        return (torch.as_tensor(origins, device=self.device),
                torch.as_tensor(dirs, device=self.device))

    def mesh_tensors(self):
        """(vertices (V, 3) float32, faces (F, 3) int64) on ``device``."""
        if getattr(self, "_mesh_t", None) is None:
            self._mesh_t = (torch.as_tensor(self.verts, device=self.device),
                            torch.as_tensor(self.faces, device=self.device))
        return self._mesh_t

    def local_cloud(self, i):
        if i in self._cache:
            return self._cache[i]
        disk = self._disk_cache_path(i)
        if disk and os.path.exists(disk):
            data = np.load(disk)
            cloud = make_structured(data["points"], normals=data["normals"])
            self._cache[i] = cloud
            return cloud
        pose = self.cloud_pose(i)
        dirs_world = self._beam_dirs @ pose[:3, :3].T
        origins = np.broadcast_to(pose[:3, 3], dirs_world.shape).astype(np.float32)
        t, tri = raycast_mesh(*self.rays(i), *self.mesh_tensors(), t_max=self.max_range)
        t = t.cpu().numpy()
        tri = tri.cpu().numpy()
        hit = np.isfinite(t) & (tri >= 0)
        # Sensor-frame points; world normals rotated back into the sensor
        # frame like the reference's scan outputs.
        pts_world = origins[hit] + t[hit, None] * dirs_world[hit]
        pts_local = (pts_world - pose[:3, 3]) @ pose[:3, :3]
        normals_local = self.face_normals[tri[hit]] @ pose[:3, :3]
        cloud = make_structured(pts_local, normals=normals_local)
        disk = self._disk_cache_path(i)
        if disk:
            os.makedirs(os.path.dirname(disk), exist_ok=True)
            np.savez_compressed(disk, points=pts_local, normals=normals_local)
        self._cache[i] = cloud
        return cloud
