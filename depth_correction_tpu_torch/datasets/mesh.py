"""Mesh-backed synthetic dataset (the port's copy of
``depth_correction_tpu/datasets/mesh.py``; numpy only).

Counterpart of the reference's MeshDataset (reference: dataset.py:417-487):
a global cloud sampled area-uniformly from a triangle mesh (with face
normals), subsampled per pose — without the pytorch3d dependency
(utils/mesh.py provides IO + sampling).
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.mesh import load_mesh, sample_points_from_mesh
from .synthetic import BaseDataset

__all__ = ["MeshDataset"]


class MeshDataset(BaseDataset):
    def __init__(self, mesh_name: str, n_poses: int = 5,
                 size=((-10.0, 10.0), (-10.0, 10.0), (-10.0, 10.0)),
                 n_pts_to_sample: int = 1_000_000, seed: int = 135, **_unused):
        super().__init__(name=mesh_name, n_poses=n_poses, size=size)
        path = mesh_name
        if not os.path.isabs(path):
            root = os.environ.get(
                "DEPTH_CORRECTION_DATA",
                os.path.join(os.path.dirname(__file__), "..", "..", "data"),
            )
            path = os.path.join(root, "meshes", mesh_name)
        if not os.path.exists(path):
            raise FileNotFoundError("Mesh file %s does not exist" % path)
        verts, faces = load_mesh(path)
        pts, normals = sample_points_from_mesh(
            verts, faces, n_pts_to_sample, rng=np.random.default_rng(seed)
        )
        # Crop to the configured volume (reference: dataset.py:451-456).
        keep = np.ones(len(pts), bool)
        for a in range(3):
            keep &= (pts[:, a] >= size[a][0]) & (pts[:, a] <= size[a][1])
        self.pts = pts[keep]
        self.normals = normals[keep]
        self.n_pts = len(self.pts)

    def __str__(self):
        return str(self.name)
