"""The port's ray casting and rendered-mesh dataset against the JAX
package's, on the CPU.

``ops/raycast.raycast_mesh`` (Moller-Trumbore closest hit, chunked over
rays and faces) in float64 on a subdivided room: hit distances within 1e-6
relative and the same triangles, ties on shared edges included (the lowest
index wins in both); ``RenderedMeshDataset`` and its disk cache (mirrors
tests/test_raycast.py).
"""
import os

import numpy as np
import pytest
import torch
from numpy.lib.recfunctions import structured_to_unstructured as s2u

import jax.numpy as jnp

from depth_correction_tpu.datasets.rendered_mesh import RenderedMeshDataset as JRendered
from depth_correction_tpu.ops.raycast import raycast_mesh as j_raycast
from depth_correction_tpu_torch.datasets.rendered_mesh import RenderedMeshDataset as TRendered
from depth_correction_tpu_torch.ops.raycast import raycast_mesh as t_raycast


def room_mesh(half=5.0, height=4.0, n=1):
    """An inward-facing box room centred at the origin (floor z = 0), each
    side an n x n grid of quads split into two triangles."""
    verts, faces = [], []

    def side(origin, du, dv):
        base = len(verts)
        for i in range(n + 1):
            for j in range(n + 1):
                verts.append(np.asarray(origin) + du * i / n + dv * j / n)
        for i in range(n):
            for j in range(n):
                a, b = base + i * (n + 1) + j, base + (i + 1) * (n + 1) + j
                faces.append([a, b, b + 1])
                faces.append([a, b + 1, a + 1])

    h = half
    x, y, z = np.eye(3)
    side([-h, -h, 0], 2 * h * x, 2 * h * y)  # floor
    side([-h, -h, height], 2 * h * x, 2 * h * y)  # ceiling
    side([-h, -h, 0], 2 * h * y, height * z)  # -x wall
    side([h, -h, 0], 2 * h * y, height * z)  # +x wall
    side([-h, -h, 0], 2 * h * x, height * z)  # -y wall
    side([-h, h, 0], 2 * h * x, height * z)  # +y wall
    return np.asarray(verts), np.asarray(faces, np.int64)


def write_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write("v %.9g %.9g %.9g\n" % tuple(v))
        for face in faces:
            f.write("f %d %d %d\n" % tuple(face + 1))


def _rays(n=600, seed=0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform([-3, -3, 0.5], [3, 3, 3.5], (n, 3))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # Rays at the vertices and diagonals of the floor's quads: equal
    # distances on shared edges, where the lowest index must win.
    corners = np.array([[0.0, 0.0], [1.25, 1.25], [2.5, 0.0], [-1.25, 2.5], [0.625, 0.625]])
    o = np.concatenate([corners, np.full((len(corners), 1), 2.0)], 1)
    d = np.tile([[0.0, 0.0, -1.0]], (len(corners), 1))
    # Rays from outside pointing away: misses.
    o2 = np.array([[20.0, 0.0, 2.0], [0.0, -30.0, 1.0]])
    d2 = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    return np.concatenate([origins, o, o2]), np.concatenate([dirs, d, d2])


@pytest.mark.parametrize("chunks", [(64, 50), (4096, 2048)])
def test_raycast_matches_jax(chunks):
    """float64: t within 1e-6 relative (inf on the same misses), the same
    triangle on every ray, for any chunking."""
    verts, faces = room_mesh(n=4)
    o, d = _rays()
    chunk, face_chunk = chunks
    jt, jtri = j_raycast(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts), jnp.asarray(faces),
                         t_max=50.0, chunk=chunk, face_chunk=face_chunk)
    tt, ttri = t_raycast(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(verts),
                         torch.as_tensor(faces), t_max=50.0, chunk=chunk, face_chunk=face_chunk)
    jt, jtri = np.asarray(jt), np.asarray(jtri)
    assert ttri.dtype == torch.int32 and tt.dtype == torch.float64
    np.testing.assert_array_equal(ttri.numpy(), jtri)
    hit = np.isfinite(jt)
    np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-6)
    assert hit.sum() >= 600 and (jtri[~hit] == -1).all() and (~hit).sum() >= 2


def test_raycast_known_distances():
    verts, faces = room_mesh()
    o = torch.tensor([[0.0, 0.0, 2.0]] * 4)
    d = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, -1.0], [0, 0, 1.0]])
    t, tri = t_raycast(o, d, torch.as_tensor(verts, dtype=torch.float32),
                       torch.as_tensor(faces))
    np.testing.assert_allclose(t.numpy(), [5.0, 5.0, 2.0, 2.0], rtol=1e-6)
    assert (tri >= 0).all()
    t, tri = t_raycast(o, d, torch.as_tensor(verts, dtype=torch.float32),
                       torch.as_tensor(faces), t_max=1.5)
    assert torch.isinf(t).all() and (tri == -1).all()


def _room_file(tmp_path, n=3):
    path = str(tmp_path / "room.obj")
    write_obj(path, *room_mesh(n=n))
    return path


def test_rendered_mesh_matches_jax(tmp_path):
    """The port's scans (float32 casting on the CPU) against the JAX
    package's: the same hits, points within 1e-5 m, equal normals, equal
    poses."""
    path = _room_file(tmp_path)
    kw = dict(n_poses=3, radius=2.0, height=1.5, h_beams=48, v_beams=16)
    jds, tds = JRendered(path, **kw), TRendered(path, device="cpu", **kw)
    assert len(tds) == len(jds) == 3
    for (jc, jp), (tc, tp) in zip(jds, tds):
        np.testing.assert_array_equal(tp, jp)
        assert tc.dtype == jc.dtype and len(tc) == len(jc) > 300
        np.testing.assert_allclose(s2u(tc[["x", "y", "z"]]), s2u(jc[["x", "y", "z"]]),
                                   rtol=0, atol=1e-5)
        normals = ["normal_x", "normal_y", "normal_z"]
        np.testing.assert_array_equal(s2u(tc[normals]), s2u(jc[normals]))
    world = s2u(tc[["x", "y", "z"]]) @ tp[:3, :3].T + tp[:3, 3]
    assert np.all(np.abs(world[:, :2]) <= 5.0 + 1e-3)
    assert tds.local_cloud(0) is tds.local_cloud(0)


def test_rendered_mesh_disk_cache(tmp_path):
    """render_all fills the disk cache; a new dataset reloads its scans bit
    for bit; other render parameters take other entries."""
    path = _room_file(tmp_path, n=1)
    cache = str(tmp_path / "cache")
    kw = dict(n_poses=3, radius=2.0, height=1.5, h_beams=32, v_beams=12, cache_dir=cache,
              device="cpu")
    ds = TRendered(path, **kw)
    assert ds.render_all() == 3
    files = [n for _, _, names in os.walk(cache) for n in names if n.endswith(".npz")]
    assert len(files) == 3
    ds2 = TRendered(path, **kw)
    ds2.mesh_tensors = None  # a reload must not cast rays
    c1, c2 = ds.local_cloud(1), ds2.local_cloud(1)
    assert c1.dtype == c2.dtype and len(c1) == len(c2)
    for name in c1.dtype.names:
        np.testing.assert_array_equal(c1[name], c2[name])
    TRendered(path, **dict(kw, h_beams=16)).local_cloud(0)
    assert len([n for _, _, names in os.walk(cache) for n in names]) == 4


def test_create_dataset_casts_rays_on_the_config_device(tmp_path):
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.datasets import create_dataset

    path = _room_file(tmp_path, n=1)
    cfg = Config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_dataset("rendered_mesh/" + path, cfg)
    cfg.device = "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.0, 100.0, 0.0
    cfg.dataset_kwargs = {"n_poses": 2, "h_beams": 24, "v_beams": 8}
    cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
    ds = create_dataset("rendered_mesh/" + path, cfg)
    cloud, pose = ds[1]
    cfg.dataset_kwargs["device"] = "cpu"
    assert len(create_dataset("rendered_mesh/" + path, cfg)[1][0]) == len(cloud)
    assert len(cloud) > 100 and pose.shape == (4, 4)
