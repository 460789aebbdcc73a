"""The port's real-data loaders and file readers against the JAX package's,
on files the tests write (no downloads).

Mirrors tests/test_datasets_io.py, test_datasets_io2.py, test_dataset_aux.py
and test_mesh.py: the PLY, PCD (ascii, binary, binary_compressed through the
pure-Python LZF decoder) and mesh readers; the SemanticKITTI, KITTI-360
(with its dynamic-object removal and semantic label transfer), Newer College
(beam-origin viewpoints, the kalibr chain, the prior map), FEE Corridor and
mesh datasets. Every array and pose is bit-equal to the JAX package's, and
``dataset_by_name`` resolves the same names.
"""
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from numpy.lib.recfunctions import unstructured_to_structured as u2s

import depth_correction_tpu.datasets.fee_corridor as j_fee
import depth_correction_tpu.datasets.kitti360 as j_k3
import depth_correction_tpu.datasets.newer_college as j_nc
import depth_correction_tpu.datasets.semantic_kitti as j_sk
import depth_correction_tpu_torch.datasets.fee_corridor as t_fee
import depth_correction_tpu_torch.datasets.kitti360 as t_k3
import depth_correction_tpu_torch.datasets.newer_college as t_nc
import depth_correction_tpu_torch.datasets.semantic_kitti as t_sk
from depth_correction_tpu.utils import mesh as j_mesh
from depth_correction_tpu.utils import pcd as j_pcd
from depth_correction_tpu.utils import ply as j_ply
from depth_correction_tpu_torch.utils import mesh as t_mesh
from depth_correction_tpu_torch.utils import pcd as t_pcd
from depth_correction_tpu_torch.utils import ply as t_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_arrays(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.names:
        for name in a.dtype.names:
            np.testing.assert_array_equal(a[name], b[name])
    else:
        np.testing.assert_array_equal(a, b)


def _same_dataset(jds, tds):
    """The same ids, scans and poses, bit for bit."""
    assert list(tds.ids) == list(jds.ids) and len(tds) == len(jds) > 0
    assert str(tds) == str(jds)
    for (jc, jp), (tc, tp) in zip(jds, tds):
        _same_arrays(tc, jc)
        _same_arrays(tp, jp)


# ---------------------------------------------------------------- readers

@pytest.mark.parametrize("binary", [True, False])
def test_ply_matches_jax(binary, tmp_path):
    """write_ply_points / read_ply_structured round trips, across the
    packages."""
    rng = np.random.default_rng(0)
    arr = np.zeros(50, np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"), ("red", "u1"),
                                 ("semantic", "i4"), ("w", "f8")]))
    arr["x"], arr["y"], arr["z"] = rng.normal(size=(3, 50)).astype(np.float32)
    arr["red"] = rng.integers(0, 255, 50)
    arr["semantic"] = rng.integers(0, 40, 50)
    arr["w"] = rng.normal(size=50)
    tpath, jpath = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    t_ply.write_ply_points(tpath, arr, binary=binary)
    j_ply.write_ply_points(jpath, arr, binary=binary)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    back = t_ply.read_ply_structured(tpath)
    _same_arrays(back, j_ply.read_ply_structured(tpath))
    assert back.dtype.names == arr.dtype.names
    if binary:
        _same_arrays(back, arr.astype(back.dtype))
    with open(str(tmp_path / "bad.ply"), "w") as f:
        f.write("ply\nformat ascii 1.0\n")
    for reader in (t_ply.read_ply_structured, j_ply.read_ply_structured):
        with pytest.raises(ValueError):
            reader(str(tmp_path / "bad.ply"))


def _lzf_literal(body: bytes) -> bytes:
    """A literal-only LZF stream (runs of at most 32 bytes)."""
    out = bytearray()
    for i in range(0, len(body), 32):
        run = body[i:i + 32]
        out += bytes([len(run) - 1]) + run
    return bytes(out)


def _write_pcd(path, encoding, n=40, seed=0):
    rng = np.random.default_rng(seed)
    x, y, z = rng.uniform(-5, 5, (3, n)).astype(np.float32)
    rings = np.tile(np.arange(2, dtype=np.uint16), (n, 1))
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z ring\nSIZE 4 4 4 2\nTYPE F F F U\n"
              "COUNT 1 1 1 2\nWIDTH %d\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %d\n"
              "DATA %s\n" % (n, n, encoding))
    with open(path, "wb") as f:
        f.write(header.encode())
        if encoding == "ascii":
            for i in range(n):
                f.write(("%.6f %.6f %.6f %d %d\n" % (x[i], y[i], z[i], *rings[i])).encode())
        elif encoding == "binary":
            rec = np.zeros(n, np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                                        ("r0", "u2"), ("r1", "u2")]))
            rec["x"], rec["y"], rec["z"] = x, y, z
            rec["r0"], rec["r1"] = rings[:, 0], rings[:, 1]
            f.write(rec.tobytes())
        else:
            body = x.tobytes() + y.tobytes() + z.tobytes() + rings.tobytes()
            comp = _lzf_literal(body)
            f.write(struct.pack("<II", len(comp), len(body)))
            f.write(comp)
    return x, rings


@pytest.mark.parametrize("encoding", ["ascii", "binary", "binary_compressed"])
def test_pcd_matches_jax(encoding, tmp_path):
    path = str(tmp_path / "c.pcd")
    x, rings = _write_pcd(path, encoding)
    out = t_pcd.read_pcd(path)
    _same_arrays(out, j_pcd.read_pcd(path))
    np.testing.assert_allclose(out["x"], x, atol=1e-6)
    np.testing.assert_array_equal(out["ring_1"], rings[:, 1])


def test_lzf_decompress_matches_jax():
    """Literal runs, short matches and the length-7 extension with an
    overlapping reference; a truncated stream raises."""
    cases = [(bytes([0x02]) + b"abc" + bytes([0xE0, 0x00, 0x02]), 12),
             (bytes([0x01]) + b"xy" + bytes([0x40, 0x01]), 6),
             (bytes([0x03]) + b"abcd" + bytes([0xE0, 0x05, 0x03]), 18)]
    for stream, size in cases:
        assert t_pcd.lzf_decompress(stream, size) == j_pcd.lzf_decompress(stream, size)
    assert t_pcd.lzf_decompress(cases[0][0], 12) == b"abcabcabcabc"
    with pytest.raises(ValueError):
        t_pcd.lzf_decompress(bytes([0x02]) + b"abc", 12)


CUBE_VERTS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                       [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], float)
CUBE_FACES = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                       [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])


def write_cube(path, fmt):
    if fmt == "obj":
        with open(path, "w") as f:
            for v in CUBE_VERTS:
                f.write("v %f %f %f\n" % tuple(v))
            f.write("f 1/1/1 2/2/2 3/3/3 4/4/4\n")  # a quad, fan-triangulated
            for face in CUBE_FACES[2:]:
                f.write("f %d %d %d\n" % tuple(face + 1))
        return
    head = ("ply\nformat %s 1.0\nelement vertex 8\nproperty float x\nproperty float y\n"
            "property float z\nelement face 12\nproperty list uchar int vertex_indices\n"
            "end_header\n" % ("ascii" if fmt == "ply_ascii" else "binary_little_endian"))
    with open(path, "wb") as f:
        f.write(head.encode())
        if fmt == "ply_ascii":
            for v in CUBE_VERTS:
                f.write(("%g %g %g\n" % tuple(v)).encode())
            for face in CUBE_FACES:
                f.write(("3 %d %d %d\n" % tuple(face)).encode())
        else:
            f.write(CUBE_VERTS.astype("<f4").tobytes())
            for face in CUBE_FACES:
                f.write(struct.pack("<B3i", 3, *face))


@pytest.mark.parametrize("fmt", ["obj", "ply_ascii", "ply_binary"])
def test_mesh_io_and_sampling_match_jax(fmt, tmp_path):
    """load_mesh of obj and ply (ascii, binary) and the seeded area-uniform
    sampling equal the JAX package's."""
    path = str(tmp_path / ("cube.%s" % ("obj" if fmt == "obj" else "ply")))
    write_cube(path, fmt)
    tv, tf = t_mesh.load_mesh(path)
    jv, jf = j_mesh.load_mesh(path)
    _same_arrays(tv, jv)
    _same_arrays(tf, jf)
    np.testing.assert_allclose(tv, CUBE_VERTS)
    assert tf.shape == (12, 3)
    tp, tn = t_mesh.sample_points_from_mesh(tv, tf, 3000, rng=np.random.default_rng(3))
    jp, jn = j_mesh.sample_points_from_mesh(jv, jf, 3000, rng=np.random.default_rng(3))
    _same_arrays(tp, jp)
    _same_arrays(tn, jn)
    on_face = np.isclose(tp, 0.0, atol=1e-9) | np.isclose(tp, 1.0, atol=1e-9)
    assert on_face.any(axis=1).all()
    with pytest.raises(ValueError):
        t_mesh.load_mesh(str(tmp_path / "cube.stl"))


def test_mesh_dataset_matches_jax(tmp_path):
    from depth_correction_tpu.config import Config as JConfig
    from depth_correction_tpu.datasets import create_dataset as j_create
    from depth_correction_tpu_torch.config import Config as TConfig
    from depth_correction_tpu_torch.datasets import create_dataset as t_create
    from depth_correction_tpu_torch.datasets import dataset_by_name
    from depth_correction_tpu_torch.datasets.mesh import MeshDataset

    path = str(tmp_path / "scene.obj")
    with open(path, "w") as f:
        f.write("v -10 -10 0\nv 10 -10 0\nv 10 10 0\nv -10 10 0\nf 1 2 3\nf 1 3 4\n")
    assert dataset_by_name(path) is MeshDataset
    sets = []
    for cls, create in ((JConfig, j_create), (TConfig, t_create)):
        cfg = cls()
        cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.0, 100.0, 0.0
        cfg.dataset_kwargs = {"n_pts_to_sample": 20000, "n_poses": 4}
        cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
        sets.append(create(path, cfg))
    _same_dataset(*sets)
    cloud, _ = sets[1][0]
    assert len(cloud) > 1000 and "normal_x" in cloud.dtype.names
    with pytest.raises(FileNotFoundError):
        MeshDataset("missing.obj")


# ---------------------------------------------------------------- loaders

def _write_semantic_kitti(root, n=6):
    seq = root / "sequences" / "08"
    (seq / "velodyne").mkdir(parents=True)
    rng = np.random.default_rng(2)
    rows = []
    for i in range(n):
        rng.uniform(-10, 10, (40 + i, 4)).astype(np.float32).tofile(
            seq / "velodyne" / ("%06d.bin" % i))
        T = np.eye(4)
        T[:3, :3] = _rot(0.1 * i)
        T[:3, 3] = [i, 0.3 * i, 0]
        rows.append(" ".join("%.9f" % x for x in T[:3].ravel()))
    (seq / "poses.txt").write_text("\n".join(rows) + "\n")
    (seq / "calib.txt").write_text(
        "P0: " + " ".join("%.6f" % x for x in np.eye(4)[:3].ravel()) + "\n"
        "Tr: " + " ".join("%.6f" % x for x in np.arange(12) / 7.0) + "\n")
    return seq


def _rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def test_semantic_kitti_matches_jax(tmp_path, monkeypatch):
    seq = _write_semantic_kitti(tmp_path)
    monkeypatch.setattr(j_sk, "data_dir", str(tmp_path))
    monkeypatch.setattr(t_sk, "data_dir", str(tmp_path))
    for name in ("semantic_kitti/08_start_1_end_5_step_2", "08", "08_start_2_end_6_step_1"):
        _same_dataset(j_sk.Dataset(name), t_sk.Dataset(name))
    _same_dataset(j_sk.Dataset(path=str(seq)), t_sk.Dataset(path=str(seq)))
    ds = t_sk.Dataset("semantic_kitti/08_start_1_end_4_step_1")
    np.testing.assert_allclose(ds[0][1], np.eye(4), atol=1e-8)
    assert len(ds[1:]) == 2
    tc, jc = t_sk.read_calibration(str(seq / "calib.txt")), j_sk.read_calibration(
        str(seq / "calib.txt"))
    assert sorted(tc) == sorted(jc) == ["P0", "Tr"]
    for k in tc:
        _same_arrays(tc[k], jc[k])


def _write_kitti360(root, n_scans=4, calib=None, with_semantics=False):
    """A KITTI-360 drive: raw scans with one ego point each, cam0_to_world
    poses, a cam->velo calibration; optionally one dynamic and one static
    semantic window covering every frame."""
    drive = "2013_05_28_drive_0000_sync"
    scan_dir = root / "data_3d_raw" / drive / "velodyne_points" / "data"
    scan_dir.mkdir(parents=True)
    (root / "data_poses" / drive).mkdir(parents=True)
    (root / "calibration").mkdir(parents=True)
    if calib is None:
        calib = np.eye(4)
        calib[:3, :3] = _rot(0.3) @ np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]])
        calib[:3, 3] = [0.1, -0.2, 0.3]
    (root / "calibration" / "calib_cam_to_velo.txt").write_text(
        " ".join("%.9f" % x for x in calib[:3].ravel()))
    rng = np.random.default_rng(3)
    static_world = rng.uniform(3.0, 8.0, (n_scans, 60, 3))
    dynamic_world = rng.uniform(-8.0, -3.0, (10, 3))
    rows = []
    for i in range(n_scans):
        T = np.eye(4)
        T[:3, :3] = _rot(0.05 * i)
        T[:3, 3] = [i, 0.5 * i, 0.1 * i]
        rows.append("%d %s" % (i, " ".join("%.9f" % x for x in T.ravel())))
        lidar = T @ np.linalg.inv(calib)
        inv = np.linalg.inv(lidar)
        world = np.concatenate([static_world[i], dynamic_world + 0.01 * i])
        local = world @ inv[:3, :3].T + inv[:3, 3]
        raw = np.concatenate([local, np.ones((len(local), 1))], 1)
        raw = np.concatenate([raw, [[0.1, 0.1, 0.0, 1.0]]]).astype(np.float32)
        raw.tofile(scan_dir / ("%010d.bin" % i))
    (root / "data_poses" / drive / "cam0_to_world.txt").write_text("\n".join(rows))
    if with_semantics:
        base = root / "data_3d_semantics" / "train" / drive
        (base / "dynamic").mkdir(parents=True)
        (base / "static").mkdir(parents=True)
        dyn = np.concatenate([dynamic_world + 0.01 * i for i in range(n_scans)])
        t_ply.write_ply_points(str(base / "dynamic" / ("%010d_%010d.ply" % (0, n_scans))),
                               u2s(dyn.astype(np.float32), names=["x", "y", "z"]))
        pts = static_world.reshape(-1, 3).astype(np.float32)
        arr = np.zeros(len(pts), np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                                           ("semantic", "i4")]))
        arr["x"], arr["y"], arr["z"] = pts.T
        arr["semantic"] = 11
        t_ply.write_ply_points(str(base / "static" / ("%010d_%010d.ply" % (0, n_scans))), arr)
    return drive, calib


def test_kitti360_matches_jax(tmp_path, monkeypatch):
    """The name windows, the ego filter, the calibration chain and
    zero_origin, bit for bit; the loaded points are the written float32
    points with the ego point dropped."""
    drive, calib = _write_kitti360(tmp_path)
    monkeypatch.setattr(j_k3, "data_dir", str(tmp_path))
    monkeypatch.setattr(t_k3, "data_dir", str(tmp_path))
    for name, kw in (("kitti360/00_start_1_end_3_step_1", {}), ("00", {}),
                     ("00_start_0_end_4_step_2", {"zero_origin": False}),
                     ("00", {"filter_ego_pts_depth": None})):
        _same_dataset(j_k3.Dataset(name, **kw), t_k3.Dataset(name, **kw))
    ds = t_k3.Dataset("kitti360/00_start_1_end_3_step_1", zero_origin=False)
    raw = np.fromfile(tmp_path / "data_3d_raw" / drive / "velodyne_points" / "data"
                      / ("%010d.bin" % 1), np.float32).reshape(-1, 4)
    cloud, pose = ds[0]
    assert len(cloud) == len(raw) - 1
    np.testing.assert_array_equal(cloud["x"], raw[:-1, 0])
    T = np.eye(4)
    T[:3, :3] = _rot(0.05)
    T[:3, 3] = [1, 0.5, 0.1]
    np.testing.assert_allclose(pose, T @ np.linalg.inv(calib), atol=1e-9)
    np.testing.assert_allclose(t_k3.Dataset("00_start_1_end_3_step_1")[0][1], np.eye(4),
                               atol=1e-12)


def test_kitti360_dynamic_objects_and_labels_match_jax(tmp_path):
    """get_dynamic_points, remove_dynamic_objects (the filtered scans the
    loader reads with filtered_scans) and transfer_semantic_labels write
    the JAX package's files."""
    _write_kitti360(tmp_path, calib=np.eye(4), with_semantics=True)
    root = str(tmp_path)
    jds = j_k3.Dataset("00", path=root, filter_ego_pts_depth=None)
    tds = t_k3.Dataset("00", path=root, filter_ego_pts_depth=None)
    (jd, jr), (td, tr) = jds.get_dynamic_points(), tds.get_dynamic_points()
    assert tr == jr == [[0, 4]]
    _same_arrays(td[0], jd[0])
    jout = j_k3.remove_dynamic_objects(jds, out_dir=str(tmp_path / "jf"), dist_th=0.2)
    tout = t_k3.remove_dynamic_objects(tds, out_dir=str(tmp_path / "tf"), dist_th=0.2)
    for i in tds.ids:
        name = "%010d.bin" % i
        data = open(os.path.join(tout, name), "rb").read()
        assert data == open(os.path.join(jout, name), "rb").read()
        assert len(data) == (60 + 1) * 16  # the dynamic points dropped
    jlab = j_k3.transfer_semantic_labels(jds, out_dir=str(tmp_path / "jl"), dist_th=0.05)
    tlab = t_k3.transfer_semantic_labels(tds, out_dir=str(tmp_path / "tl"), dist_th=0.05)
    for i in tds.ids:
        for sub, ext in (("labels", "label"), ("velodyne", "bin")):
            name = os.path.join(sub, "%010d.%s" % (i, ext))
            assert (open(os.path.join(tlab, name), "rb").read()
                    == open(os.path.join(jlab, name), "rb").read())
        labels = np.fromfile(os.path.join(tlab, "labels", "%010d.label" % i), np.uint16)
        assert (labels[:60] == 11).all() and (labels[60:] == 0).all()
    t_k3.remove_dynamic_objects(tds, dist_th=0.2)
    cloud, _ = t_k3.Dataset("00", path=root, filtered_scans=True, filter_ego_pts_depth=None)[0]
    assert len(cloud) == 61
    dyn = np.asarray(td[0])
    np.testing.assert_array_equal(t_k3.dynamic_points_mask(dyn[:5] + 0.05, dyn, 0.2),
                                  j_k3.dynamic_points_mask(dyn[:5] + 0.05, dyn, 0.2))


def _write_newer_college(root, calib=True):
    seq = root / "01_short_experiment"
    (seq / "raw_format" / "ouster_scan").mkdir(parents=True)
    (seq / "ground_truth").mkdir(parents=True)
    rng = np.random.default_rng(4)
    rows = ["sec,nsec,x,y,z,qx,qy,qz,qw"]
    for i in range(5):
        if i != 3:  # a pose row without a scan
            _write_pcd(str(seq / "raw_format" / "ouster_scan" / ("cloud_%d_%09d.pcd" % (100 + i, 5))),
                       "binary", n=25 + i, seed=i)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        rows.append("%d,%d,%f,%f,%f,%f,%f,%f,%f" % (100 + i, 5, i, 0.2 * i, 0.1, *q))
    (seq / "ground_truth" / "registered_poses.csv").write_text("\n".join(rows) + "\n")
    if calib:
        base = root / "2020-ouster-os1-64-realsense" / "04_calibration" / "kalibr_output"
        (base / "cam-ouster-imu").mkdir(parents=True)
        (base / "ouster_imu_lidar_transforms.yaml").write_text(
            "os1_lidar_to_os1_imu:\n  rotation: [0.0, 0.0, 0.38268343, 0.92387953]\n"
            "  translation: [0.01, -0.02, 0.03]\n")
        t_cam = np.eye(4)
        t_cam[:3, :3] = _rot(0.2)
        t_cam[:3, 3] = [0.05, 0.0, -0.01]
        (base / "cam-ouster-imu" / "camchain-ouster_imu-cam-rooster_2020-03-11-10-05-35_0.yaml"
         ).write_text("cam0:\n  T_cam_imu:\n" + "".join(
             "  - [%s]\n" % ", ".join("%.9f" % v for v in row) for row in t_cam))
    prior = root / "03_new_college_prior_map"
    prior.mkdir()
    pts = np.repeat(np.linspace(0, 5, 30)[:, None], 2, axis=0) * [1, 0, 0]
    t_ply.write_ply_points(str(prior / "new-college-29-01-2020-1cm-resolution-libpmfiltered.ply"),
                           u2s(np.asarray(pts, np.float32), names=["x", "y", "z"]))
    return seq


@pytest.mark.parametrize("calib", [True, False])
def test_newer_college_matches_jax(calib, tmp_path, monkeypatch):
    """Scan ids present on disk and in the CSV, the beam-origin viewpoints,
    the kalibr chain (or none), zero_origin and the prior map in the first
    pose's frame, bit for bit."""
    seq = _write_newer_college(tmp_path, calib=calib)
    monkeypatch.setattr(j_nc, "data_dir", str(tmp_path))
    monkeypatch.setattr(t_nc, "data_dir", str(tmp_path))
    for name, kw in (("newer_college/01_short_experiment/start_0_end_3_step_1", {}),
                     ("01_short_experiment", {"zero_origin": False}),
                     ("01_short_experiment/start_1_end_5_step_2", {})):
        _same_dataset(j_nc.Dataset(name, **kw), t_nc.Dataset(name, **kw))
    tc, jc = t_nc.read_calibration(), j_nc.read_calibration()
    assert (tc is None) == (jc is None) == (not calib)
    for k in tc or {}:
        _same_arrays(tc[k], jc[k])
    ds = t_nc.Dataset("01_short_experiment")
    assert [i[0] for i in ds.ids] == [100, 101, 102, 104]
    cloud, _ = ds[1]
    np.testing.assert_allclose(np.hypot(cloud["vp_x"], cloud["vp_y"]),
                               t_nc.BEAM_ORIGIN_OFFSET, rtol=1e-3)
    for voxel in (0.3, None):
        gt = t_nc.Dataset("01_short_experiment", path=str(seq)).get_ground_truth_cloud(voxel)
        _same_arrays(gt, j_nc.Dataset("01_short_experiment", path=str(seq))
                     .get_ground_truth_cloud(voxel))
    assert len(gt) == 60


def _write_fee(root):
    seq = root / "sequences" / "seq1"
    for sub in ("static_ouster_points", "ouster_points", "poses", "calibration"):
        (seq / sub).mkdir(parents=True)
    (root / "maps" / "npz").mkdir(parents=True)
    rng = np.random.default_rng(1)
    dt = [("x", "f4"), ("y", "f4"), ("z", "f4"), ("vp_x", "f4"), ("vp_y", "f4"), ("vp_z", "f4")]
    for prefix in ("static_", ""):
        with open(seq / "poses" / ("%sposes.csv" % prefix), "w") as f:
            f.write("id, ts, " + ", ".join("T%d%d" % (i, j) for i in range(4)
                                           for j in range(4)) + "\n")
            for i in range(5):
                T = np.eye(4)
                T[:3, :3] = _rot(0.1 * i)
                T[:3, 3] = [0.2 * i, 0.1, 0.05 * i]
                f.write("%d, %.3f, %s\n" % (i, i, ", ".join("%.9f" % x for x in T.ravel())))
        for i in range(5):
            cloud = np.zeros(30 + i, dtype=dt)
            for name in ("x", "y", "z"):
                cloud[name] = rng.uniform(-3, 3, 30 + i)
            np.savez(seq / ("%souster_points" % prefix) / ("%d.npz" % i), cloud=cloud)
        np.savetxt(seq / "poses" / ("%sleica_poses_raw.txt" % prefix), rng.uniform(-1, 1, (5, 3)))
    T = np.eye(4)
    T[:3, :3] = _rot(0.4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    np.savetxt(seq / "calibration" / "map2subt.txt", T)
    np.savez(root / "maps" / "npz" / "map_5cm_alligned.npz",
             cloud=np.zeros(7, dtype=dt))
    return seq


def test_fee_corridor_matches_jax(tmp_path, monkeypatch):
    """Name windows, static and dynamic poses, zero_origin, the Leica xyz
    through map2subt and the map, bit for bit."""
    seq = _write_fee(tmp_path)
    monkeypatch.setattr(j_fee, "data_dir", str(tmp_path))
    monkeypatch.setattr(t_fee, "data_dir", str(tmp_path))
    for name, kw in (("fee_corridor/seq1_start_0_end_3_step_1", {}),
                     ("seq1", {"zero_origin": True}),
                     ("seq1_start_1_end_5_step_2", {"static_poses": False}),
                     ("seq1", {"xyz_from_leica_tracker": True})):
        _same_dataset(j_fee.Dataset(name, **kw), t_fee.Dataset(name, **kw))
    _same_dataset(j_fee.Dataset(path=str(seq)), t_fee.Dataset(path=str(seq)))
    ds = t_fee.Dataset("seq1", zero_origin=True)
    np.testing.assert_allclose(ds.cloud_pose(ds.ids[0]), np.eye(4), atol=1e-12)
    _same_arrays(t_fee.Dataset("seq1").global_cloud(), j_fee.Dataset("seq1").global_cloud())


# ---------------------------------------------------------------- factory

NAMES = ["ground_plane/4", "open_box/n_2_size_6_6_3_height_1_density_40", "plane", "angle",
         "rendered_mesh/room.obj", "scene.obj", "scene.ply", "asl_laser/eth",
         "semantic_kitti/08", "newer_college/01_short_experiment", "kitti360/00",
         "fee_corridor/seq1"]


@pytest.mark.parametrize("name", NAMES)
def test_dataset_by_name_resolves_like_jax(name):
    """Every name the JAX package resolves maps to the port's class of the
    same name in the module of the same name."""
    from depth_correction_tpu.datasets import dataset_by_name as j_by_name
    from depth_correction_tpu_torch.datasets import dataset_by_name as t_by_name

    jcls, tcls = j_by_name(name), t_by_name(name)
    assert tcls.__name__ == jcls.__name__
    assert tcls.__module__.split(".")[1:] == jcls.__module__.split(".")[1:]
    assert tcls.__module__.startswith("depth_correction_tpu_torch.")


def test_unknown_dataset_raises_value_error():
    from depth_correction_tpu.datasets import dataset_by_name as j_by_name
    from depth_correction_tpu_torch.datasets import dataset_by_name as t_by_name

    for by_name in (j_by_name, t_by_name):
        with pytest.raises(ValueError, match="Unknown dataset"):
            by_name("no_such_dataset/x")


def test_loaders_read_the_data_root_variables(tmp_path):
    """Both packages' loaders take their data roots from
    DEPTH_CORRECTION_DATA and KITTI360_DATASET at import."""
    code = ("import sys, json; sys.path.insert(0, %r); out = {}\n"
            "for pkg in ('depth_correction_tpu', 'depth_correction_tpu_torch'):\n"
            "    import importlib\n"
            "    out[pkg] = [importlib.import_module(pkg + '.datasets.' + m).data_dir for m in "
            "('semantic_kitti', 'newer_college', 'kitti360', 'fee_corridor', 'asl_laser')]\n"
            "print(json.dumps(out))" % REPO)
    env = dict(os.environ, DEPTH_CORRECTION_DATA=str(tmp_path / "data"),
               KITTI360_DATASET=str(tmp_path / "k3"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, env=env, timeout=120).stdout
    import json

    dirs = json.loads(out.strip().splitlines()[-1])
    assert dirs["depth_correction_tpu_torch"] == dirs["depth_correction_tpu"]
    assert dirs["depth_correction_tpu_torch"][:3] == [
        os.path.realpath(str(tmp_path / "data" / "semantic_kitti")),
        os.path.realpath(str(tmp_path / "data" / "newer_college")),
        os.path.realpath(str(tmp_path / "k3"))]
