"""The port's analysis modules against the JAX package's, float64 on the CPU.

Range-image projection exactly equal (collisions and the inclusive bottom
edge included), unprojection's mask equal and its points within 1e-14 (the
JAX package's jitted sin and cos, XLA's own, differ from torch's by an ulp
in a few values in a thousand); the marching-tetrahedra reconstruction
(vertices and faces equal); the beam model; the depth-bias fits; map_colors;
the loss-landscape sweep on the cell-window graph (the JAX package's K1 in
interpret mode, the port's plain twin of K1; losses 1e-9); joint_learning's
history and final parameters in pose mode and with the ICP loss (1e-8).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from depth_correction_tpu import depth_bias as jbias
from depth_correction_tpu import reconstruction as jrec
from depth_correction_tpu import sensor as jsensor
from depth_correction_tpu import visualization as jvis
from depth_correction_tpu.cloud import Cloud as JCloud
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu.ops import range_image as jri
from depth_correction_tpu_torch import depth_bias as tbias
from depth_correction_tpu_torch import reconstruction as trec
from depth_correction_tpu_torch import sensor as tsensor
from depth_correction_tpu_torch import visualization as tvis
from depth_correction_tpu_torch.cloud import Cloud as TCloud
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.ops import range_image as tri
from test_torch_pose import SEQS, _cfg, _thinned


@pytest.fixture(scope="module", autouse=True)
def _small_jax_chunks():
    """The JAX brute search pads queries to 8192-row chunks; results do not
    depend on the chunk (tests/test_torch_knn.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "_QUERY_CHUNK", 1024)
        yield


def _lidar_points(seed, h, w, fov=0.3927):
    """A scan on the beam layout linspace(-fov, fov, h) x w azimuths (the
    bottom row at exactly -fov), plus duplicated rays at other ranges
    (collisions), plus points outside the vertical field of view."""
    rng = np.random.default_rng(seed)
    el, az = np.meshgrid(np.linspace(-fov, fov, h), np.linspace(-np.pi, np.pi, w,
                                                                endpoint=False), indexing="ij")
    el, az = el.ravel(), az.ravel() + 1e-3
    r = rng.uniform(1.0, 20.0, el.size)
    dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    pts = np.concatenate([dirs * r[:, None], dirs[::3] * (r[::3, None] * 0.7),
                          [[1.0, 0.0, 5.0], [0.0, 0.0, 0.0]]])
    valid = rng.uniform(size=len(pts)) < 0.95
    return pts, valid


@pytest.mark.parametrize("shape", [(16, 64), (9, 50)])
def test_range_image_matches_jax(shape):
    h, w = shape
    pts, valid = _lidar_points(0, h, w)
    ti, th = tri.project_range_image(torch.as_tensor(pts), torch.as_tensor(valid), h, w)
    ji, jh = jri.project_range_image(jnp.asarray(pts), jnp.asarray(valid), h, w)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert th[-1].any() and th[0].any()  # the bottom edge kept, the top row too
    # Collisions keep the nearest return.
    assert (ti.numpy()[th.numpy()] > 0).all()
    tp, tv = tri.unproject_range_image(ti, th, h, w)
    jp, jv = jri.unproject_range_image(ji, jh, h, w)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-14, atol=1e-14)


def _sphere(n=600, r=1.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v * r, v


def test_reconstruction_matches_jax(tmp_path):
    pts, normals = _sphere()
    for fn, args in (("tsdf_from_cloud", (pts, normals, 0.2)),
                     ("cloud_to_mesh", (pts, normals, 0.2))):
        for t, j in zip(getattr(trec, fn)(*args), getattr(jrec, fn)(*args)):
            np.testing.assert_array_equal(t, j)
    verts, faces = trec.cloud_to_mesh(pts, normals, 0.2)
    assert len(faces) > 100
    trec.save_mesh_obj(str(tmp_path / "t.obj"), verts, faces)
    jrec.save_mesh_obj(str(tmp_path / "j.obj"), verts, faces)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_sensor_matches_jax():
    z = np.linspace(0.0, 30.0, 7)
    for name in ("hokuyo_utm_30lx", "ouster_os0"):
        ts, js = getattr(tsensor.Sensors, name), getattr(jsensor.Sensors, name)
        assert ts.rayleigh_length == js.rayleigh_length
        np.testing.assert_allclose(ts.beam_radius(torch.as_tensor(z)).numpy(),
                                   np.asarray(js.beam_radius(jnp.asarray(z))), rtol=1e-12)
        assert ts.beam_radius(2.0) == pytest.approx(float(js.beam_radius(2.0)), rel=1e-12)
        assert ts.beam_radius(ts.rayleigh_length) == pytest.approx(np.sqrt(2) * ts.beam_exit_radius)


def _bias_clouds(seed=0, n=400):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(0.1, 1.2, n)
    pts = rng.uniform(1, 10, (n, 3))
    normals = np.tile([0.0, 0.0, 1.0], (n, 1))
    mean = pts - normals * (0.01 * inc + 0.001 * rng.normal(size=n))[:, None]
    inc[3] = np.nan  # a degenerate neighbourhood: dropped by the finite filter
    t = TCloud.from_points(pts, dtype=torch.float64).replace(
        normals=torch.as_tensor(normals), mean=torch.as_tensor(mean),
        inc_angles=torch.as_tensor(inc))
    j = JCloud.from_points(pts).replace(normals=jnp.asarray(normals), mean=jnp.asarray(mean),
                                        inc_angles=jnp.asarray(inc))
    return t, j, rng.uniform(size=n) < 0.8


def test_depth_bias_fits_match_jax():
    t, j, mask = _bias_clouds()
    np.testing.assert_allclose(tbias.plane_distances(t).numpy(),
                               np.asarray(jbias.plane_distances(j)), rtol=0, atol=1e-12)
    for kw in ({}, {"mask": mask, "degrees": (1, 2, 3)}):
        tf = tbias.fit_depth_bias(t, **{k: torch.as_tensor(v) if k == "mask" else v
                                        for k, v in kw.items()})
        jf = jbias.fit_depth_bias(j, **kw)
        assert sorted(tf) == sorted(jf)
        for key in jf:
            np.testing.assert_allclose(tf[key], jf[key], rtol=1e-9, atol=1e-12)
    assert tbias.fit_depth_bias(t)["dist_vs_angle_deg1"][1] == pytest.approx(0.01, abs=1e-3)


def test_map_colors_and_plots_match_jax(tmp_path):
    """map_colors with the default colormap, two anchors and a table;
    the plots draw from tensors."""
    v = np.random.default_rng(1).normal(size=50)
    for kw in ({}, {"colormap": [[0, 0, 0], [1, 1, 1]]},
               {"colormap": np.eye(3), "min_value": -1.0, "max_value": 1.0}):
        np.testing.assert_array_equal(tvis.map_colors(torch.as_tensor(v), **kw),
                                      jvis.map_colors(v, **kw))
    t, _, _ = _bias_clouds()
    path = str(tmp_path / "poses.png")
    tvis.plot_cloud_poses(t.replace(points=t.get_points()), poses=torch.eye(4)[None],
                          path=path)
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    assert tvis.plot_model_curve(_model(TConfig)).get_xlabel() == "Incidence Angle [deg]"
    assert tbias.plot_depth_bias([t], TConfig(), model=_model(TConfig),
                                 out_dir=str(tmp_path / "b"))
    assert tvis.visualize_incidence_angles([t])


def _model(cls):
    from depth_correction_tpu.models import load_model as jload
    from depth_correction_tpu_torch.models import load_model as tload

    cfg = cls()
    cfg.float_type, cfg.device = "float64", "cpu"
    cfg.model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    return (tload if cls is TConfig else jload)(cfg=cfg)


WEIGHTS = np.linspace(-0.004, 0.002, 5)


def test_sweep_weight_matches_jax():
    """sweep_weight on the cell-window graph of SEQS[0]: the same grid and
    losses (1e-9), which the weight moves."""
    from depth_correction_tpu.loss_landscape import sweep_weight as j_sweep
    from depth_correction_tpu.train import prepare_sequences as j_prep
    from depth_correction_tpu_torch.loss_landscape import sweep_weight as t_sweep
    from depth_correction_tpu_torch.train import prepare_sequences as t_prep

    jcfg, tcfg = _cfg(JConfig, train_names=SEQS[:1]), _cfg(TConfig, train_names=SEQS[:1])
    seqs = [_thinned(SEQS[0], tcfg)]
    jdata, tdata = j_prep(seqs, jcfg), t_prep(seqs, tcfg)
    assert tdata.cellwin[0] is not None and jdata.cellwin[0] is not None
    tw, tl = t_sweep(tcfg, tdata, WEIGHTS)
    jw, jl = j_sweep(jcfg, jdata, WEIGHTS)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_allclose(tl, jl, rtol=1e-9, atol=0)
    assert len(np.unique(tl)) == len(tl)


def _joint_cfg(cls, loss, **kw):
    cfg = _cfg(cls, train_names=SEQS[:1], moments_backend="gather", nn_max_neighbors=16,
               loss=loss, n_opt_iters=3, pose_correction="pose", **kw)
    if loss == "icp_loss":
        cfg.loss_kwargs = {"icp_point_to_plane": True, "icp_inlier_ratio": 0.5}
    return cfg


@pytest.mark.parametrize("loss", ["min_eigval_loss", "icp_loss"])
def test_joint_learning_matches_jax(loss):
    """Three Adam steps in pose mode on SEQS[0] with a ground-truth map and
    positions, metrics every 2 iterations: the history rows (1e-8) and the
    final model and pose deltas (1e-8); the first pose stays fixed."""
    from depth_correction_tpu.experiments import joint_learning as j_joint
    from depth_correction_tpu.experiments import synthetic_gt_map as j_gt_map
    from depth_correction_tpu.experiments import synthetic_gt_positions as j_gt_pos
    from depth_correction_tpu_torch.experiments import joint_learning as t_joint
    from depth_correction_tpu_torch.experiments import synthetic_gt_map as t_gt_map
    from depth_correction_tpu_torch.experiments import synthetic_gt_positions as t_gt_pos

    jcfg, tcfg = _joint_cfg(JConfig, loss), _joint_cfg(TConfig, loss)
    seqs = [_thinned(SEQS[0], tcfg)]
    gt_map = t_gt_map(SEQS[0], tcfg, density_mult=1.0)
    np.testing.assert_array_equal(gt_map, j_gt_map(SEQS[0], jcfg, density_mult=1.0))
    gt_xyz = t_gt_pos(SEQS[0], tcfg)
    np.testing.assert_array_equal(gt_xyz, j_gt_pos(SEQS[0], jcfg))
    kw = dict(gt_map=gt_map, gt_positions=gt_xyz + 0.01, metrics_every=2)
    th = t_joint(tcfg, datasets=seqs, **kw)
    jh = j_joint(jcfg, datasets=seqs, **kw)
    assert th.iters == jh.iters == [0, 2]
    for f in ("train_loss", "pose_l2", "map_accuracy"):
        np.testing.assert_allclose(getattr(th, f), getattr(jh, f), rtol=1e-8, atol=0)
    assert np.isfinite(th.map_accuracy).all()
    np.testing.assert_allclose(th.params["model"].w.detach().numpy(),
                               np.asarray(jh.params["model"].w), rtol=1e-8, atol=1e-14)
    td, jd = th.params["pose_deltas"], jh.params["pose_deltas"]
    assert len(td) == len(jd) == 1
    np.testing.assert_allclose(td[0].detach().numpy(), np.asarray(jd[0]), rtol=0, atol=1e-10)
    assert not td[0][0].any() and td[0][1:].abs().max() > 0
