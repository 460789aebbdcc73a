"""The reference's default configuration in the port, against the JAX
package on the same inputs (float64, CPU).

A default ``Config()`` that sets only ``log_dir``, ``train_names``,
``n_opt_iters``, ``float_type`` and the data directory reads ASL-laser CSV
files that the tests write (a floor patch and a wall seen from four
viewpoints 6-8 m away, 5 mm of seeded noise), filters them, masks the
global cloud by the viewpoint dispersion (``vp_dispersion_bounds = [0.36,
inf]``), and trains. Also here: the dispersion statistics and their
masks and the shadow filter, each against its JAX counterpart. Bars
(ROADMAP §3.6): loss and gradient rtol 1e-9, optimizer trajectories 1e-8.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import depth_correction_tpu.datasets.asl_laser as j_asl
import depth_correction_tpu_torch.datasets.asl_laser as t_asl
from depth_correction_tpu import models as jmodels
from depth_correction_tpu.cloud import Cloud as JCloud
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.ops import features as jfeat
from depth_correction_tpu.ops import filters as jfilt
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu.preproc import establish_neighborhoods as j_est
from depth_correction_tpu.preproc import global_cloud as j_global
from depth_correction_tpu.preproc import local_feature_cloud as j_local_feature_cloud
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu_torch.cloud import Cloud as TCloud
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.ops import features as tfeat
from depth_correction_tpu_torch.ops import filters as tfilt
from depth_correction_tpu_torch.ops import knn as tknn
from depth_correction_tpu_torch.preproc import establish_neighborhoods as t_est
from depth_correction_tpu_torch.preproc import global_cloud as t_global
from depth_correction_tpu_torch.preproc import local_feature_cloud as t_local_feature_cloud
from depth_correction_tpu_torch.train import TrainCallbacks
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences
from depth_correction_tpu_torch.train import train as t_train

SEQ, SEQ8 = "mini_box", "mini_box8"
SENSORS = ((-6.0, -4.0, 1.5, 0.6), (6.5, -3.5, 1.4, 2.5), (0.5, -7.5, 1.6, 1.6),
           (-3.5, -6.5, 1.5, 1.0))  # x, y, z, yaw
SENSORS8 = SENSORS + ((4.0, -6.0, 1.7, 2.1), (-7.0, -1.0, 1.3, 0.1), (7.0, 0.5, 1.5, 3.0),
                      (2.5, -6.8, 1.4, 1.9))


def _pose(x, y, z, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = [x, y, z]
    return T


def _surfaces(rng, density=40.0):
    """A 3 x 3 m floor patch (z = 0) and a 3 x 2 m wall (y = 1.5), sampled
    at ``density`` points per m^2, with 5 mm of noise."""
    n_floor, n_wall = int(9 * density), int(6 * density)
    floor = np.c_[rng.uniform(-1.5, 1.5, (n_floor, 2)), np.zeros(n_floor)]
    wall = np.c_[rng.uniform(-1.5, 1.5, n_wall), np.full(n_wall, 1.5),
                 rng.uniform(0.0, 2.0, n_wall)]
    pts = np.vstack([floor, wall])
    return pts + 0.005 * rng.standard_normal(pts.shape)


def _thin(local, res=0.2, r=0.25, min_count=4):
    """One point per ``res`` voxel of the sensor frame (so the default voxel
    filter keeps every point), then only points with at least
    ``min_count`` points within ``r`` (repeated until none is left short).
    Fewer points are exactly coplanar (three) or collinear, and the sign
    of their smallest eigenvalue, which the default planarity bound reads,
    is rounding."""
    from scipy.spatial import cKDTree

    _, first = np.unique(np.floor(local / res).astype(np.int64), axis=0, return_index=True)
    local = local[np.sort(first)]
    while True:
        counts = np.array([len(b) for b in cKDTree(local).query_ball_point(local, r)])
        if counts.min() >= min_count:
            return local
        local = local[counts >= min_count]


def write_asl_scene(root, name=SEQ, sensors=SENSORS, seed=0):
    """ASL-laser files of the scene: csv_local/Hokuyo_<i>.csv (points in the
    sensor frame, thinned by :func:`_thin`) and
    csv_global/pose_scanner_leica.csv. Returns the poses and the local
    points of each scan."""
    seq = root / name
    (seq / "csv_local").mkdir(parents=True)
    (seq / "csv_global").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    poses, scans = [], []
    for i, sensor in enumerate(sensors):
        T = _pose(*sensor)
        local = _thin((_surfaces(rng) - T[:3, 3]) @ T[:3, :3])
        with open(seq / "csv_local" / ("Hokuyo_%d.csv" % i), "w") as f:
            f.write("timestamp, x, y, z, intensity\n")
            for p in local:
                f.write("%.3f, %.9f, %.9f, %.9f, 1.0\n" % (i, *p))
        poses.append(T)
        scans.append(local)
    t_asl.write_poses(range(len(sensors)), poses, str(seq / "csv_global" /
                                                      "pose_scanner_leica.csv"))
    return poses, scans


@pytest.fixture(autouse=True)
def _small_query_chunks(monkeypatch):
    """The JAX package's brute search pads queries to chunks of 8192 rows,
    a memory bound that does not change its results; at these sizes its
    top_k over the padding would take most of this file's time."""
    monkeypatch.setattr(jknn, "_QUERY_CHUNK", 1024)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("asl_laser")
    write_asl_scene(root)
    write_asl_scene(root, SEQ8, SENSORS8, seed=1)
    return root


@pytest.fixture
def asl_root(data_root, monkeypatch):
    """Both packages read ASL data from the files written here (their
    ``data_dir`` is read from DEPTH_CORRECTION_DATA at import)."""
    monkeypatch.setattr(j_asl, "data_dir", str(data_root))
    monkeypatch.setattr(t_asl, "data_dir", str(data_root))
    return data_root


def test_asl_loader_matches_jax(asl_root):
    tds, jds = t_asl.Dataset("asl_laser/" + SEQ), j_asl.Dataset("asl_laser/" + SEQ)
    assert tds.ids == jds.ids == list(range(len(SENSORS)))
    for (tc, tp), (jc, jp) in zip(tds, jds):
        assert tc.dtype.names == jc.dtype.names == ("x", "y", "z")
        for f in "xyz":
            np.testing.assert_array_equal(tc[f], jc[f])
        np.testing.assert_array_equal(tp, jp)
    for i, sensor in enumerate(SENSORS):
        np.testing.assert_allclose(tds.cloud_pose(i), _pose(*sensor), atol=1e-9)
    assert len(t_asl.Dataset(SEQ + "_step_2")) == 2
    assert len(tds[1:]) == 3 and str(tds) == "asl_laser/" + SEQ


def _default_cfg(cls, log_dir, **extra):
    cfg = cls()
    cfg.log_dir = str(log_dir)
    cfg.train_names = ["asl_laser/" + SEQ]
    cfg.n_opt_iters = 3
    cfg.float_type = "float64"
    for k, v in extra.items():
        setattr(cfg, k, v)
    return cfg


def _prepare(asl_root, tmp_path, **extra):
    jcfg = _default_cfg(JConfig, tmp_path / "jax", **extra)
    tcfg = _default_cfg(TConfig, tmp_path / "port", **extra)
    jdata, tdata = prepare_both(jcfg, tcfg)
    return jcfg, jdata, tcfg, tdata


def prepare_both(jcfg, tcfg):
    """Both packages' TrainData of ``train_names[0]`` (the port on the CPU)."""
    tcfg.device = "cpu"
    jdata = j_prepare_sequences([j_create_dataset(jcfg.train_names[0], jcfg)], jcfg)
    tdata = t_prepare_sequences([t_create_dataset(tcfg.train_names[0], tcfg)], tcfg)
    return jdata, tdata


def _jax_trajectory(jcfg, jdata, params, tx, steps=3, mask=None):
    """(loss, grads, params after the step) of ``steps`` optimizer steps, as
    the JAX package's train() runs them (gradients times ``mask``)."""
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg)))
    state = tx.init(params)
    out = []
    for _ in range(steps):
        value, g = grad_fn(params, jdata)
        if mask is not None:
            g = jax.tree_util.tree_map(lambda a, m: a * m, g, mask)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        out.append((float(value), g["model"], params["model"]))
    return out


class _Record(TrainCallbacks):
    def __init__(self, cfg, names):
        super().__init__(cfg)
        self.names, self.grads = names, []

    def train_loss(self, it, model, pose_deltas, loss):
        self.grads.append({n: getattr(model, n).grad.detach().clone() for n in self.names})


def _leaves(m, names):
    return {n: np.asarray(getattr(m, n), np.float64) for n in names}


def _assert_trajectory(history, rec, model, traj, names):
    np.testing.assert_allclose([h[1] for h in history], [t[0] for t in traj], rtol=1e-9)
    for got, (_, g, _) in zip(rec.grads, traj):
        for n in names:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(getattr(g, n)), rtol=1e-9,
                                       atol=1e-300)
    for n, want in _leaves(traj[-1][2], names).items():
        np.testing.assert_allclose(getattr(model, n).detach().numpy(), want, rtol=1e-8)


def test_default_config_trains_like_jax(asl_root, tmp_path):
    """Config() with only the five settings: the prepared tables and masks
    equal the JAX package's, and three Adam steps of the default
    ScaledPolynomial follow its trajectory."""
    jcfg, jdata, tcfg, tdata = _prepare(asl_root, tmp_path)
    assert TConfig().vp_dispersion_bounds == [0.36, float("inf")]
    np.testing.assert_array_equal(tdata.masks[0].numpy(), np.asarray(jdata.masks[0]))
    np.testing.assert_array_equal(tdata.neighbors[0].numpy(), np.asarray(jdata.neighbors[0]))
    np.testing.assert_array_equal(tdata.query_rows[0].numpy(), np.asarray(jdata.query_rows[0]))
    rows = int(tdata.masks[0].sum())
    assert rows > 50  # the dispersion mask keeps the overlap, not everything
    assert rows < int(tdata.batches[0].cloud.valid.sum())
    params = {"model": jmodels.load_model(cfg=jcfg)}
    traj = _jax_trajectory(jcfg, jdata, params, optax.adam(jcfg.lr))
    rec = _Record(tcfg, ["w"])
    model, history = t_fit(tcfg, tdata, callbacks=rec)
    assert str(model).startswith("ScaledPolynomial") and model.w.numel() == 2
    _assert_trajectory(history, rec, model, traj, ["w"])
    # train() reads the ASL files itself, too, and logs the same losses.
    again = _default_cfg(TConfig, tmp_path / "again", device="cpu")
    assert t_train(again) is not None
    logged = np.loadtxt(os.path.join(again.log_dir, "train_history.csv"), skiprows=1, ndmin=2)
    assert logged[:, 1].tolist() == [float("%.9g" % h[1]) for h in history]


def test_dispersion_statistics_and_masks_match_jax(asl_root, tmp_path):
    """vp_dispersion, dir_dispersion, mean_depth and mean_vp_dist of the
    default global cloud and graph to rtol 1e-9, and each bound's mask
    equal."""
    jcfg, jdata, tcfg, tdata = _prepare(asl_root, tmp_path)
    
    jg, tg = j_global(jdata.batches[0]), t_global(tdata.batches[0])
    jn, jw = j_est(jg, jcfg)
    tn, tw = t_est(tg, tcfg)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    stats = {}
    for name in ("vp_dispersion", "dir_dispersion", "mean_depth", "mean_vp_dist"):
        want = np.asarray(getattr(jfeat, name)(jg, jn, jw))
        got = getattr(tfeat, name)(tg, tn, tw).numpy()
        ok = np.asarray(jg.valid) & (np.asarray(jw).sum(1) > 1)
        # atol: the statistics of a neighbourhood seen from one viewpoint are
        # rounding residues (up to ~1e-15 m), whose relative error means
        # nothing.
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-9, atol=1e-12)
        assert want[ok].max() > 0.1
        stats[name] = want[ok]
    # Each bound at its statistic's median over the rows, so it splits them.
    bounds = {
        "vp_dispersion_bounds": [0.36, float("inf")],
        "dir_dispersion_bounds": [float(np.median(stats["dir_dispersion"])), float("inf")],
        "vp_dispersion_to_depth2_bounds":
            [0.0, float(np.median(stats["vp_dispersion"] / stats["mean_depth"] ** 2))],
        "vp_dist_to_depth_bounds":
            [float(np.median(stats["mean_vp_dist"] / stats["mean_depth"])), float("inf")],
    }
    for name, b in bounds.items():
        jc, tc = JConfig(), TConfig()
        for c in (jc, tc):
            c.min_valid_neighbors, c.eigenvalue_ratio_bounds = 0, []
            c.vp_dispersion_bounds = []
            setattr(c, name, b)
        want = np.asarray(jfilt.global_cloud_mask(jg, jn, jw, jc))
        got = tfilt.global_cloud_mask(tg, tn, tw, tc).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < np.asarray(jg.valid).sum(), name


def _step_scene(n=1500, seed=3):
    """A floor seen from 1.2 m above with a box standing on it: the box's
    top edge makes a depth discontinuity seen edge-on (shadow points)."""
    rng = np.random.default_rng(seed)
    floor = np.c_[rng.uniform(0.5, 4.0, n), rng.uniform(-1.5, 1.5, n), np.zeros(n)]
    box = np.c_[np.full(n // 2, 2.0), rng.uniform(-0.8, 0.8, n // 2),
                rng.uniform(0.0, 0.6, n // 2)]
    top = np.c_[rng.uniform(2.0, 2.6, n // 2), rng.uniform(-0.8, 0.8, n // 2),
                np.full(n // 2, 0.6)]
    pts = np.vstack([floor, box, top]) + 0.003 * rng.standard_normal((2 * n, 3))
    return pts, np.tile([0.0, 0.0, 1.2], (len(pts), 1))


def test_shadow_filter_matches_jax():
    """The direction-space radius graph (the brute search on view
    directions), the shadow mask and the kept feature cloud equal the JAX
    package's."""
    pts, vps = _step_scene()
    r_dir = tfilt.ball_angle_to_distance(np.radians(2.0))
    np.testing.assert_allclose(r_dir, float(jfilt.ball_angle_to_distance(np.radians(2.0))),
                               rtol=1e-15)
    jc = JCloud.from_points(jnp.asarray(pts), vps=jnp.asarray(vps))
    tc = TCloud.from_points(torch.as_tensor(pts), vps=torch.as_tensor(vps))
    k = tknn.suggest_k_max(tc.dirs, r=r_dir, valid_points=tc.valid)
    assert k == jknn.suggest_k_max(jc.dirs, r=r_dir, valid_points=jc.valid)
    _, jn = jknn.radius_neighbors(jc.dirs, r=r_dir, k=k, valid_points=jc.valid)
    _, tn = tknn.radius_neighbors(tc.dirs, r=r_dir, k=k, valid_points=tc.valid)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    bounds = [0.35, 2.8]
    want = np.asarray(jfilt.filter_shadow_mask(jc, jn, (jn >= 0).astype(jnp.float64), bounds))
    got = tfilt.filter_shadow_mask(tc, tn, (tn >= 0).double(), bounds).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.02 * len(pts) < (~want).sum() < 0.98 * len(pts)  # both sides exercised

    def cfg(cls):
        c = cls()
        c.float_type, c.shadow_angle_bounds = "float64", bounds
        c.shadow_neighborhood_angle = np.radians(2.0)
        c.min_depth, c.max_depth, c.grid_res = 0.0, 50.0, 0.0
        return c

    tcfg = cfg(TConfig)
    tcfg.device = "cpu"
    jf = j_local_feature_cloud((pts, vps, None), cfg(JConfig))
    tf = t_local_feature_cloud((pts, vps, None), tcfg)
    assert tf.size == jf.size
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))
    np.testing.assert_allclose(tf.get_points().numpy(), np.asarray(jf.get_points()), rtol=0,
                               atol=1e-12)


def test_default_cellwin_build_like_jax(asl_root, tmp_path, monkeypatch, capsys):
    """The default Config()'s graph, as prep hands it to the cell-window
    builder (the uncapped within-r graph on the card): the port's builder
    declines, or builds, where the JAX builder does, with the same note."""
    from depth_correction_tpu.ops import cellwin as jcw
    from depth_correction_tpu_torch.ops import cellwin as tcw

    _, _, tcfg, tdata = _prepare(asl_root, tmp_path)
    pts = t_global(tdata.batches[0]).get_points().numpy()
    valid = tdata.batches[0].cloud.valid.reshape(-1).numpy()
    qrows, nn = tdata.query_rows[0].numpy(), tdata.neighbors[0].numpy()
    kw = dict(row_cap=int(tcfg.cellwin_row_cap), pt_cap=int(tcfg.cellwin_pt_cap),
              span_limit=512, z_max=tcfg.cellwin_z_max)
    monkeypatch.setenv("DC_CELLWIN_DEBUG", "1")
    capsys.readouterr()
    gj = jcw.build_cellwin_graph(pts, valid, qrows, nn, float(tcfg.nn_r), **kw)
    jnote = [line for line in capsys.readouterr().err.splitlines()
             if line.startswith("[cellwin] ")]
    gt = tcw.build_cellwin_graph(pts, valid, qrows, nn, float(tcfg.nn_r), **kw)
    assert (gj is None) == (gt is None)
    assert jnote == ([] if gt is not None else ["[cellwin] %s" % tcw.LAST_NOTE])
