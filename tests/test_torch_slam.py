"""The port's SLAM evaluation and metrics against the JAX package's,
float64 on the CPU.

se3's rotation_angle, translation_norm and absolute_orientation (1e-12);
the metrics (1e-9); the plain 1-NN search's running minimum against the
sorted top-k at ties; icp_align at 0 and 3 iterations (T and err 1e-9);
perturb_odometry (1e-12); slam_odometry and slam_mapper trajectories (1e-8),
the mapper at capacity with its eviction warning; eval_slam and
eval_slam_all (CSV rows parsed, 1e-8; the per-sequence poses files); the
corrected-cloud export (1e-9); the external-mapper route through scripts/stub_slam_mapper.py;
train_and_eval with the default eval_slams. The scenes: small open boxes of
two to four scans with 5 mm of seeded depth noise, so no correspondence is
an exact tie. Each package's eval_slam runs once, in a module fixture; the
port's eval_slam_all is held against the JAX package's eval_slam row of
the same sequence and pipeline, the evaluation it runs.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from depth_correction_tpu import metrics as jmetrics
from depth_correction_tpu import slam_eval as jslam
from depth_correction_tpu.cloud import Cloud as JCloud
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu.ops import se3 as jse3
from depth_correction_tpu_torch import metrics as tmetrics
from depth_correction_tpu_torch import slam_eval as tslam
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.ops import knn as tknn
from depth_correction_tpu_torch.ops import se3 as tse3
from depth_correction_tpu_torch.preproc import local_feature_cloud as t_local_feature_cloud

# ~860 points a scan: the JAX package's brute 1-NN takes ~0.4 s a call on
# the CPU at this size, ~3 s at 2,500 points.
SCENE = "open_box/n_4_size_6_6_3_height_1_density_50"
SEQ_A = "open_box/n_3_size_6_6_3_height_1_density_50"
SEQ_B = "open_box/n_2_size_6_6_3_height_1_density_60"
STUB = os.path.join(os.path.dirname(__file__), "..", "scripts", "stub_slam_mapper.py")
ODOM_COV = [1e-5, 1e-5, 1e-5, 4e-3, 4e-3, 4e-3]


@pytest.fixture(scope="module", autouse=True)
def _small_jax_chunks():
    """The JAX brute search pads queries to 8192-row chunks; results do not
    depend on the chunk (tests/test_torch_knn.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "_QUERY_CHUNK", 1024)
        yield


def _cfg(cls, **kw):
    """tests/test_slam_eval.py's box configuration, float64 on the CPU, 5 mm
    of depth noise, a model that corrects. No injected bias: the noise is
    seeded by the bytes of the depths it perturbs, and a biased depth's
    last bit differs between the packages."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 30.0, 0.3
    cfg.nn_r, cfg.nn_k = 0.6, 0
    cfg.nn_backend = "scipy"
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.depth_noise = 0.005
    cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.odom_cov = list(ODOM_COV)
    cfg.eval_slams = []
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _jcloud(c):
    """A port Cloud as the JAX package's, field for field."""
    import dataclasses

    return JCloud(**{f.name: None if getattr(c, f.name) is None
                     else jnp.asarray(getattr(c, f.name).numpy())
                     for f in dataclasses.fields(c)})


@pytest.fixture(scope="module")
def scene():
    """The scene's feature clouds (port, and the same values as JAX
    clouds), ground-truth poses and a perturbed odometry chain."""
    cfg = _cfg(TConfig)
    clouds, poses = [], []
    for scan, pose in t_create_dataset(SCENE, cfg):
        clouds.append(t_local_feature_cloud(scan, cfg))
        poses.append(np.asarray(pose))
    poses = np.stack(poses)
    odom = tslam.perturb_odometry(poses, ODOM_COV, seed=3)
    return {"clouds": clouds, "jclouds": [_jcloud(c) for c in clouds], "poses": poses,
            "odom": odom}


def _rotations(seed, n):
    from scipy.spatial.transform import Rotation

    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.random(n, random_state=seed).as_matrix()
    T[:, :3, 3] = np.random.default_rng(seed).normal(size=(n, 3))
    return T


@pytest.mark.parametrize("fn", ["rotation_angle", "translation_norm"])
def test_se3_angle_and_norm_match_jax(fn):
    T = _rotations(0, 16)
    T[0, :3, :3] = np.eye(3)  # the clip at cos = 1
    np.testing.assert_allclose(getattr(tse3, fn)(torch.as_tensor(T)).numpy(),
                               np.asarray(getattr(jse3, fn)(jnp.asarray(T))), rtol=0, atol=1e-12)


@pytest.mark.parametrize("flip", [False, True], ids=["proper", "reflection"])
def test_absolute_orientation_matches_jax(flip):
    """Kabsch on noisy points; a mirrored target takes the det-sign flip."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 40))
    T = _rotations(2, 1)[0]
    y = T[:3, :3] @ x + T[:3, 3:] + 0.01 * rng.normal(size=(3, 40))
    if flip:
        y[2] = -y[2]
    t = tse3.absolute_orientation(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(t, np.asarray(jse3.absolute_orientation(jnp.asarray(x),
                                                                       jnp.asarray(y))),
                               rtol=0, atol=1e-12)
    assert np.linalg.det(t[:3, :3]) == pytest.approx(1.0)


def _metric_inputs():
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(300, 3)), rng.normal(size=(350, 3))
    vx, vy = rng.uniform(size=300) < 0.9, rng.uniform(size=350) < 0.8
    return x, y, vx, vy


@pytest.mark.parametrize("case", ["chamfer", "chamfer_valid", "chamfer_bidirectional",
                                  "mapping_accuracy", "mapping_accuracy_valid"])
def test_cloud_metrics_match_jax(case):
    x, y, vx, vy = _metric_inputs()
    kw = {} if "valid" not in case else None
    if case.startswith("chamfer"):
        fn, args = "chamfer_distance", (x, y)
        kw = ({"valid_x": vx, "valid_y": vy} if kw is None
              else {"bidirectional": case.endswith("bidirectional")})
    else:
        fn, args = "mapping_accuracy", (x, y)
        kw = {"valid_cloud": vx, "valid_gt": vy, "icp_inlier_ratio": 0.7} if kw is None else {}
    t = getattr(tmetrics, fn)(*map(torch.as_tensor, args),
                              **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                                 for k, v in kw.items()})
    j = getattr(jmetrics, fn)(*map(jnp.asarray, args),
                              **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                 for k, v in kw.items()})
    np.testing.assert_allclose(float(t), float(j), rtol=1e-9, atol=0)


def test_pose_metrics_match_jax():
    """localization_errors, tracker_position_error and static_intervals."""
    gt, est = _rotations(5, 8), _rotations(6, 8)
    for t, j in zip(tmetrics.localization_errors(torch.as_tensor(gt), torch.as_tensor(est)),
                    jmetrics.localization_errors(jnp.asarray(gt), jnp.asarray(est))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9, atol=1e-12)
    xyz = gt[:, :3, 3] + 0.1
    np.testing.assert_allclose(float(tmetrics.tracker_position_error(torch.as_tensor(est), xyz)),
                               float(jmetrics.tracker_position_error(jnp.asarray(est), xyz)),
                               rtol=1e-9)
    times = np.arange(40) * 0.25
    pos = np.repeat(np.arange(4.0), 10)[:, None] * np.ones(3) + \
        np.random.default_rng(7).normal(scale=1e-3, size=(40, 3))
    assert tmetrics.static_intervals(times, pos) == jmetrics.static_intervals(times, pos)
    assert len(tmetrics.static_intervals(times, pos)) == 4


def test_nearest_plain_running_min_keeps_tie_order():
    """The plain 1-NN (a running minimum) gives the sorted top-k's first
    column on a lattice full of exact ties, across tiles, and the JAX
    package's search."""
    g = np.stack(np.meshgrid(*[np.arange(12.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([g, g])  # every point twice: ties across tiles
    q = g[::5] + 0.5
    valid = np.ones(len(pts), bool)
    valid[::5] = False
    tp, tq, tv = torch.as_tensor(pts), torch.as_tensor(q), torch.as_tensor(valid)
    d1, i1 = tknn._knn_tiled(tp, tq, tv, torch.tensor(float("inf"), dtype=torch.float64), 1)
    d2, i2 = tknn._knn_tiled(tp, tq, tv, torch.tensor(float("inf"), dtype=torch.float64), 2)
    assert torch.equal(i1, i2[:, :1]) and torch.equal(d1, d2[:, :1])
    jd, ji = jknn.nearest_neighbors(jnp.asarray(pts), jnp.asarray(q), k=1,
                                    valid_points=jnp.asarray(valid))
    td, ti = tknn.nearest_neighbors(tp, tq, k=1, valid_points=tv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("n_iters", [0, 3])
def test_icp_align_matches_jax(scene, n_iters):
    """Scan 1 registered on scan 0 posed at ground truth, from the noisy
    prior: T and the last iteration's error, 1e-9 (inf at 0 iterations)."""
    c, jc, poses, odom = scene["clouds"], scene["jclouds"], scene["poses"], scene["odom"]
    T = torch.as_tensor(poses[0])
    target = c[0].transform(T).with_points()
    jtarget = jc[0].transform(jnp.asarray(poses[0])).with_points()
    tT, terr = tslam.icp_align(c[1], target, T0=odom[1], n_iters=n_iters, inlier_ratio=0.8)
    jT, jerr = jslam.icp_align(jc[1], jtarget, T0=odom[1], n_iters=n_iters, inlier_ratio=0.8)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-9)
    if n_iters == 0:
        assert np.isinf(float(terr)) and np.isinf(float(jerr))
        np.testing.assert_array_equal(tT.numpy(), odom[1])
    else:
        np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-9)
        assert not np.allclose(tT.numpy(), odom[1])


def test_perturb_odometry_matches_jax(scene):
    poses = scene["poses"]
    for cov, seed in ((ODOM_COV, 3), ([0.0] * 6, 1), ([1e-4] * 6, 135)):
        np.testing.assert_allclose(tslam.perturb_odometry(poses, cov, seed=seed),
                                   jslam.perturb_odometry(poses, cov, seed=seed),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("pipeline", ["slam_odometry", "slam_mapper"])
def test_slam_trajectories_match_jax(scene, pipeline):
    """Two ICP iterations a scan: the trajectories within 1e-8, and the
    mapper pulls the noisy odometry back toward ground truth."""
    kw = {"n_iters": 2}
    if pipeline == "slam_mapper":
        kw["map_voxel"] = 0.3
    t = getattr(tslam, pipeline)(scene["clouds"], scene["odom"], **kw)
    j = getattr(jslam, pipeline)(scene["jclouds"], scene["odom"], **kw)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-8)
    if pipeline == "slam_mapper":
        gt = torch.as_tensor(scene["poses"])
        est_t = tmetrics.localization_errors(gt, torch.as_tensor(t))[1].mean()
        odom_t = tmetrics.localization_errors(gt, torch.as_tensor(scene["odom"]))[1].mean()
        assert est_t < 0.6 * odom_t


def test_slam_mapper_at_capacity_matches_jax(scene):
    """A map capacity below one scan's voxels: both packages warn at every
    merge past it and keep the same voxels (trajectories within 1e-8)."""
    clouds, jclouds, odom = scene["clouds"][:3], scene["jclouds"][:3], scene["odom"][:3]
    cap = 600
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = tslam.slam_mapper(clouds, odom, n_iters=2, map_voxel=0.3, map_capacity=cap)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jslam.slam_mapper(jclouds, odom, n_iters=2, map_voxel=0.3, map_capacity=cap)
    msgs = [str(w.message) for w in tw if "at capacity" in str(w.message)]
    assert len(msgs) == 3 and msgs == [str(w.message) for w in jw
                                       if "at capacity" in str(w.message)]
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-8)


def _slam_rows(path):
    with open(path) as f:
        rows = [line.split() for line in f]
    assert rows and all(len(r) == 5 for r in rows)
    return [(r[0], [float(x) for x in r[1:]]) for r in rows]


def _same_slam_csvs(jpath, tpath):
    j, t = _slam_rows(jpath), _slam_rows(tpath)
    assert [r[0] for r in t] == [r[0] for r in j]
    np.testing.assert_allclose([r[1] for r in t], [r[1] for r in j], rtol=0, atol=1e-8)
    return t


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """Each package's eval_slam with the model's correction (features
    computed again on the corrected clouds), icp_mapper over two test
    sequences with both CSVs set; then the port's eval_slam_all with
    icp_mapper on a train subset of the second sequence, the same
    evaluation as the JAX package's second row."""
    from depth_correction_tpu.config import slam_eval_csv, slam_poses_csv
    from depth_correction_tpu_torch.eval import eval_slam_all as t_eval_slam_all

    out = {}
    for cls, mod, tag in ((JConfig, jslam, "jax"), (TConfig, tslam, "port")):
        root = str(tmp_path_factory.mktemp(tag))
        cfg = _cfg(cls, test_names=[SEQ_A, SEQ_B], slam="icp_mapper",
                   log_dir=os.path.join(root, "single"))
        cfg.slam_eval_csv = slam_eval_csv(cfg.log_dir, cfg.slam)
        cfg.slam_poses_csv = slam_poses_csv(cfg.log_dir, "", cfg.slam)
        out[tag] = {"cfg": cfg, "res": mod.eval_slam(cfg)}
    all_cfg = _cfg(TConfig, train_names=[SEQ_B], eval_slams=["icp_mapper"],
                   log_dir=str(tmp_path_factory.mktemp("port_all")))
    out["port"].update({"all_cfg": all_cfg, "all": t_eval_slam_all(all_cfg)})
    return out


def test_eval_slam_matches_jax(evals):
    """The results and the slam_eval CSV rows, 1e-8, one a sequence."""
    j, t = evals["jax"], evals["port"]
    assert list(t["res"]) == list(j["res"]) == [SEQ_A, SEQ_B]
    for name in (SEQ_A, SEQ_B):
        np.testing.assert_allclose(t["res"][name], j["res"][name], rtol=0, atol=1e-8)
    rows = _same_slam_csvs(j["cfg"].slam_eval_csv, t["cfg"].slam_eval_csv)
    assert [r[0] for r in rows] == [SEQ_A, SEQ_B]


def test_eval_slam_sequence_poses_match_jax(evals):
    """With two test sequences each gets its own poses file, nested by name
    as slam_poses_csv(log_dir, name, slam) nests it; the poses 1e-8."""
    from depth_correction_tpu.datasets.asl_laser import read_poses

    head, base = {}, {}
    for tag in ("jax", "port"):
        head[tag], base[tag] = os.path.split(evals[tag]["cfg"].slam_poses_csv)
        assert not os.path.exists(evals[tag]["cfg"].slam_poses_csv)
    for name, n in ((SEQ_A, 3), (SEQ_B, 2)):
        jids, jposes = read_poses(os.path.join(head["jax"], name, base["jax"]))
        tids, tposes = read_poses(os.path.join(head["port"], name, base["port"]))
        assert tids == jids == list(range(n))
        np.testing.assert_allclose(tposes, jposes, rtol=0, atol=1e-8)


def test_eval_slam_all_matches_jax(evals):
    """eval_slam_all writes slam_eval_<slam>_<subset>.csv alone, its row the
    JAX package's eval_slam row of the same sequence and pipeline (1e-8)."""
    t = evals["port"]
    assert list(t["all"]) == [("train", "icp_mapper")]
    name = "slam_eval_icp_mapper_train.csv"
    assert sorted(os.listdir(t["all_cfg"].log_dir)) == [name]
    rows = _slam_rows(os.path.join(t["all_cfg"].log_dir, name))
    jrows = _slam_rows(evals["jax"]["cfg"].slam_eval_csv)
    assert [r[0] for r in rows] == [jrows[1][0]] == [SEQ_B]
    np.testing.assert_allclose(rows[0][1], jrows[1][1], rtol=0, atol=1e-8)
    np.testing.assert_allclose(t["all"][("train", "icp_mapper")][SEQ_B],
                               evals["jax"]["res"][SEQ_B], rtol=0, atol=1e-8)


def test_export_corrected_clouds_matches_jax(tmp_path):
    """The npz files: names, keys and values (1e-9)."""
    out = {}
    for cls, mod, tag in ((JConfig, jslam, "jax"), (TConfig, tslam, "port")):
        cfg = _cfg(cls, test_names=[SEQ_A])
        out[tag] = mod.export_corrected_clouds(cfg, str(tmp_path / tag))
    assert [os.path.basename(p) for p in out["port"]] == \
        [os.path.basename(p) for p in out["jax"]] and len(out["port"]) == 3
    for jp, tp in zip(out["jax"], out["port"]):
        j, t = np.load(jp), np.load(tp)
        assert sorted(t.files) == sorted(j.files) == ["frame", "mask", "normals", "points", "pose"]
        for key in j.files:
            if j[key].dtype.kind == "f":
                np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-9)
            else:
                np.testing.assert_array_equal(t[key], j[key])


def test_external_slam_stub_matches_jax(tmp_path):
    """cfg.slam = norlab_icp_mapper through scripts/stub_slam_mapper.py with
    a known drift: the exported scans (npz keys), the poses read back, the
    CSV row equal to the JAX package's; a second run clears stale scans; a
    mapper that writes no poses, or too few, raises."""
    drift = 0.05
    kw = dict(test_names=[SEQ_A], odom_cov=[0.0] * 6, slam="norlab_icp_mapper",
              slam_command="%s %s {input_dir} {poses_csv} --drift %g"
              % (sys.executable, STUB, drift))
    res = {}
    for cls, mod, tag in ((JConfig, jslam, "jax"), (TConfig, tslam, "port")):
        cfg = _cfg(cls, log_dir=str(tmp_path / tag), **kw)
        cfg.slam_eval_csv = os.path.join(cfg.log_dir, "slam_eval.csv")
        res[tag] = mod.eval_slam(cfg, apply_correction=False)
    np.testing.assert_allclose(res["port"][SEQ_A], res["jax"][SEQ_A], rtol=0, atol=1e-8)
    np.testing.assert_allclose(res["port"][SEQ_A][1], drift, rtol=1e-6)  # mean of 0, d, 2d
    in_dir = os.path.join(cfg.log_dir, "external_slam", SEQ_A.replace("/", "_"))
    scans = sorted(f for f in os.listdir(in_dir) if f.startswith("scan_"))
    assert scans == ["scan_0000.npz", "scan_0001.npz", "scan_0002.npz"]
    with np.load(os.path.join(in_dir, scans[0])) as z:
        assert sorted(z.files) == ["frame", "mask", "normals", "points", "prior"]
    np.savez(os.path.join(in_dir, "scan_0009.npz"), points=np.zeros((1, 3)))
    again = tslam.eval_slam(cfg, apply_correction=False)
    np.testing.assert_allclose(again[SEQ_A], res["port"][SEQ_A], rtol=0, atol=1e-12)
    assert not os.path.exists(os.path.join(in_dir, "scan_0009.npz"))
    rows = _slam_rows(cfg.slam_eval_csv)
    assert len(rows) == 2 and rows[1] == rows[0]
    with open(cfg.slam_eval_csv) as f:
        first = f.readline()
    with open(os.path.join(str(tmp_path / "jax"), "slam_eval.csv")) as f:
        assert f.read() == first

    clouds = [t_local_feature_cloud(scan, cfg) for scan, _ in t_create_dataset(SEQ_A, cfg)]
    prior = np.tile(np.eye(4), (3, 1, 1))
    cfg.slam_command = "%s -c pass {input_dir} {poses_csv}" % sys.executable
    with pytest.raises(RuntimeError, match="wrote no poses"):
        tslam.run_external_slam(cfg, "none", clouds, prior)
    with pytest.raises(RuntimeError, match="returned 2 poses for 3 scans"):
        _short_run(cfg, clouds, prior)


def _short_run(cfg, clouds, prior):
    """run_external_slam with a mapper that drops the last scan's pose."""
    script = os.path.join(cfg.log_dir, "short_mapper.py")
    with open(script, "w") as f:
        f.write("import subprocess, sys\n"
                "subprocess.run([sys.executable, %r, sys.argv[1], sys.argv[2], '--drift', '0'],"
                " check=True)\n"
                "lines = open(sys.argv[2]).read().splitlines()\n"
                "open(sys.argv[2], 'w').write('\\n'.join(lines[:-1]) + '\\n')\n" % STUB)
    cfg.slam_command = "%s %s {input_dir} {poses_csv}" % (sys.executable, script)
    return tslam.run_external_slam(cfg, "short", clouds, prior)


def test_train_and_eval_with_default_eval_slams(tmp_path, monkeypatch):
    """A default Config()'s eval_slams ([icp_mapper]) no longer raises:
    train_and_eval trains, evaluates the loss and runs the mapper on the
    best model, whose row equals eval_slam_all's on the same config. (No
    TensorBoard writer: its import alone takes ~14 s here.)"""
    from depth_correction_tpu_torch import train as ttrain
    from depth_correction_tpu_torch.eval import eval_slam_all as t_eval_slam_all
    from depth_correction_tpu_torch.train_and_eval import train_and_eval as t_train_and_eval

    monkeypatch.setattr(ttrain, "_summary_writer", lambda log_dir: None)

    assert TConfig().eval_slams == ["icp_mapper"]
    cfg = _cfg(TConfig, train_names=[SEQ_B], n_opt_iters=2, lr=1e-4,
               eval_losses=["min_eigval_loss"], model_kwargs={"w": [0.0], "exponent": [4.0]},
               loss_kwargs={"sqrt": False, "normalization": True}, log_dir=str(tmp_path / "a"))
    cfg.eval_slams = list(TConfig().eval_slams)
    best, res = t_train_and_eval(cfg)
    assert sorted(res) == [("train", "icp_mapper"), ("train", "min_eigval_loss")]
    rows = _slam_rows(os.path.join(cfg.log_dir, "slam_eval_icp_mapper_train.csv"))
    assert [r[0] for r in rows] == [SEQ_B]
    again = best.copy()
    again.log_dir = str(tmp_path / "b")
    np.testing.assert_allclose(t_eval_slam_all(again)[("train", "icp_mapper")][SEQ_B],
                               res[("train", "icp_mapper")][SEQ_B], rtol=0, atol=1e-12)
