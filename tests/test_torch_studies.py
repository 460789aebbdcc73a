"""The port's study scripts (depth_correction_tpu_torch/studies) against
the JAX package's scripts/*.py, float64 on the CPU: the library-level
functions each study is built on, at rtol 1e-9, on the same seeded inputs;
the files the studies write; every study's ``--device`` contract; and the
ICP example's Adam trajectory within 1e-8. The other training studies are
held in tests/test_torch_studies_train.py, test_torch_studies_scale.py,
test_torch_studies_demo.py and test_torch_studies_examples.py.

The JAX scripts are imported as tests/test_alignment_bias.py imports them
(``scripts/`` on ``sys.path``). Scenes are small open boxes made once by the
port's loader (with 5 mm of depth noise, so no planar mask is decided by
rounding) and fed to both packages as the same numpy arrays.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from depth_correction_tpu.config import Config as JConfig  # noqa: E402
from depth_correction_tpu_torch.config import Config as TConfig  # noqa: E402
from depth_correction_tpu.models import ScaledPolynomial as JSP  # noqa: E402
from depth_correction_tpu_torch.studies import STUDIES  # noqa: E402
from torch_studies_common import (EXAMPLE_SCENE, jax_adam, jax_cfg_like,  # noqa: E402
                                   small_chunks, thinned)  # noqa: F401

SCENE = "open_box/n_2_size_4_4_2_height_1_density_40"


def _both(**settings):
    """A JAX and a port config with the same settings, float64 on the CPU."""
    out = []
    for cls in (JConfig, TConfig):
        cfg = cls()
        cfg.float_type = "float64"
        for k, v in settings.items():
            setattr(cfg, k, v)
        out.append(cfg)
    out[1].device = "cpu"
    return out


def _close(a, b, rtol=1e-9, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def scans():
    """The scene's (scan, pose) pairs, biased and noisy, from the port's
    loader, each scan thinned until every point has at least 4 others
    within 0.4 m (a sparser neighbourhood's normal is decided by rounding
    in either package)."""
    from scipy.spatial import cKDTree

    from depth_correction_tpu_torch.datasets import create_dataset

    cfg = TConfig()
    cfg.device = "cpu"
    cfg.float_type = "float64"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.5, 20.0, 0.1
    cfg.depth_noise = 0.005
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    out = []
    for scan, pose in create_dataset(SCENE, cfg):
        while True:
            p = np.c_[scan["x"], scan["y"], scan["z"]]
            counts = np.array([len(b) for b in cKDTree(p).query_ball_point(p, 0.4)])
            if counts.min() >= 5:
                break
            scan = scan[counts >= 5]
        out.append((scan, np.asarray(pose)))
    return out


# ---------------------------------------------------------------------------
# Board bias and path alignment (numpy around one library call each).

def test_bias_estimation_matches_jax():
    import bias_estimation as jbe

    from depth_correction_tpu_torch.models import ScaledPolynomial as TSP
    from depth_correction_tpu_torch.studies import bias_estimation as tbe

    js, ts = jbe.synthetic_board_scans(w_bias=-0.003), tbe.synthetic_board_scans(w_bias=-0.003)
    for a, b in zip(js, ts):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    jmodel = JSP(w=jnp.asarray([-0.003]), exponent=jnp.asarray([4.0]))
    tmodel = TSP(w=[-0.003], exponent=[4.0], dtype=torch.float64)
    for jm, tm in ((None, None), (jmodel, tmodel)):
        (ji, jn, jf), (ti, tn, tf) = jbe.estimate_bias(js, jm), tbe.estimate_bias(ts, tm)
        _close(ti, ji)
        _close(tn, jn, atol=1e-15)
        for deg in (1, 2):
            _close(tf[deg], jf[deg], atol=1e-17)
    assert abs(tf[1][1]) < 1e-2 * abs(tbe.estimate_bias(ts)[2][1][1])


@pytest.mark.parametrize("paired", [True, False])
def test_align_paths_matches_jax(paired):
    import paths_alignment as jpa

    from depth_correction_tpu_torch.studies import paths_alignment as tpa

    source, target = tpa.synthetic_paths()
    if not paired:
        source = source[::3]
    jT, jb, ja = jpa.align_paths(source, target, paired=paired)
    tT, tb, ta = tpa.align_paths(source, target, paired=paired)
    _close(tT, jT, atol=1e-12)
    _close([tb, ta], [jb, ja])
    assert ta < 0.5 * tb


def test_paths_alignment_main_matches_jax(capsys):
    import paths_alignment as jpa

    from depth_correction_tpu_torch.studies import paths_alignment as tpa

    jT, jb, ja = jpa.main([])
    tT, tb, ta = tpa.main(["--device", "cpu"])
    _close(tT, jT, atol=1e-12)
    _close([tb, ta], [jb, ja])
    assert "RMS residual" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Range images and the denoising study.

def test_median_denoise_matches_jax():
    import depth_denoising as jdd

    from depth_correction_tpu_torch.studies import depth_denoising as tdd

    rng = np.random.default_rng(0)
    img = rng.uniform(1.0, 20.0, (16, 24))
    hit = rng.uniform(size=img.shape) < 0.7
    img = np.where(hit, img, 0.0)
    want = np.asarray(jdd.median_denoise_range_image(jnp.asarray(img), jnp.asarray(hit)))
    got = tdd.median_denoise_range_image(torch.as_tensor(img), torch.as_tensor(hit)).numpy()
    _close(got, want)
    assert (got != img).any()


@pytest.mark.parametrize("external", [False, True])
def test_scan_variants_match_jax_library(scans, tmp_path, external):
    """The port's scan_variants in float64 against the JAX script's steps
    (its project / median or external command / unproject) in float64:
    the JAX script casts to float32, so its library functions stand in."""
    import depth_denoising as jdd

    from depth_correction_tpu.ops.range_image import project_range_image as jproj
    from depth_correction_tpu.ops.range_image import unproject_range_image as junproj
    from depth_correction_tpu_torch.studies import depth_denoising as tdd

    cmd = None
    if external:
        stub = os.path.join(os.path.dirname(__file__), "..", "scripts", "stub_denoiser.py")
        cmd = "%s %s --input {input_npz} --output {output_npz}" % (sys.executable, stub)
    scan = scans[0][0]
    tcfg = _both()[1]
    raw, den = tdd.scan_variants(scan, tcfg, None, denoiser_command=cmd,
                                 workdir=str(tmp_path / "port"))
    assert raw is scan
    pts = np.stack([scan["x"], scan["y"], scan["z"]], 1).astype(np.float64)
    img, hit = jproj(jnp.asarray(pts), jnp.ones(len(pts), bool))
    if external:
        img = jdd.external_denoise_range_image(img, hit, cmd, str(tmp_path / "jax"))
    else:
        img = jdd.median_denoise_range_image(img, hit)
    jpts, ok = junproj(img, hit)
    want = np.asarray(jpts)[np.asarray(ok)]
    got = np.stack([den["x"], den["y"], den["z"]], 1)
    assert got.shape == want.shape and len(got) > 500
    _close(got, want, atol=1e-12)


# ---------------------------------------------------------------------------
# Maps: correct_map, the two aggregate_map, the map metrics.

def test_correct_map_matches_jax(scans, small_chunks):
    import map_bias_removal as jmb

    from depth_correction_tpu_torch.studies import map_bias_removal as tmb

    tcfg = tmb.make_cfg("cpu", "float64")
    jcfg = _both(min_depth=0.5, max_depth=50.0, grid_res=0.0, nn_r=0.4, nn_k=0,
                 nn_max_neighbors=32, eigenvalue_ratio_bounds=[],
                 vp_dispersion_bounds=[])[0]
    pts, vps = [], []
    for scan, pose in scans:
        local = np.stack([scan["x"], scan["y"], scan["z"]], 1).astype(np.float64)
        pts.append(local @ pose[:3, :3].T + pose[:3, 3])
        vps.append(np.tile(pose[:3, 3], (len(local), 1)))
    pts, vps = np.concatenate(pts), np.concatenate(vps)
    want = jmb.correct_map(pts, vps, jcfg, JSP(w=jnp.asarray([-0.002]),
                                              exponent=jnp.asarray([4.0])))
    from depth_correction_tpu_torch.models import ScaledPolynomial as TSP

    got = tmb.correct_map(pts, vps, tcfg, TSP(w=[-0.002], exponent=[4.0], dtype=torch.float64))
    assert got.shape == want.shape == pts.shape
    _close(got, want)
    assert np.abs(got - pts).max() > 1e-4


def test_map_bias_removal_main_writes_the_jax_layout(scans, tmp_path):
    """--map FILE: the npz written holds ``points`` only, as the JAX
    script's (the synthetic fallback's scene is too large for a CPU test)."""
    from depth_correction_tpu_torch.studies import map_bias_removal as tmb

    scan, pose = scans[0]
    local = np.stack([scan["x"], scan["y"], scan["z"]], 1).astype(np.float64)
    np.savez(tmp_path / "map.npz", points=local @ pose[:3, :3].T + pose[:3, 3],
             vps=np.tile(pose[:3, 3], (len(local), 1)))
    out = tmb.main(["--map", str(tmp_path / "map.npz"), "--out", str(tmp_path / "out"),
                    "--device", "cpu"])
    with np.load(tmp_path / "out" / "map_corrected.npz") as z:
        assert z.files == ["points"]
        np.testing.assert_array_equal(z["points"], out)
    assert out.dtype == np.float32 and out.shape[1] == 3


def test_aggregate_maps_and_metrics_match_jax(scans, small_chunks):
    import mapping_accuracy as jma
    import reconstruction_eval as jre

    from depth_correction_tpu.metrics import chamfer_distance as jchamfer
    from depth_correction_tpu.metrics import mapping_accuracy as jacc
    from depth_correction_tpu_torch.metrics import chamfer_distance as tchamfer
    from depth_correction_tpu_torch.metrics import mapping_accuracy as tacc
    from depth_correction_tpu_torch.models import ScaledPolynomial as TSP
    from depth_correction_tpu_torch.studies import mapping_accuracy as tma
    from depth_correction_tpu_torch.studies import reconstruction_eval as tre

    settings = dict(min_depth=0.5, max_depth=25.0, grid_res=0.2, nn_r=0.4, nn_k=0,
                    nn_max_neighbors=32, eigenvalue_ratio_bounds=[], min_valid_neighbors=3)
    jcfg, tcfg = _both(**settings)
    jm = JSP(w=jnp.asarray([-0.002]), exponent=jnp.asarray([4.0]))
    tm = TSP(w=[-0.002], exponent=[4.0], dtype=torch.float64)
    jp, jv = jma.aggregate_map(scans, jcfg, jm)
    tp, tv = tma.aggregate_map(scans, tcfg, tm)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tp.numpy()[tv.numpy()], np.asarray(jp)[np.asarray(jv)])
    gt = np.asarray(jp)[np.asarray(jv)][::3] + 0.01
    _close(float(tacc(tp, torch.as_tensor(gt), 0.8, valid_cloud=tv)),
           float(jacc(jp, jnp.asarray(gt), 0.8, valid_cloud=jv)))
    jmap, tmap = jre.aggregate_map([scans], jcfg, jm), tre.aggregate_map([scans], tcfg, tm)
    _close(tmap, jmap)
    _close(float(tchamfer(torch.as_tensor(tmap), torch.as_tensor(gt))),
           float(jchamfer(jnp.asarray(jmap), jnp.asarray(gt))))


# ---------------------------------------------------------------------------
# Localization, the npz layout, KITTI-360's filtered scans.

def test_localization_accuracy_matches_jax(tmp_path, monkeypatch):
    import localization_accuracy as jla

    from depth_correction_tpu.metrics import localization_errors as jerr
    from depth_correction_tpu.metrics import static_intervals as jstatic
    from depth_correction_tpu.metrics import tracker_position_error as jtrack
    from depth_correction_tpu_torch.studies import localization_accuracy as tla

    times, pos, T_est = tla.synthetic_tracks()
    for a, b in zip(jla.synthetic_tracks(), (times, pos, T_est)):
        np.testing.assert_array_equal(a, b)
    intervals, idx, err, rel_angle, rel_offset = tla.station_errors(times, pos, T_est)
    assert intervals == jstatic(times, pos) and len(intervals) == 4
    _close(err, float(jtrack(jnp.asarray(T_est[idx]), jnp.asarray(pos[idx]))))
    T_gt = np.tile(np.eye(4), (len(idx), 1, 1))
    T_gt[:, :3, 3] = pos[idx]
    _, _, ja, jo = jerr(jnp.asarray(T_gt), jnp.asarray(T_est[idx]))
    _close([rel_angle, rel_offset], [float(np.mean(ja)), float(np.mean(jo))], atol=1e-15)
    monkeypatch.chdir(tmp_path)
    jla.main(["--out", "jax"])
    tla.main(["--out", "port", "--device", "cpu"])
    rows = [np.loadtxt(os.path.join(d, "localization_accuracy.csv")) for d in ("jax", "port")]
    _close(rows[1], rows[0], atol=1e-15)


def test_create_dataset_npz_writes_the_jax_files(tmp_path):
    import create_dataset_npz as jcd

    from depth_correction_tpu_torch.studies import create_dataset_npz as tcd

    jcd.main(["--source", "ground_plane/3", "--out", str(tmp_path / "jax")])
    tcd.main(["--source", "ground_plane/3", "--out", str(tmp_path / "port"), "--device", "cpu"])
    for sub in ("static_ouster_points", "poses"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub)) and names
    for name in os.listdir(tmp_path / "jax" / "static_ouster_points"):
        with np.load(tmp_path / "jax" / "static_ouster_points" / name) as a, \
                np.load(tmp_path / "port" / "static_ouster_points" / name) as b:
            assert a.files == b.files == ["cloud"]
            assert a["cloud"].dtype == b["cloud"].dtype
            np.testing.assert_array_equal(a["cloud"], b["cloud"])
    csv = "poses/static_poses.csv"
    assert open(tmp_path / "port" / csv).read() == open(tmp_path / "jax" / csv).read()
    from depth_correction_tpu_torch.datasets.fee_corridor import Dataset

    assert len(Dataset(path=str(tmp_path / "port"))) == 3


def test_generate_scans_wo_dynamic_objects_matches_jax(tmp_path, monkeypatch):
    import generate_scans_wo_dynamic_objects_kitti360 as jgen

    import depth_correction_tpu.datasets.kitti360 as j_k3
    import depth_correction_tpu_torch.datasets.kitti360 as t_k3
    from depth_correction_tpu_torch.studies import \
        generate_scans_wo_dynamic_objects_kitti360 as tgen
    from test_torch_datasets_io import _write_kitti360

    _write_kitti360(tmp_path, calib=np.eye(4), with_semantics=True)
    monkeypatch.setattr(j_k3, "data_dir", str(tmp_path))
    monkeypatch.setattr(t_k3, "data_dir", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["x", "kitti360/00", "--out-dir", str(tmp_path / "jf")])
    jgen.main()
    out = tgen.main(["kitti360/00", "--out-dir", str(tmp_path / "tf"), "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(tmp_path / "jf")) and names
    for name in names:
        data = open(os.path.join(out, name), "rb").read()
        assert data == open(tmp_path / "jf" / name, "rb").read()


# ---------------------------------------------------------------------------
# bench_knn: the grid search's sets at a small size.

def test_bench_knn_sets_match_jax():
    """bench_knn's main at 2,048 points (the JAX script's first draw of
    seed 0, scaled to ~25 a ball): X2's and X3's sets equal, scipy's balls
    but for radius ties; the port's grid sets equal the JAX package's
    grid search on the same points, r 0.25, k 48."""
    from depth_correction_tpu.ops.grid_hash import grid_radius_neighbors as j_grid
    from depth_correction_tpu_torch.ops.grid_hash import grid_radius_neighbors as t_grid
    from depth_correction_tpu_torch.studies import bench_knn as tbk

    (row,) = tbk.main(["--sizes", "2048", "--reps", "1", "--device", "cpu"])
    assert row["n"] == 2048 and row["sets_equal"] and row["scipy"]["ties_only"]
    assert 20 < row["ball_mean"] < 30
    pts = tbk.uniform_points(2048, np.random.default_rng(0))
    _, ti = t_grid(torch.as_tensor(pts), r=tbk.R, k=tbk.K)
    _, ji = j_grid(jnp.asarray(pts), r=tbk.R, k=tbk.K)
    assert tbk.row_sets(ti.numpy()) == tbk.row_sets(np.asarray(ji))


# ---------------------------------------------------------------------------
# Every study: a card by default, the CPU on request.

@pytest.mark.parametrize("name", STUDIES)
def test_study_defaults_to_the_card(name, monkeypatch, tmp_path):
    """--device defaults to cuda; without a card the study raises before
    any work, naming the CPU option, as Config.torch_device does."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module("depth_correction_tpu_torch.studies." + name)
    argv = {"create_dataset_npz": ["--source", "ground_plane/3", "--out", "unused"],
            "generate_scans_wo_dynamic_objects_kitti360": ["kitti360/00"]}.get(name, [])
    with pytest.raises(RuntimeError, match='cfg.device = "cpu"'):
        mod.main(argv + ["--steps", "1"] if name == "train_at_scale" else argv)


# ---------------------------------------------------------------------------
# The ICP example: an Adam trajectory within 1e-8.

def test_example_optimization_icp_follows_jax(small_chunks):
    """Three steps of w on the pair's point-to-plane distance against the
    example's jitted optax step."""
    from depth_correction_tpu.loss import point_to_plane_dist as j_p2p
    from depth_correction_tpu.preproc import local_feature_cloud as j_lfc
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.studies import optimization_icp as ticp

    tcfg = ticp.make_cfg("cpu")
    tcfg.float_type = "float64"
    tcfg.depth_noise = 0.005
    scans = thinned(create_dataset(EXAMPLE_SCENE, tcfg), tcfg.nn_r)
    w, losses = ticp.optimize(tcfg, *ticp.posed_clouds(scans, tcfg), iters=3)

    jcfg = jax_cfg_like(tcfg, ["grid_res", "min_depth", "max_depth", "nn_r", "lr",
                                "eigenvalue_ratio_bounds", "float_type"])
    c1, c2 = (j_lfc(scans[i][0], jcfg).transform(jnp.asarray(scans[i][1])) for i in (0, 1))

    def loss_fn(params, data):
        model = JSP(w=params, exponent=jnp.asarray([4.0]))
        return j_p2p([model.apply(c).with_points() for c in data], icp_inlier_ratio=0.5)

    want, jw = jax_adam(loss_fn, jnp.zeros(1), (c1, c2), jcfg.lr, 3)
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(losses, want, rtol=1e-8)
    np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-8)
