"""The port's loss evaluation and train_and_eval against the JAX package's,
float64 on the CPU.

eval_loss, eval_loss_all and train_and_eval write the JAX package's CSV
rows (``loss_eval_<loss>[_<subset>].csv``, ``"<names> <loss>"``) with the
same values; the pose deltas npz that either package writes loads in the
other and evaluates to the same loss; an option outside the port raises
NotImplementedError naming itself before any work (the ICP loss and
eval_icp are held against the JAX package in tests/test_torch_icp.py,
SLAM evaluation in tests/test_torch_slam.py).
"""
import os

import numpy as np
import pytest

from depth_correction_tpu import eval as jeval
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.train_and_eval import train_and_eval as j_train_and_eval
from depth_correction_tpu.utils.checkpoint import save_pytree as j_save_pytree
from depth_correction_tpu_torch import eval as teval
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.train_and_eval import train_and_eval as t_train_and_eval
from depth_correction_tpu_torch.utils.checkpoint import load_pytree as t_load_pytree
from depth_correction_tpu_torch.utils.checkpoint import save_pytree as t_save_pytree

LOSSES = ["min_eigval_loss", "trace_loss"]


def _cfg(cls, log_dir, **kw):
    """tests/test_torch_train.py's configuration (the ground-plane scene,
    float64, scipy establishment)."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.log_dir = str(log_dir)
    cfg.train_names = ["ground_plane/4"]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.nn_backend = "scipy"
    cfg.n_opt_iters = 3
    cfg.lr = 5e-4
    cfg.eval_losses = list(LOSSES)
    cfg.eval_slams = []
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _rows(path):
    """A loss CSV as [(names, value)]."""
    with open(path) as f:
        return [(line.split()[0], float(line.split()[1])) for line in f]


def _same_csvs(jdir, tdir):
    """Every loss_eval_*.csv of jdir exists in tdir with the same names and
    values within rtol 1e-9; returns the file names."""
    names = sorted(f for f in os.listdir(jdir) if f.startswith("loss_eval_"))
    assert names and names == sorted(f for f in os.listdir(tdir) if f.startswith("loss_eval_"))
    for name in names:
        jrows, trows = _rows(os.path.join(jdir, name)), _rows(os.path.join(tdir, name))
        assert [r[0] for r in trows] == [r[0] for r in jrows]
        np.testing.assert_allclose([r[1] for r in trows], [r[1] for r in jrows], rtol=1e-9)
        with open(os.path.join(tdir, name)) as f:
            for line in f:
                assert line.endswith("\n") and len(line.split()[1].split(".")[1]) == 9
    return names


def test_eval_loss_all_matches_jax(tmp_path):
    """Both losses on the train, val and test sequences: the same six CSV
    files, rows and values (rtol 1e-9) and the same results."""
    kw = dict(val_names=["ground_plane/2"], test_names=["ground_plane/3", "ground_plane/5"])
    jcfg, tcfg = _cfg(JConfig, tmp_path / "jax", **kw), _cfg(TConfig, tmp_path / "port", **kw)
    jres, tres = jeval.eval_loss_all(jcfg), teval.eval_loss_all(tcfg)
    assert sorted(tres) == sorted(jres) == sorted(
        (s, loss) for s in ("train", "val", "test") for loss in LOSSES)
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-9)
    names = _same_csvs(jcfg.log_dir, tcfg.log_dir)
    assert len(names) == 6
    assert _rows(os.path.join(tcfg.log_dir, "loss_eval_trace_loss_test.csv"))[0][0] == \
        "ground_plane/3,ground_plane/5"


def test_train_and_eval_matches_jax(tmp_path):
    """train() then eval_loss_all at the best model (eval_slams empty): the
    best configs, results and CSV files agree."""
    jcfg, tcfg = _cfg(JConfig, tmp_path / "jax"), _cfg(TConfig, tmp_path / "port")
    (jbest, jres), (tbest, tres) = j_train_and_eval(jcfg), t_train_and_eval(tcfg)
    assert os.path.basename(tbest.model_state_dict) == os.path.basename(jbest.model_state_dict)
    assert sorted(tres) == sorted(jres) == [("train", loss) for loss in LOSSES]
    for k in jres:
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-9)
    _same_csvs(jcfg.log_dir, tcfg.log_dir)


@pytest.mark.parametrize("mode", ["common", "sequence", "pose"])
def test_pose_deltas_files_cross_packages(tmp_path, mode):
    """Deltas saved by either package's save_pytree load in the other
    (keys 0, 1, ... sorted as integers) and eval_loss gives the same loss,
    appended as the same CSV row, in both packages from either file."""
    names = ["ground_plane/4", "ground_plane/3"]
    rng = np.random.default_rng(5)
    scans = {"ground_plane/4": 4, "ground_plane/3": 3}
    if mode == "common":
        deltas = (0.02 * rng.standard_normal((1, 6)),)
    else:
        deltas = tuple(0.02 * rng.standard_normal((1 if mode == "sequence" else scans[n], 6))
                       for n in names)
    files = {"jax": j_save_pytree(str(tmp_path / "j_pose_deltas.npz"), deltas),
             "port": t_save_pytree(str(tmp_path / "t_pose_deltas.npz"), deltas)}
    for path in files.values():
        loaded = t_load_pytree(path)
        assert sorted(loaded) == [str(i) for i in range(len(deltas))]
        for i, d in enumerate(deltas):
            np.testing.assert_array_equal(loaded[str(i)], d)
    values = {}
    for pkg, cls, ev in (("jax", JConfig, jeval), ("port", TConfig, teval)):
        for src, path in files.items():
            csv = str(tmp_path / ("%s_from_%s.csv" % (pkg, src)))
            cfg = _cfg(cls, tmp_path / pkg, test_names=names, pose_correction=mode,
                       test_pose_deltas=path, loss_eval_csv=csv)
            values[pkg, src] = ev.eval_loss(cfg)
            assert _rows(csv)[0][0] == ",".join(names)
    ref = values["jax", "jax"]
    for k, v in values.items():
        np.testing.assert_allclose(v, ref, rtol=1e-9, err_msg=str(k))
    zero = teval.eval_loss(_cfg(TConfig, tmp_path / "port", test_names=names))
    assert abs(zero - ref) > 1e-6 * abs(ref)


def test_unported_options_raise_naming_themselves(tmp_path):
    """An option the run cannot take raises naming itself, from
    train_and_eval and from eval_loss_all, before writing anything (with
    icp_loss among eval_losses and the default eval_slams, which are
    ported: SLAM evaluation is held to the JAX package in
    tests/test_torch_slam.py). Multi-GPU is ported (tests/
    test_torch_parallel.py), so mesh_shape without a process group raises
    ValueError naming mesh_shape and the two ways to start one."""
    cfg = _cfg(TConfig, tmp_path / "port", eval_losses=["min_eigval_loss", "icp_loss"])
    cfg.eval_slams = ["icp_mapper"]
    cfg.mesh_shape = {"data": 2}
    for run in (t_train_and_eval, teval.eval_loss_all):
        with pytest.raises(ValueError, match="mesh_shape") as err:
            run(cfg)
        assert "torchrun" in str(err.value) and "dist_coordinator" in str(err.value)
    assert not os.path.exists(cfg.log_dir)
