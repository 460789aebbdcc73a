"""The port's train() against the JAX package's, float64 on the CPU.

Both packages train the same configuration (tests/test_torch_slice.py's
ground_plane scene) into their own log_dir, with and without validation
sequences: the files each writes (train.yaml, the best model's npz,
best.yaml, train_history.csv), the best model and config each returns,
and each npz read by the other package's load_model. Then spatial_sort,
which turns the JAX package's cell-window engine off: the port's loss,
gradient and Adam steps against the JAX package's with it set.
"""
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu import models as jmodels
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.train import bind_cellwin_static
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu.train import train as j_train
from depth_correction_tpu_torch import models as tmodels
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.train import TrainCallbacks
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences
from depth_correction_tpu_torch.train import train as t_train

VAL = "ground_plane/2"
# Keys of best.yaml that name the run's own files.
PATH_KEYS = ("log_dir", "model_state_dict")


def _cfg(cls, log_dir, val_names=(), backend="auto"):
    """tests/test_torch_slice.py's configuration, three Adam steps."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.log_dir = str(log_dir)
    cfg.train_names = ["ground_plane/4"]
    cfg.val_names = list(val_names)
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.moments_backend = backend
    cfg.nn_backend = "scipy"
    cfg.n_opt_iters = 3
    cfg.lr = 5e-4
    return cfg


@pytest.fixture(scope="module", params=[(), (VAL,)], ids=["no_val", "val"])
def trained(request, tmp_path_factory):
    """Both packages' train() on the same config: (JAX best config, port
    best config, JAX log_dir, port log_dir)."""
    root = tmp_path_factory.mktemp("train")
    jcfg = _cfg(JConfig, root / "jax", request.param)
    tcfg = _cfg(TConfig, root / "port", request.param)
    return j_train(jcfg), t_train(tcfg), jcfg.log_dir, tcfg.log_dir


def _history(log_dir):
    with open(os.path.join(log_dir, "train_history.csv")) as f:
        header = f.readline().split()
        rows = np.loadtxt(f, ndmin=2)
    return header, rows


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_train_writes_what_the_jax_package_writes(trained):
    """train.yaml, the same best iterations and tags, the history within
    rtol 1e-9, the best npz within rtol 1e-8 and best.yaml equal apart from
    the paths."""
    jbest, tbest, jdir, tdir = trained
    assert tbest is not None and jbest is not None
    jfiles, tfiles = sorted(os.listdir(jdir)), sorted(os.listdir(tdir))
    for name in ("train.yaml", "best.yaml", "train_history.csv"):
        assert name in tfiles
    npz = sorted(f for f in jfiles if f.endswith("_state_dict.npz"))
    assert npz and npz == sorted(f for f in tfiles if f.endswith("_state_dict.npz"))
    assert os.path.basename(tbest.model_state_dict) == os.path.basename(jbest.model_state_dict)
    assert os.path.dirname(tbest.model_state_dict) == tdir

    (jhead, jrows), (thead, trows) = _history(jdir), _history(tdir)
    assert thead == jhead == ["iter", "train_loss", "val_loss", "step_ms"]
    np.testing.assert_array_equal(trows[:, 0], jrows[:, 0])
    np.testing.assert_allclose(trows[:, 1:3], jrows[:, 1:3], rtol=1e-9)
    if not tbest.val_names:
        np.testing.assert_array_equal(trows[:, 2], trows[:, 1])
    else:
        assert not np.array_equal(trows[:, 2], trows[:, 1])

    jstate, tstate = _npz(jbest.model_state_dict), _npz(tbest.model_state_dict)
    assert sorted(tstate) == sorted(jstate) == ["exponent", "w"]
    for k in jstate:
        assert tstate[k].dtype == jstate[k].dtype
        np.testing.assert_allclose(tstate[k], jstate[k], rtol=1e-8)

    def load(log_dir):
        with open(os.path.join(log_dir, "best.yaml")) as f:
            d = yaml.safe_load(f)
        return {k: v for k, v in d.items() if k not in PATH_KEYS}

    assert load(tdir) == load(jdir)
    with open(os.path.join(tdir, "train.yaml")) as f:
        assert yaml.safe_load(f)["log_dir"] == tdir


def test_best_models_load_in_either_package(trained):
    """Each package's best npz through the other package's
    load_model(cfg=best_cfg)."""
    jbest, tbest, _, _ = trained
    jfrom_t = jbest.copy()
    jfrom_t.model_state_dict = tbest.model_state_dict
    tfrom_j = tbest.copy()
    tfrom_j.model_state_dict = jbest.model_state_dict
    jm, jm_t = jmodels.load_model(cfg=jbest), jmodels.load_model(cfg=jfrom_t)
    tm, tm_j = tmodels.load_model(cfg=tbest), tmodels.load_model(cfg=tfrom_j)
    np.testing.assert_array_equal(np.asarray(jm_t.w), tm.w.detach().numpy())
    np.testing.assert_array_equal(tm_j.w.detach().numpy(), np.asarray(jm.w))
    np.testing.assert_allclose(tm.w.detach().numpy(), np.asarray(jm.w), rtol=1e-8)
    assert float(tm.w.detach()[0]) != 0.0


def test_spatial_sort_trains_like_the_jax_package(tmp_path):
    """spatial_sort = True with the cell-window backend asked for: neither
    package builds the cell-window graph; the loss and gradient at w = 0
    match within rtol 1e-9, and three Adam steps within 1e-8."""
    jcfg = _cfg(JConfig, tmp_path / "jax", backend="cellwin")
    tcfg = _cfg(TConfig, tmp_path / "port", backend="cellwin")
    jcfg.spatial_sort = tcfg.spatial_sort = True
    jdata = j_prepare_sequences([j_create_dataset(jcfg.train_names[0], jcfg)], jcfg)
    tdata = t_prepare_sequences([t_create_dataset(tcfg.train_names[0], tcfg)], tcfg)
    assert tdata.cellwin == (None,)
    assert jdata.cellwin[0] is None and jdata.point_perm[0] is not None

    loss_fn, data = bind_cellwin_static(j_make_loss_fn(jcfg), jdata)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    params = {"model": jmodels.load_model(cfg=jcfg)}
    tx = optax.adam(jcfg.lr)
    state = tx.init(params)
    traj = []
    for _ in range(3):
        value, g = grad_fn(params, data)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        traj.append((float(value), float(g["model"].w[0]), float(params["model"].w[0])))

    model = tmodels.load_model(cfg=tcfg)
    value = t_make_loss_fn(tcfg)(model, tdata)
    value.backward()
    np.testing.assert_allclose(float(value.detach()), traj[0][0], rtol=1e-9)
    np.testing.assert_allclose(float(model.w.grad[0]), traj[0][1], rtol=1e-9)

    class Record(TrainCallbacks):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.grads = []

        def train_loss(self, it, model, pose_deltas, loss):
            self.grads.append(float(model.w.grad[0]))

    rec = Record(tcfg)
    model, history = t_fit(tcfg, tdata, callbacks=rec)
    np.testing.assert_allclose([h[1] for h in history], [t[0] for t in traj], rtol=1e-9)
    np.testing.assert_allclose(rec.grads, [t[1] for t in traj], rtol=1e-9)
    np.testing.assert_allclose(float(model.w.detach()[0]), traj[-1][2], rtol=1e-8)
