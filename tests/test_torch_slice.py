"""The port's training slice against the JAX package, float64 on the CPU.

Same configuration on both sides (tests/test_cellwin.py:_tiny_cfg, with
scipy neighbor establishment, and again with the bench's grid
establishment): datasets -> prepare_sequences -> make_loss_fn, then Adam. The JAX side's Pallas kernels run in interpret
mode; the port's wrappers take the plain torch kernels on CPU tensors.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.models import ScaledPolynomial as JScaledPolynomial
from depth_correction_tpu.train import bind_cellwin_static
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.train import TrainCallbacks
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import make_optimizer as t_make_optimizer
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences
from depth_correction_tpu_torch.train import train as t_train
from depth_correction_tpu_torch.utils.params import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cls):
    cfg = cls()
    cfg.float_type = "float64"
    cfg.train_names = ["ground_plane/4"]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.moments_backend = "cellwin"
    cfg.nn_backend = "scipy"
    return cfg


@pytest.fixture(scope="module")
def prepared():
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    tcfg.device = "cpu"
    jdata = j_prepare_sequences([j_create_dataset(jcfg.train_names[0], jcfg)], jcfg)
    tdata = t_prepare_sequences([t_create_dataset(tcfg.train_names[0], tcfg)], tcfg)
    return jcfg, jdata, tcfg, tdata


def _jax_params(w):
    return {"model": JScaledPolynomial(w=jnp.asarray([w]), exponent=jnp.asarray([4.0]))}


def _port_model(w):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, _jax_params(w)["model"]))


@pytest.fixture(scope="module")
def jax_trajectory(prepared):
    """(loss, grad w, w after the step) of three optax.adam steps from w=0,
    jitted the way the JAX package's train() runs its step."""
    jcfg, jdata, _, _ = prepared
    loss_fn, data = bind_cellwin_static(j_make_loss_fn(jcfg), jdata)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    params = _jax_params(0.0)
    tx = optax.adam(jcfg.lr)
    state = tx.init(params)
    out = []
    for _ in range(3):
        value, g = grad_fn(params, data)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        out.append((float(value), float(np.asarray(g["model"].w)[0]),
                    float(np.asarray(params["model"].w)[0])))
    return out


def test_both_build_the_same_cellwin_graph(prepared):
    _, jdata, _, tdata = prepared
    jg, tg = jdata.cellwin[0], tdata.cellwin[0]
    assert jg is not None and tg is not None
    np.testing.assert_array_equal(tg.row_map.numpy(), np.asarray(jg.row_map))
    np.testing.assert_array_equal(tg.perm.numpy(), np.asarray(jg.perm))
    np.testing.assert_array_equal(tg.q_est.numpy(), np.asarray(jg.q_est))
    assert tg.n_exc == jg.n_exc


def test_loss_and_gradient_at_w0_match_jax(prepared, jax_trajectory):
    _, _, tcfg, tdata = prepared
    model = _port_model(0.0)
    value = t_make_loss_fn(tcfg)(model, tdata)
    value.backward()
    jv, jg, _ = jax_trajectory[0]
    np.testing.assert_allclose(float(value.detach()), jv, rtol=1e-9)
    np.testing.assert_allclose(float(model.w.grad[0]), jg, rtol=1e-9)


@pytest.fixture(scope="module")
def prepared_grid():
    """Both packages prepared with ``nn_backend = "grid"`` (the bench's
    establishment: the grid search for every scan and the global cloud)."""
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    jcfg.nn_backend = tcfg.nn_backend = "grid"
    tcfg.device = "cpu"
    jdata = j_prepare_sequences([j_create_dataset(jcfg.train_names[0], jcfg)], jcfg)
    tdata = t_prepare_sequences([t_create_dataset(tcfg.train_names[0], tcfg)], tcfg)
    return jcfg, jdata, tcfg, tdata


def test_grid_prep_matches_jax(prepared_grid):
    """The grid-established prep: the same neighbour tables and cellwin
    graph as the JAX prep's, and the loss and gradient at w = 0 within
    rtol 1e-9."""
    jcfg, jdata, tcfg, tdata = prepared_grid
    np.testing.assert_array_equal(tdata.neighbors[0].numpy(), np.asarray(jdata.neighbors[0]))
    np.testing.assert_array_equal(tdata.query_rows[0].numpy(), np.asarray(jdata.query_rows[0]))
    jg, tg = jdata.cellwin[0], tdata.cellwin[0]
    assert jg is not None and tg is not None and tg.n_exc == jg.n_exc
    for name in ("row_map", "perm", "q_est", "est_sorted"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    # inv: equal on the valid points; the port gives the invalid (padding)
    # points -1, a zero gradient, where the JAX package leaves 0.
    t_inv, j_inv = tg.inv.numpy(), np.asarray(jg.inv)
    placed = t_inv >= 0
    np.testing.assert_array_equal(placed, tdata.batches[0].cloud.valid.reshape(-1).numpy())
    np.testing.assert_array_equal(t_inv[placed], j_inv[placed])
    assert (t_inv[~placed] == -1).all() and (j_inv[~placed] == 0).all() and (~placed).any()
    loss_fn, data = bind_cellwin_static(j_make_loss_fn(jcfg), jdata)
    jv, jgrad = jax.value_and_grad(loss_fn)(_jax_params(0.0), data)
    model = _port_model(0.0)
    value = t_make_loss_fn(tcfg)(model, tdata)
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(jv), rtol=1e-9)
    np.testing.assert_allclose(float(model.w.grad[0]), float(np.asarray(jgrad["model"].w)[0]),
                               rtol=1e-9)


def test_plain_flag_matches_wrappers_on_cpu(prepared):
    _, _, tcfg, tdata = prepared
    model = _port_model(-1e-3)
    with torch.no_grad():
        a = float(t_make_loss_fn(tcfg)(model, tdata))
        b = float(t_make_loss_fn(tcfg, plain=True)(model, tdata))
    assert a == b


def test_three_adam_steps_match_optax(prepared, jax_trajectory):
    """train()'s loop (fit) with torch.optim.Adam against optax.adam from
    the same w=0: the loss and gradient of every step and w after it."""
    _, _, _, tdata = prepared
    cfg = _cfg(TConfig)
    cfg.device = "cpu"
    cfg.n_opt_iters = 3

    class Record(TrainCallbacks):
        def __init__(self):
            super().__init__(cfg)
            self.grads = []

        def train_loss(self, it, model, pose_deltas, loss):
            self.grads.append(float(model.w.grad[0]))

    rec = Record()
    model, history = t_fit(cfg, tdata, callbacks=rec)
    assert [h[0] for h in history] == [0, 1, 2]
    np.testing.assert_allclose([h[1] for h in history], [t[0] for t in jax_trajectory],
                               rtol=1e-9)
    np.testing.assert_allclose(rec.grads, [t[1] for t in jax_trajectory], rtol=1e-9)
    np.testing.assert_allclose(float(model.w.detach()[0]), jax_trajectory[-1][2], rtol=1e-8)

    # The same three steps through make_optimizer directly.
    ref = _port_model(0.0)
    opt = t_make_optimizer(cfg, [ref.w])
    loss_fn = t_make_loss_fn(cfg)
    tw = []
    for _ in range(3):
        opt.zero_grad()
        loss_fn(ref, tdata).backward()
        opt.step()
        tw.append(float(ref.w.detach()[0]))
    np.testing.assert_allclose(tw, [t[2] for t in jax_trajectory], rtol=1e-8)


@pytest.mark.parametrize(
    "option,value,name",
    [
        ("mesh_shape", {"data": 2}, "mesh_shape"),
        ("optimizer", "rmsprop", "optimizer"),
    ],
)
def test_options_outside_the_slice_raise(option, value, name):
    """An option the run cannot take raises naming itself: an optimizer
    the port does not have (NotImplementedError), and mesh_shape without a
    process group to run it on (ValueError; multi-GPU is ported,
    tests/test_torch_parallel.py)."""
    cfg = _cfg(TConfig)
    setattr(cfg, option, value)
    expected = ValueError if option == "mesh_shape" else NotImplementedError
    with pytest.raises(expected, match=name):
        t_train(cfg)


@pytest.mark.parametrize(
    "option,value",
    [
        ("loss_offset", True),
        ("nn_scale", 0.1),
        ("loss", "icp_loss"),
        ("optimizer", "lbfgs"),
        ("checkpoint_period", 5),
        ("nn_backend", "native"),
        ("nn_type", "plane"),
    ],
)
def test_ported_options_pass_check_slice(option, value):
    """Options the port takes since the loss offset, nn_scale, ICP, L-BFGS,
    checkpoints, the native KD-tree and plane neighbourhoods were ported
    (tests/test_torch_icp.py, test_torch_offset.py, test_torch_lbfgs.py,
    test_torch_resume.py, test_torch_native.py,
    test_torch_segmentation.py)."""
    from depth_correction_tpu_torch.train import check_slice

    cfg = _cfg(TConfig)
    setattr(cfg, option, value)
    check_slice(cfg)


def test_port_imports_no_jax():
    from depth_correction_tpu_torch.studies import STUDIES

    code = ("import sys; import depth_correction_tpu_torch, "
            "depth_correction_tpu_torch.train, depth_correction_tpu_torch.ops._kernels, "
            "depth_correction_tpu_torch.node, depth_correction_tpu_torch.ops.slabwin, "
            "depth_correction_tpu_torch.ops.knn, depth_correction_tpu_torch.ops.grid_hash, "
            "depth_correction_tpu_torch.ops.prng, depth_correction_tpu_torch.ops.cellwin_knockout, "
            "depth_correction_tpu_torch.ops.moment_dot, depth_correction_tpu_torch.ops.moment_window, "
            "depth_correction_tpu_torch.scripts.exp_cellwin_knockout, "
            "depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe, "
            "depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe2, "
            "depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe3, "
            "depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe4, "
            "depth_correction_tpu_torch.scripts.exp_mosaic_probe, "
            "depth_correction_tpu_torch.scripts.exp_pallas_gather2, "
            "depth_correction_tpu_torch.ops.layout_probe, "
            "depth_correction_tpu_torch.ops.gather_probe, "
            "depth_correction_tpu_torch.ops.gather_sum, "
            "depth_correction_tpu_torch.ops.filters, depth_correction_tpu_torch.preproc, "
            "depth_correction_tpu_torch.models, depth_correction_tpu_torch.utils.params, "
            "depth_correction_tpu_torch.datasets, depth_correction_tpu_torch.datasets.asl_laser, "
            "depth_correction_tpu_torch.scripts.exp_pallas_gather, "
            "depth_correction_tpu_torch.scripts.knn_cull, "
            "depth_correction_tpu_torch.scripts.slab_cull, "
            "depth_correction_tpu_torch.scripts.exp_window_variants, "
            "depth_correction_tpu_torch.scripts.exp_transpose_variants, "
            "depth_correction_tpu_torch.scripts.exp_profile_teardown, "
            "depth_correction_tpu_torch.eval, depth_correction_tpu_torch.train_and_eval, "
            "depth_correction_tpu_torch.parallel, depth_correction_tpu_torch.parallel.sharding, "
            "depth_correction_tpu_torch.parallel.cellwin_shard, "
            "depth_correction_tpu_torch.parallel.collectives, "
            "depth_correction_tpu_torch.parallel.dryrun, "
            "depth_correction_tpu_torch.utils.checkpoint, depth_correction_tpu_torch.utils.io, "
            "depth_correction_tpu_torch.datasets.wrappers, "
            "depth_correction_tpu_torch.loss, depth_correction_tpu_torch.optim, "
            "depth_correction_tpu_torch.utils.trace, "
            "depth_correction_tpu_torch.utils.prep_cache, "
            "depth_correction_tpu_torch.segmentation, depth_correction_tpu_torch.ops.covs, "
            "depth_correction_tpu_torch.ops.raycast, depth_correction_tpu_torch.utils.native, "
            "depth_correction_tpu_torch.utils.ply, depth_correction_tpu_torch.utils.pcd, "
            "depth_correction_tpu_torch.utils.mesh, depth_correction_tpu_torch.datasets.mesh, "
            "depth_correction_tpu_torch.datasets.rendered_mesh, "
            "depth_correction_tpu_torch.datasets.semantic_kitti, "
            "depth_correction_tpu_torch.datasets.kitti360, "
            "depth_correction_tpu_torch.datasets.newer_college, "
            "depth_correction_tpu_torch.datasets.fee_corridor, "
            "depth_correction_tpu_torch.metrics, depth_correction_tpu_torch.slam_eval, "
            "depth_correction_tpu_torch.slam_norlab, depth_correction_tpu_torch.reconstruction, "
            "depth_correction_tpu_torch.ops.range_image, depth_correction_tpu_torch.results, "
            "depth_correction_tpu_torch.main, depth_correction_tpu_torch.sensor, "
            "depth_correction_tpu_torch.depth_bias, depth_correction_tpu_torch.visualization, "
            "depth_correction_tpu_torch.loss_landscape, depth_correction_tpu_torch.experiments, "
            "depth_correction_tpu_torch.studies, "
            + "".join("depth_correction_tpu_torch.studies.%s, " % m for m in STUDIES)[:-2]
            + "; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'optax' not in sys.modules and 'orbax' not in sys.modules, "
            "'optax or orbax imported'; "
            "assert not any(m == 'depth_correction_tpu' or m.startswith('depth_correction_tpu.') "
            "for m in sys.modules), 'JAX package imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
    pkg = os.path.join(REPO, "depth_correction_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                for mod in ("jax", "optax", "orbax"):
                    assert "import %s" % mod not in text, (name, mod)


def test_config_device_is_explicit(monkeypatch):
    """Without a card the default device ("cuda") raises and names the
    setting that asks for the CPU; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match='cfg.device = "cpu"'):
            TConfig(device=device).torch_device()
    assert TConfig(device="cpu").torch_device() == torch.device("cpu")
    cfg = TConfig()
    cfg.device = "cpu"
    assert cfg.torch_device().type == "cpu"
