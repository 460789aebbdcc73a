"""The port's training options against the JAX package (float64, CPU):
the bench's capped row (K = 32 with mutual trimming and the gather
moments) on the ASL scene of tests/test_torch_defaults.py seen from eight
viewpoints; the models ``Linear``, ``InvCos`` and ``ScaledInvCos``
(JAX package, models/__init__.py:81, :192, :212), a ``model_state_dict``
file (the JAX package's npz checkpoint), SGD with and without momentum
(train.py:894-895) and ``optimize_model = False`` (train.py:932-933), each
trained from the same prepared data as the JAX package's trajectory: the
default configuration on the ASL scene of tests/test_torch_defaults.py.
Bars (ROADMAP §3.6): loss and gradient rtol 1e-9, trajectories 1e-8.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import depth_correction_tpu.datasets.asl_laser as j_asl
import depth_correction_tpu_torch.datasets.asl_laser as t_asl
from depth_correction_tpu import models as jmodels
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.utils.checkpoint import save_pytree
from depth_correction_tpu_torch import models as tmodels
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.ops import knn as tknn
from depth_correction_tpu_torch.preproc import global_cloud as t_global
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.utils.params import params_from_jax
from test_torch_defaults import (  # noqa: F401  (the fixtures are used by name)
    SEQ8,
    _Record,
    _assert_trajectory,
    _default_cfg,
    _jax_trajectory,
    _prepare,
    _small_query_chunks,
    asl_root,
    data_root,
    prepare_both,
)


def test_capped_step_matches_jax(asl_root, tmp_path):
    """The bench's capped row (bench.py:143-147) on the default config:
    nn_max_neighbors = 32 with nn_symmetrize (the default) and the gather
    moments, on the scene seen from eight viewpoints (most global
    neighbourhoods hold more than 32): the trimmed tables equal the JAX
    package's, and the loss and gradient at w = 0 agree to rtol 1e-9."""
    extra = dict(train_names=["asl_laser/" + SEQ8], nn_max_neighbors=32,
                 moments_backend="gather")
    jcfg, jdata, tcfg, tdata = _prepare(asl_root, tmp_path, **extra)
    assert tdata.cellwin == (None,)
    np.testing.assert_array_equal(tdata.neighbors[0].numpy(), np.asarray(jdata.neighbors[0]))
    np.testing.assert_array_equal(tdata.query_rows[0].numpy(), np.asarray(jdata.query_rows[0]))
    kept = (tdata.neighbors[0] >= 0).sum(1)[tdata.masks[0]]
    assert int(kept.max()) <= 32 and int((kept < 32).sum()) > 0
    uncapped = tknn.neighbor_counts(*(2 * [t_global(tdata.batches[0]).get_points()]), r=0.25)
    assert int((uncapped > 32).sum()) > 0.3 * len(uncapped[uncapped > 0])
    params = {"model": jmodels.load_model(cfg=jcfg)}
    jv, jg = jax.value_and_grad(j_make_loss_fn(jcfg))(params, jdata)
    model = tmodels.load_model(cfg=tcfg)
    value = t_make_loss_fn(tcfg)(model, tdata)
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(jv), rtol=1e-9)
    np.testing.assert_allclose(model.w.grad.numpy(), np.asarray(jg["model"].w), rtol=1e-9)


@pytest.fixture(scope="module")
def box_data(data_root, tmp_path_factory):
    """The default configuration on the four-viewpoint ASL scene, prepared
    by both packages; ``cfg(cls)`` makes either package's Config of it."""
    def cfg(cls):
        return _default_cfg(cls, tmp_path_factory.mktemp("log"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_asl, "data_dir", str(data_root))
        mp.setattr(t_asl, "data_dir", str(data_root))
        mp.setattr(jknn, "_QUERY_CHUNK", 1024)
        jdata, tdata = prepare_both(cfg(JConfig), cfg(TConfig))
    np.testing.assert_array_equal(tdata.neighbors[0].numpy(), np.asarray(jdata.neighbors[0]))
    return cfg, jdata, tdata


MODELS = {
    "Linear": ({"w0": 1.0, "w1": 0.001, "b": 0.0}, ["w0", "w1", "b"]),
    "InvCos": ({"p0": 0.001}, ["p0"]),
    "ScaledInvCos": ({"p0": 0.0005}, ["p0"]),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_models_follow_jax_trajectories(box_data, tmp_path, name):
    cfg, jdata, tdata = box_data
    kwargs, names = MODELS[name]
    jcfg, tcfg = cfg(JConfig), cfg(TConfig)
    for c in (jcfg, tcfg):
        c.model_class, c.model_kwargs, c.n_opt_iters, c.lr = name, dict(kwargs), 3, 1e-3
    tcfg.device = "cpu"
    params = {"model": jmodels.load_model(cfg=jcfg)}
    traj = _jax_trajectory(jcfg, jdata, params, optax.adam(jcfg.lr))
    rec = _Record(tcfg, names)
    model, history = t_fit(tcfg, tdata, callbacks=rec)
    assert type(model).__name__ == name
    _assert_trajectory(history, rec, model, traj, names)
    # The port's model takes the JAX model's weights as they are.
    moved = params_from_jax(jax.tree_util.tree_map(np.asarray, traj[-1][2]))
    for n in names:
        np.testing.assert_array_equal(getattr(moved, n).detach().numpy(),
                                      np.asarray(getattr(traj[-1][2], n)))


def test_model_state_file_loads_like_jax(tmp_path):
    """model_state_dict naming the JAX package's npz checkpoint: both load
    the same weights (and the path may leave out the suffix)."""
    jm = jmodels.ScaledPolynomial(w=jnp.asarray([-0.0015, 0.0007]),
                                  exponent=jnp.asarray([2.0, 4.0]))
    path = str(tmp_path / "model_state_dict.npz")
    save_pytree(path, jm)
    for cls, load, p in ((JConfig, jmodels.load_model, path),
                         (TConfig, tmodels.load_model, path[:-4])):
        c = cls()
        c.float_type, c.model_state_dict = "float64", p
        if cls is TConfig:
            c.device = "cpu"
        m = load(cfg=c)
        np.testing.assert_array_equal(np.asarray(m.w.detach() if cls is TConfig else m.w),
                                      [-0.0015, 0.0007])
    jl = jmodels.Linear(w0=jnp.asarray(0.98), w1=jnp.asarray(0.01), b=jnp.asarray(-0.02))
    save_pytree(str(tmp_path / "linear.npz"), jl)
    tl = tmodels.load_model("Linear", state_dict=str(tmp_path / "linear.npz"),
                            dtype=torch.float64, device="cpu")
    assert (float(tl.w0), float(tl.w1), float(tl.b)) == (0.98, 0.01, -0.02)


@pytest.mark.parametrize("momentum", [None, 0.9])
def test_sgd_follows_optax(box_data, momentum):
    cfg, jdata, tdata = box_data
    jcfg, tcfg = cfg(JConfig), cfg(TConfig)
    for c in (jcfg, tcfg):
        c.optimizer, c.lr, c.n_opt_iters = "sgd", 0.5, 3
        c.model_kwargs = {"w": [0.0], "exponent": [4.0]}
        c.optimizer_kwargs = {} if momentum is None else {"momentum": momentum}
    tcfg.device = "cpu"
    params = {"model": jmodels.load_model(cfg=jcfg)}
    traj = _jax_trajectory(jcfg, jdata, params,
                           optax.sgd(jcfg.lr, **dict(jcfg.optimizer_kwargs)))
    rec = _Record(tcfg, ["w"])
    model, history = t_fit(tcfg, tdata, callbacks=rec)
    _assert_trajectory(history, rec, model, traj, ["w"])
    assert float(model.w.detach()[0]) != 0.0


def test_optimize_model_false_keeps_the_model(box_data):
    """optimize_model = False: the JAX package masks the model's gradients
    to zero, so the loss stays at the loaded model's; the port's gradients
    read zero and its weights do not move."""
    cfg, jdata, tdata = box_data
    jcfg, tcfg = cfg(JConfig), cfg(TConfig)
    for c in (jcfg, tcfg):
        c.optimize_model, c.n_opt_iters = False, 3
        c.model_kwargs = {"w": [-0.001], "exponent": [4.0]}
    tcfg.device = "cpu"
    params = {"model": jmodels.load_model(cfg=jcfg)}
    mask = {"model": jax.tree_util.tree_map(jnp.zeros_like, params["model"])}
    traj = _jax_trajectory(jcfg, jdata, params, optax.adam(jcfg.lr), mask=mask)
    rec = _Record(tcfg, ["w"])
    model, history = t_fit(tcfg, tdata, callbacks=rec)
    _assert_trajectory(history, rec, model, traj, ["w"])
    assert float(model.w.detach()[0]) == -0.001
    assert all(float(g["w"].abs().max()) == 0.0 for g in rec.grads)
