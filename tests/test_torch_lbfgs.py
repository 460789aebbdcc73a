"""The port's L-BFGS (optim.LBFGS, a copy of optax 0.2.6's algorithm)
against the JAX package's make_optimizer ("lbfgs": optax.lbfgs with the
zoom line search, or scale_by_lbfgs then lr), float64 on the CPU.

Ten steps on a Rosenbrock function and on a small quadratic over two
leaves, with and without the line search, within 1e-9; then fit() on the
training loss of ground_plane/4 (four steps, both variants) and in pose
mode within 1e-8 of the JAX package's step (its _grad_mask: the frozen
exponent and the first pose stay where they are).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu import models as jmodels
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.train import _grad_mask
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import make_optimizer as j_make_optimizer
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.optim import LBFGS
from depth_correction_tpu_torch.train import TrainCallbacks
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import make_optimizer as t_make_optimizer
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences

SEQ = "ground_plane/4"
STEPS = 10
TRAIN_STEPS = 4
LINE_SEARCH = {"zoom": {}, "lr": {"line_search": False}}


def _rosenbrock(x, y):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2 + 0.0 * y.sum()


def _quadratic(x, y):
    return (0.5 * (x[0] ** 2 + 3.0 * x[1] ** 2) + 0.5 * x[0] * y[0]
            + (y[0] - 1.0) ** 2 + 2.0 * (y[1] + 0.5) ** 2 + 0.1 * y[2] ** 2)


FUNCTIONS = {"rosenbrock": (_rosenbrock, (np.array([-1.2, 1.0]), np.zeros(3)), 0.2),
             "quadratic": (_quadratic, (np.array([1.0, -2.0]), np.array([3.0, 1.0, -1.0])), 0.5)}


def _opt_cfg(cls, lr, **opts):
    cfg = cls()
    cfg.optimizer = "lbfgs"
    cfg.lr = lr
    cfg.optimizer_kwargs = dict(opts)
    return cfg


@pytest.mark.parametrize("ls", list(LINE_SEARCH))
@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_lbfgs_matches_optax(name, ls):
    """Each step's parameters, the loss and the line search's stepsize
    within rtol 1e-9 of the JAX package's optimizer over ten steps."""
    fun, x0, lr = FUNCTIONS[name]
    tx = j_make_optimizer(_opt_cfg(JConfig, lr, **LINE_SEARCH[ls]))

    def jf(p):
        return fun(p[0], p[1])

    @jax.jit
    def step(params, state):
        value, grads = jax.value_and_grad(jf)(params)
        updates, state = tx.update(grads, state, params, value=value, grad=grads, value_fn=jf)
        return value, optax.apply_updates(params, updates), state

    params = tuple(jnp.asarray(a) for a in x0)
    state = tx.init(params)
    jtraj = []
    for _ in range(STEPS):
        value, params, state = step(params, state)
        jtraj.append((float(value), [np.asarray(p) for p in params]))

    leaves = [torch.tensor(a, requires_grad=True) for a in x0]
    opt = t_make_optimizer(_opt_cfg(TConfig, lr, **LINE_SEARCH[ls]), leaves)
    assert isinstance(opt, LBFGS)

    def closure():
        value = fun(*leaves)
        return value.detach(), torch.autograd.grad(value, leaves)

    ttraj = []
    for _ in range(STEPS):
        value, grads = closure()
        for p, g in zip(leaves, grads):
            p.grad = g
        opt.step(value=value, closure=closure)
        ttraj.append((float(value), [p.detach().numpy().copy() for p in leaves]))
    for (tv, tp), (jv, jp) in zip(ttraj, jtraj):
        np.testing.assert_allclose(tv, jv, rtol=1e-9)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-15)
    assert ttraj[-1][0] < ttraj[0][0]
    if ls == "zoom":
        np.testing.assert_allclose(opt.state["learning_rate"],
                                   float(state[2].learning_rate), rtol=1e-9)


def _cfg(cls, **kw):
    """tests/test_loss_offset_lbfgs.py's configuration with L-BFGS."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.train_names = [SEQ]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "scipy"
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.optimizer = "lbfgs"
    cfg.lr = 1e-3
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def prepared():
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    jdata = j_prepare_sequences([j_create_dataset(SEQ, jcfg)], jcfg)
    # The JAX side's gradient by autodiff (its transpose graphs are TPU
    # workarounds the port does not port).
    none = tuple(None for _ in jdata.batches)
    jdata = dataclasses.replace(jdata, t_neighbors=none, t_slots=none)
    tdata = t_prepare_sequences([t_create_dataset(SEQ, tcfg)], tcfg)
    return jdata, tdata


def _jax_steps(jdata, steps, deltas=None, **kw):
    """The JAX package's train step (train.py:1104-1120): the gradients
    masked by _grad_mask, the line search's value_fn the loss. Returns
    the (loss, w, deltas) each step starts from."""
    jcfg = _cfg(JConfig, **kw)
    loss_fn = j_make_loss_fn(jcfg)
    params = {"model": jmodels.load_model(cfg=jcfg)}
    if deltas is not None:
        params["pose_deltas"] = tuple(jnp.asarray(d) for d in deltas)
    tx = j_make_optimizer(jcfg)
    gmask = _grad_mask(params, jcfg)
    state = tx.init(params)

    @jax.jit
    def step(params, state):
        value, grads = jax.value_and_grad(loss_fn)(params, jdata)
        grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, gmask)
        updates, state = tx.update(grads, state, params, value=value, grad=grads,
                                   value_fn=lambda p: loss_fn(p, jdata))
        return value, optax.apply_updates(params, updates), state

    out = []
    for _ in range(steps):
        value, new, state = step(params, state)
        out.append((float(value), np.asarray(params["model"].w),
                    [np.asarray(d) for d in params.get("pose_deltas", ())]))
        params = new
    out.append((None, np.asarray(params["model"].w),
                [np.asarray(d) for d in params.get("pose_deltas", ())]))
    return out


class _Record(TrainCallbacks):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.w, self.exponent, self.deltas = [], [], []

    def train_loss(self, it, model, pose_deltas, loss):
        self.w.append(model.w.detach().numpy().copy())
        self.exponent.append(model.exponent.detach().numpy().copy())
        self.deltas.append([d.detach().numpy().copy() for d in pose_deltas or ()])


def _port_steps(tdata, steps, deltas=None, **kw):
    tcfg = _cfg(TConfig, n_opt_iters=steps, **kw)
    leaves = (None if deltas is None
              else tuple(torch.tensor(d, requires_grad=True) for d in deltas))
    rec = _Record(tcfg)
    model, history = t_fit(tcfg, tdata, callbacks=rec, pose_deltas=leaves)
    rec.w.append(model.w.detach().numpy().copy())
    rec.exponent.append(model.exponent.detach().numpy().copy())
    rec.deltas.append([d.detach().numpy().copy() for d in leaves or ()])
    return history, rec


@pytest.mark.parametrize("ls", list(LINE_SEARCH))
def test_fit_lbfgs_matches_jax(prepared, ls):
    """Four L-BFGS steps of fit() on the training loss: losses and w
    within 1e-8 of the JAX package's step; the exponent stays put."""
    jdata, tdata = prepared
    kw = {"optimizer_kwargs": LINE_SEARCH[ls]}
    jout = _jax_steps(jdata, TRAIN_STEPS, **kw)
    history, rec = _port_steps(tdata, TRAIN_STEPS, **kw)
    np.testing.assert_allclose([h[1] for h in history], [j[0] for j in jout[:-1]], rtol=1e-8)
    np.testing.assert_allclose(np.concatenate(rec.w), np.concatenate([j[1] for j in jout]),
                               rtol=1e-8)
    assert history[-1][1] < history[0][1]
    assert all((e == 4.0).all() for e in rec.exponent)


def test_fit_lbfgs_pose_mode_matches_jax(prepared):
    """L-BFGS with the line search in pose mode from seeded deltas: the
    losses, w and the deltas within 1e-8 of the JAX package's step; the
    first pose's delta stays exactly 0."""
    jdata, tdata = prepared
    s = tdata.batches[0].num_scans
    deltas = [1e-3 * np.random.default_rng(0).standard_normal((s, 6))]
    deltas[0][0] = 0.0
    jout = _jax_steps(jdata, 3, deltas, pose_correction="pose")
    history, rec = _port_steps(tdata, 3, deltas, pose_correction="pose")
    np.testing.assert_allclose([h[1] for h in history], [j[0] for j in jout[:-1]], rtol=1e-8)
    for tw, td, (_, jw, jd) in zip(rec.w, rec.deltas, jout):
        np.testing.assert_allclose(tw, jw, rtol=1e-8)
        np.testing.assert_allclose(td[0], jd[0], rtol=1e-8, atol=1e-15)
        assert not td[0][0].any()
    assert (rec.deltas[-1][0][1:] != deltas[0][1:]).all()
