"""The port against the JAX package where it used to differ: fit's
``profile_dir`` trace, Adam's ``eps_root`` and ``nesterov`` against
``optax.adam``, the optimizer options the port does not take, and the
dataset wrappers' docstring. Then the cell-window path's invalid points:
they get no gradient, so its pose-delta gradient is the gather path's on
the same uncapped graph (the reference semantics), while the loss and the
model's gradient stay as they were.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu_torch import models as tmodels
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset, wrappers
from depth_correction_tpu_torch.ops import features
from depth_correction_tpu_torch.optim import Adam
from depth_correction_tpu_torch.train import (fit, make_loss_fn, make_optimizer,
                                              prepare_sequences)


def _rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2 + (x[2] - x[1]) ** 4


@pytest.mark.parametrize("kw", [{"eps_root": 1e-6}, {"nesterov": True},
                                {"eps_root": 1e-3, "nesterov": True, "b1": 0.8, "b2": 0.99}])
def test_adam_follows_optax(kw):
    """Six steps of the port's Adam (as make_optimizer builds it from
    optimizer_kwargs) follow optax.adam within 1e-12 in float64."""
    x0 = np.array([-1.2, 1.0, 0.3])
    opts = dict(kw)
    b1, b2 = opts.pop("b1", 0.9), opts.pop("b2", 0.999)
    tx = optax.adam(1e-2, b1=b1, b2=b2, **opts)
    p = jnp.asarray(x0)
    state = tx.init(p)
    cfg = TConfig()
    cfg.lr = 1e-2
    cfg.optimizer_kwargs = dict(opts, betas=(b1, b2))
    t = torch.tensor(x0, requires_grad=True)
    opt = make_optimizer(cfg, [t])
    assert isinstance(opt, Adam)
    for _ in range(6):
        updates, state = tx.update(jax.grad(_rosenbrock)(p), state, p)
        p = optax.apply_updates(p, updates)
        opt.zero_grad()
        _rosenbrock(t).backward()
        opt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(p), rtol=1e-12, atol=0)


def test_default_adam_stays_torch():
    cfg = TConfig()
    opt = make_optimizer(cfg, [torch.zeros(2, requires_grad=True)])
    assert type(opt) is torch.optim.Adam


@pytest.mark.parametrize("optimizer,option", [("adam", "mu_dtype"),
                                              ("sgd", "accumulator_dtype")])
def test_unported_optimizer_options_raise_by_name(optimizer, option):
    cfg = TConfig()
    cfg.optimizer = optimizer
    cfg.optimizer_kwargs = {option: "float32"}
    with pytest.raises(NotImplementedError, match=option):
        make_optimizer(cfg, [torch.zeros(2, requires_grad=True)])


def test_fit_writes_a_trace_into_profile_dir(tmp_path):
    """With profile_dir, fit traces iterations 2 to min(6, n_opt_iters - 1)
    with torch.profiler (the JAX package's window) and writes a Chrome
    trace there, with the program's spans, and the device-idle seconds by
    span beside it (none on the CPU)."""
    cfg = TConfig()
    cfg.device = "cpu"
    cfg.float_type = "float64"
    cfg.train_names = ["ground_plane/3"]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_max_neighbors = 16
    cfg.n_opt_iters = 4
    cfg.profile_dir = str(tmp_path / "trace")
    data = prepare_sequences([create_dataset(cfg.train_names[0], cfg)], cfg)
    _, history = fit(cfg, data)
    assert len(history) == 4
    files = sorted(os.listdir(cfg.profile_dir))
    assert files == ["idle_by_span_it002-003.json", "trace_it002-003.json"], files
    with open(os.path.join(cfg.profile_dir, files[1])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    names = {e.get("name") for e in events}
    assert {"fit.step", "step.forward", "step.backward", "step.optim", "copy.d2h"} <= names
    with open(os.path.join(cfg.profile_dir, files[0])) as f:
        assert json.load(f) == {}


def test_wrappers_docstring_names_the_pose_wrappers():
    doc = wrappers.__doc__
    assert "not ported" not in doc
    assert "NoisyPoseDataset" in doc and "OverridePosesDataset" in doc


# ---------------------------------------------------------------------------
# Invalid points on the cell-window path (ground_plane/3 in pose mode).

_CELLWIN = {"moments_backend": "cellwin", "cellwin_row_cap": 32, "cellwin_pt_cap": 32,
            "cellwin_eps_rel": 1e-3, "cellwin_max_exc_frac": 0.5}


def _pose_cfg(**kw):
    cfg = TConfig()
    cfg.device = "cpu"
    cfg.float_type = "float64"
    cfg.train_names = ["ground_plane/3"]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "grid"
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.model_kwargs = {"w": [-1e-3], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.pose_correction = "pose"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _old_backward(ctx, g):
    """PermuteRows' backward before the repair: an invalid point read the
    gradient of the first padded slot."""
    (inv,) = ctx.saved_tensors
    return g.index_select(0, inv.clamp(min=0)), None, None


def _value_and_grads(cfg, data):
    """(loss, w gradient, delta gradients) at seeded deltas."""
    model = tmodels.load_model(cfg=cfg)
    rng = np.random.default_rng(7)
    leaves = tuple(torch.tensor(rng.normal(scale=1e-3, size=(b.num_scans, 6)),
                                requires_grad=True) for b in data.batches)
    value = make_loss_fn(cfg)(model, data, leaves)
    value.backward()
    return (float(value.detach()), model.w.grad.numpy().copy(),
            [d.grad.numpy().copy() for d in leaves])


@pytest.fixture(scope="module")
def pose_graphs():
    """The same scans prepared on the cell-window graph and on the uncapped
    gather graph."""
    out = {}
    for name, kw in (("cellwin", _CELLWIN), ("gather", {"moments_backend": "gather"})):
        cfg = _pose_cfg(**kw)
        data = prepare_sequences([create_dataset(cfg.train_names[0], cfg)], cfg)
        assert (data.cellwin is not None and data.cellwin[0] is not None) == (name == "cellwin")
        out[name] = (cfg, data)
    return out


def test_cellwin_invalid_points_get_zero_gradient(pose_graphs, monkeypatch):
    """The points the graph leaves out (inv -1: the scans' padding) receive
    an exactly zero gradient through permute_rows; the others do not."""
    cfg, data = pose_graphs["cellwin"]
    inv = data.cellwin[0].inv
    assert (inv < 0).any() and (inv >= 0).any()
    grads = []
    permute = features.permute_rows

    def hooked(x, perm, inv):
        x.register_hook(lambda g: grads.append((g.detach().clone(), inv)))
        return permute(x, perm, inv)

    monkeypatch.setattr(features, "permute_rows", hooked)
    _value_and_grads(cfg, data)
    assert len(grads) == 1
    g, inv = grads[0]
    assert not g[inv < 0].any()
    assert g[inv >= 0].abs().sum(1).gt(0).float().mean() > 0.5


def test_cellwin_pose_gradient_equals_gather_path(pose_graphs):
    """The cell-window path's loss, w gradient and pose-delta gradients
    equal the gather path's on the same uncapped within-r graph (rtol
    1e-9, float64)."""
    cw = _value_and_grads(*pose_graphs["cellwin"])
    ga = _value_and_grads(*pose_graphs["gather"])
    np.testing.assert_allclose(cw[0], ga[0], rtol=1e-9)
    np.testing.assert_allclose(cw[1], ga[1], rtol=1e-9)
    assert len(cw[2]) == len(ga[2]) == 1
    np.testing.assert_allclose(cw[2][0], ga[2][0], rtol=1e-9)


def test_cellwin_loss_and_w_gradient_unchanged_by_repair(pose_graphs, monkeypatch):
    """The loss and the model's gradient are the values the backward gave
    before the repair (a padding point's correction has no w dependence);
    only the delta gradients move."""
    cfg, data = pose_graphs["cellwin"]
    new = _value_and_grads(cfg, data)
    monkeypatch.setattr(features.PermuteRows, "backward", staticmethod(_old_backward))
    old = _value_and_grads(cfg, data)
    assert new[0] == old[0]
    np.testing.assert_allclose(new[1], old[1], rtol=1e-12, atol=0)
    assert not np.allclose(new[2][0], old[2][0], rtol=1e-6, atol=0)
