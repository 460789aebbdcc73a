"""The port against the JAX package where it used to differ: fit's
``profile_dir`` trace, Adam's ``eps_root`` and ``nesterov`` against
``optax.adam``, the optimizer options the port does not take, and the
dataset wrappers' docstring.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset, wrappers
from depth_correction_tpu_torch.optim import Adam
from depth_correction_tpu_torch.train import fit, make_optimizer, prepare_sequences


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
    trace there."""
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
    files = os.listdir(cfg.profile_dir)
    assert files == ["trace_it002-003.json"], files
    with open(os.path.join(cfg.profile_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_wrappers_docstring_names_the_pose_wrappers():
    doc = wrappers.__doc__
    assert "not ported" not in doc
    assert "NoisyPoseDataset" in doc and "OverridePosesDataset" in doc
