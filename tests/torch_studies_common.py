"""Shared parts of the study parity tests (tests/test_torch_studies*.py):
the JAX package's ``scripts/`` on ``sys.path`` (as
tests/test_alignment_bias.py puts it there), the JAX brute search's query
padding, thinned scenes, and the JAX scripts' jitted optax step.
"""
import os
import sys

import numpy as np
import pytest

import jax
import optax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts"))

EXAMPLE_SCENE = "open_box/n_2_size_4_4_2_height_1_density_40"


@pytest.fixture
def small_chunks(monkeypatch):
    """The JAX brute search's 8192-row query padding at 1024 rows (its CPU
    top_k otherwise takes most of the time; no result depends on it)."""
    from depth_correction_tpu.ops import knn as jknn

    monkeypatch.setattr(jknn, "_QUERY_CHUNK", 1024)


def thinned(scans, r: float):
    """Each scan thinned until every point has at least 4 others within
    ``r``: a sparser neighbourhood's normal, and so the model's gradient,
    is decided by rounding in either package (ROADMAP, standing cautions)."""
    from scipy.spatial import cKDTree

    out = []
    for scan, pose in scans:
        while True:
            p = np.c_[scan["x"], scan["y"], scan["z"]]
            counts = np.array([len(b) for b in cKDTree(p).query_ball_point(p, r)])
            if counts.min() >= 5:
                break
            scan = scan[counts >= 5]
        out.append((scan, np.asarray(pose)))
    return out


def jax_adam(loss_fn, params, data, lr, steps, mask=None):
    """The JAX scripts' jitted step (value_and_grad, optax.adam): the loss
    at each step's start and the final params."""
    tx = optax.adam(lr)
    state = tx.init(params)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(loss_fn)(params, data)
        if mask is not None:
            grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, mask)
        updates, state = tx.update(grads, state, params)
        return loss, optax.apply_updates(params, updates), state

    losses = []
    for _ in range(steps):
        loss, params, state = step(params, state)
        losses.append(float(loss))
    return losses, params


def jax_cfg_like(tcfg, keys):
    from depth_correction_tpu.config import Config as JConfig

    jcfg = JConfig()
    for k in keys:
        setattr(jcfg, k, getattr(tcfg, k))
    return jcfg


# The loss and pose mode of each joint-learning study (the JAX scripts'
# model_learning.py patches make_cfg's pose correction to none).
JOINT_STUDIES = {"model_learning": ("icp_loss", "none"),
                 "model_poses_learning": ("trace_loss", "pose"),
                 "model_poses_learning_icp": ("icp_loss", "pose")}


def check_joint_learning_study(study, tmp_path, monkeypatch):
    """A joint-learning study's main for 2 iterations on a small stand-in
    scene, in float64, against experiments.joint_learning of the JAX
    package with the JAX script's make_cfg, on the same inputs (the
    stand-in's scans thinned, every fourth ground-truth map point): the
    probed losses (1e-9 at the start, 1e-8 after), pose L2, map accuracy
    and w."""
    import importlib

    import model_poses_learning as jmpl

    from depth_correction_tpu.experiments import joint_learning as j_joint
    from depth_correction_tpu_torch.studies import model_poses_learning as tmpl

    seen = {}
    stand_in = tmpl.synthetic_inputs

    def inputs(cfg, name):
        datasets, gt_map, gt_xyz = stand_in(cfg, name)
        seen["inputs"] = ([thinned(datasets[0], cfg.nn_r)], gt_map[::4], gt_xyz)
        return seen["inputs"]

    monkeypatch.setattr(tmpl, "synthetic_inputs", inputs)
    loss, pose = JOINT_STUDIES[study]
    mod = importlib.import_module("depth_correction_tpu_torch.studies." + study)
    hist = mod.main(["--iters", "2", "--scene", "open_box/n_3_size_4_4_2_height_1_density_30",
                     "--float-type", "float64", "--out", str(tmp_path), "--device", "cpu"])
    assert os.path.exists(os.path.join(str(tmp_path), "%s_history.csv" % loss))

    jcfg = jmpl.make_cfg(loss)
    jcfg.float_type = "float64"
    jcfg.pose_correction = pose
    jcfg.n_opt_iters = 2
    datasets, gt_map, gt_xyz = seen["inputs"]
    want = j_joint(jcfg, datasets=datasets, gt_map=gt_map, gt_positions=gt_xyz,
                   metrics_every=10)
    assert hist.iters == want.iters == [0, 1]
    np.testing.assert_allclose(hist.train_loss[0], want.train_loss[0], rtol=1e-9)
    np.testing.assert_allclose(hist.train_loss, want.train_loss, rtol=1e-8)
    np.testing.assert_allclose(hist.pose_l2, want.pose_l2, rtol=1e-8)
    np.testing.assert_allclose(hist.map_accuracy, want.map_accuracy, rtol=1e-8)
    np.testing.assert_allclose(hist.params["model"].w.detach().numpy(),
                               np.asarray(want.params["model"].w), rtol=1e-8)
