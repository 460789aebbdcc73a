"""The ``train_demo`` study's main against the JAX script's, float64 on the
CPU: the callbacks' history within 1e-8, the files it writes; and
``optimization_pair_of_scans`` against the JAX script's step (1e-9 for a
loss, 1e-8 for the trajectory).
"""
import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu.models import ScaledPolynomial as JSP
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare
from torch_studies_common import small_chunks  # noqa: F401


def test_train_demo_follows_jax(tmp_path, monkeypatch, capsys, small_chunks):
    """Both scripts' main for 3 iterations: the callbacks' history (loss,
    weight error, cloud L2 to the clean cloud) within 1e-8, and the files."""
    import train_demo as jtd

    from depth_correction_tpu_torch.studies import train_demo as ttd

    seen = {}

    class Rec(jtd.DemoCallbacks):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["jax"] = self

    monkeypatch.setattr(jtd, "DemoCallbacks", Rec)
    # No TensorBoard writer in either train() (its import loads TensorFlow,
    # tens of seconds here); the CSV history is the compared channel.
    board = types.ModuleType("torch.utils.tensorboard")

    def no_writer(log_dir):
        raise RuntimeError("no TensorBoard in this test")

    board.SummaryWriter = no_writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", board)
    argv = ["--dataset", "ground_plane/3", "--iters", "3"]
    monkeypatch.setattr(sys, "argv", ["train_demo.py"] + argv + ["--log-dir",
                                                                 str(tmp_path / "jax")])
    jtd.main()
    callbacks, model = ttd.main(argv + ["--log-dir", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    got, want = np.asarray(callbacks.history), np.asarray(seen["jax"].history)
    assert got.shape == want.shape == (3, 5)
    np.testing.assert_allclose(got[0, 1], want[0, 1], rtol=1e-9)
    np.testing.assert_allclose(got, want, rtol=1e-8, equal_nan=True)
    for name in ("demo_history.csv", "train_demo.png", "best.yaml"):
        assert os.path.exists(tmp_path / "port" / name), name
    assert "recovered: ScaledPolynomial" in out and "weight error: start" in out


def test_optimization_pair_of_scans_follows_jax(small_chunks):
    """Three ICP steps on pair (0, 1) with pair (3, 4) held out: the train
    and validation losses and w against the JAX script's jitted step."""
    import optimization_pair_of_scans as jops

    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.studies import optimization_pair_of_scans as tops

    tcfg = tops.make_cfg("ground_plane/6", "cpu", "float64")
    tcfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    scans = [(s, np.asarray(p)) for s, p in create_dataset("ground_plane/6", tcfg)]
    train, dist = tops.pair_data(scans, 0, tcfg)
    val, _ = tops.pair_data(scans, 3, tcfg)
    model, hist = tops.optimize(tcfg, train, val, 3)

    jcfg = jops.make_cfg("ground_plane/6")
    jcfg.float_type = "float64"
    jtrain = j_prepare([scans[0:2]], jcfg)
    jval = j_prepare([scans[3:5]], jcfg)
    loss_fn = j_make_loss_fn(jcfg)
    params = {"model": JSP(w=jnp.zeros(1), exponent=jnp.asarray([4.0]))}
    tx = optax.adam(jcfg.lr)
    state = tx.init(params)
    want = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(loss_fn)(params, jtrain)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        want.append((float(loss), float(loss_fn(params, jval))))
    got = np.asarray(hist)[:, 1:]
    np.testing.assert_allclose(got[0, 0], want[0][0], rtol=1e-9)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8)
    np.testing.assert_allclose(float(model.w.detach()[0]), float(params["model"].w[0]), rtol=1e-8)
    assert dist == pytest.approx(float(np.linalg.norm(scans[0][1][:3, 3] - scans[1][1][:3, 3])))
