"""The ``optimization`` example and the ``weights_search`` study against
the JAX package's, float64 on the CPU: the example's Adam trajectory
within 1e-8 (1e-9 at its start), the sweep's losses within 1e-9.
"""
import sys

import numpy as np

import jax.numpy as jnp

from depth_correction_tpu.models import ScaledPolynomial as JSP
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare
from torch_studies_common import (EXAMPLE_SCENE, jax_adam, jax_cfg_like,  # noqa: F401
                                   small_chunks, thinned)


def test_example_optimization_follows_jax(small_chunks):
    """Three joint steps of w and every pose delta (none masked, as the
    example has it) against the example's jitted optax step."""
    from depth_correction_tpu.train import init_pose_deltas as j_init
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.studies import optimization as topt
    from depth_correction_tpu_torch.train import prepare_sequences

    tcfg = topt.make_cfg("cpu")
    tcfg.float_type = "float64"
    tcfg.depth_noise = 0.005
    scans = thinned(create_dataset(EXAMPLE_SCENE, tcfg), tcfg.nn_r)
    model, deltas, losses = topt.optimize(tcfg, prepare_sequences([scans], tcfg), 3)

    jcfg = jax_cfg_like(tcfg, ["grid_res", "min_depth", "max_depth", "nn_r", "lr",
                                "vp_dispersion_bounds", "eigenvalue_ratio_bounds",
                                "min_valid_neighbors", "pose_correction", "loss_kwargs",
                                "float_type"])
    jdata = j_prepare([scans], jcfg)
    params = {"model": JSP(w=jnp.zeros(1), exponent=jnp.asarray([4.0])),
              "pose_deltas": j_init(jdata, jcfg)}
    want, params = jax_adam(j_make_loss_fn(jcfg), params, jdata, jcfg.lr, 3)
    np.testing.assert_allclose(losses[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(losses, want, rtol=1e-8)
    np.testing.assert_allclose(float(model.w.detach()[0]), float(params["model"].w[0]), rtol=1e-8)
    for a, b in zip(deltas, params["pose_deltas"]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-8, atol=1e-15)
    assert deltas[0].detach()[0].abs().sum() > 0  # the example moves the first pose too


def test_weights_search_matches_jax(capsys, monkeypatch, small_chunks):
    """Both scripts' main: the sweep's losses at five weights (none at the
    injected one, where the plane's smallest eigenvalue is rounding) within
    1e-9, and the same best weight."""
    import weights_search as jws

    from depth_correction_tpu_torch.studies import weights_search as tws

    seen = {}

    def landscape(cfg, **kw):
        seen["jax"] = jws_landscape(cfg, **kw)
        return seen["jax"]

    jws_landscape = jws.loss_landscape
    monkeypatch.setattr(jws, "loss_landscape", landscape)
    argv = ["--dataset", "ground_plane/3", "--n", "5"]
    monkeypatch.setattr(sys, "argv", ["weights_search.py"] + argv)
    jws.main()
    jout = capsys.readouterr().out
    w, losses = tws.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    np.testing.assert_allclose(w, np.asarray(seen["jax"][0]), rtol=1e-12)
    np.testing.assert_allclose(losses, np.asarray(seen["jax"][1]), rtol=1e-9)
    assert tout.splitlines()[-1] == jout.splitlines()[-1]  # "best w: ..."
