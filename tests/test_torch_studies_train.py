"""The ``train_at_scale`` study against the JAX package, float64 on the
CPU, at the parity bars of ROADMAP (1e-9 for a loss, 1e-8 for an Adam
trajectory), on both moments engines.

The JAX script hard-codes float32, so the port's study runs in float64
against the JAX library functions called with the study's own settings
(``apply_settings`` on the JAX package's Config; its establishment by
scipy's cKDTree, the same within-r sets, since the JAX grid search
compiles for ~30 s here); the float32 runs of both scripts are compared
on their integer counts in tests/test_torch_studies_scale.py. Scenes are
small and thinned (tests/torch_studies_common.py).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.models import ScaledPolynomial as JSP
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare
from depth_correction_tpu_torch.studies import train_at_scale as tas
from torch_studies_common import jax_adam, small_chunks, thinned  # noqa: F401

SCALE = {"density": 40.0, "size": "4_4_2"}
SCALE_STEPS = 2  # timed, after train_at_scale's 3 warm-up steps


@pytest.fixture(scope="module")
def scale_scans():
    """The study's scene at a small size with 5 mm of depth noise (so no
    planar mask is decided by rounding on an exact plane), thinned, loaded
    once by the port and given to both packages."""
    cfg = tas.scale_config(**SCALE, device="cpu", float_type="float64")
    cfg.depth_noise = 0.005
    return thinned(tas.load_scans(cfg), cfg.nn_r)


@pytest.mark.parametrize("backend", ["gather", "cellwin"])
def test_train_at_scale_follows_jax(scale_scans, backend, small_chunks):
    """Five Adam steps (optax's update) of the study against the JAX
    script's step on the JAX library with the same settings: the loss at
    w = 0 within 1e-9, the trajectory and w within 1e-8. The cell-window
    run is held to the gather moments on the same uncapped graph."""
    from depth_correction_tpu.models import trainable_mask
    from depth_correction_tpu.train import bind_cellwin_static

    tcfg = tas.scale_config(**SCALE, backend=backend, device="cpu", float_type="float64")
    # Tiles and the exception-row limit for a scene this small.
    tcfg.cellwin_row_cap = tcfg.cellwin_pt_cap = 32
    tcfg.cellwin_max_exc_frac = 0.5
    tdata, _ = tas.prepare(tcfg, scale_scans)
    assert tas.engine(tdata)["engine"] == backend
    run = tas.run_steps(tcfg, tdata, steps=SCALE_STEPS)
    assert len(run["losses"]) == tas.WARMUP_STEPS + SCALE_STEPS == len(run["step_ms"]) + 3

    jcfg = tas.apply_settings(JConfig(), **SCALE, backend="gather", float_type="float64")
    jcfg.nn_backend = "scipy"  # the same within-r sets; the JAX grid compiles for ~30 s here
    if backend == "cellwin":
        jcfg.nn_max_neighbors = None
    jdata = j_prepare([scale_scans], jcfg)
    loss_fn, jdata = bind_cellwin_static(j_make_loss_fn(jcfg), jdata)
    params = {"model": JSP(w=jnp.zeros(1), exponent=jnp.asarray([4.0]))}
    losses, params = jax_adam(loss_fn, params, jdata, jcfg.lr, len(run["losses"]),
                               mask={"model": trainable_mask(params["model"])})
    np.testing.assert_allclose(run["losses"][0], losses[0], rtol=1e-9)
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-8)
    np.testing.assert_allclose(run["w"], float(params["model"].w[0]), rtol=1e-8)
    assert run["w"] < 0.0
    c = tas.counts(tdata)
    assert c["global"] == int(np.asarray(jdata.batches[0].cloud.valid).sum())
    if backend == "gather":  # uncapped, K is each search's padded width
        assert c["k"] == int(np.asarray(jdata.neighbors[0]).shape[1]) == 32
