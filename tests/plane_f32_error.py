"""Float32 error of the plane-mode features and loss at full width, in both
packages, and where it comes from.

Run on the CPU (it takes about a minute and 2 GB):

    JAX_PLATFORMS=cpu python tests/plane_f32_error.py

Prepares the bench slice's scene (``open_box/n_6_size_20_20_5_height_1_
density_400``, 390,144 padded points, 6 scans) in plane mode with the
port (``bench_config`` with ``nn_type = 'plane'``), then computes the
planes' covariances, eigenvalues and the loss at w = 0 on the same global
cloud and the same planes:

- with the port in float32 (its eigenvalues solved in float64, as
  ``ops/eigh3`` does) and in float64;
- with the JAX package's ``plane_neighborhood_features`` (jitted) in
  float32, once with ``jax_enable_x64`` off (as a TPU float32 run) and once
  on, and in float64;
- with the trigonometric solver itself run in float32 (the JAX package's
  and the port's formula) on the port's float32 covariances.

It prints each variant's loss error against the port's float64 loss, each
plane's smallest-eigenvalue error, and q = tr/3, p and r of the solver on
the largest plane, as one JSON object.
"""
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from depth_correction_tpu import loss as jloss  # noqa: E402
from depth_correction_tpu import segmentation as jseg  # noqa: E402
from depth_correction_tpu.cloud import Cloud as JCloud  # noqa: E402
from depth_correction_tpu.models import ScaledPolynomial as JScaledPolynomial  # noqa: E402
from depth_correction_tpu_torch import segmentation as tseg  # noqa: E402
from depth_correction_tpu_torch.datasets import create_dataset  # noqa: E402
from depth_correction_tpu_torch.models import load_model  # noqa: E402
from depth_correction_tpu_torch.preproc import global_cloud  # noqa: E402
from depth_correction_tpu_torch.scripts import bench_config  # noqa: E402
from depth_correction_tpu_torch.train import make_loss_fn, prepare_sequences  # noqa: E402

# The port's module (``ops.eigh3`` the attribute is the function).
teigh3 = importlib.import_module("depth_correction_tpu_torch.ops.eigh3")


def jax_features(gcloud, planes, dtype):
    """The JAX package's plane features at w = 0 on the port's global cloud
    and planes, jitted: (cov, eigvals, loss) as numpy, and their dtypes."""
    jc = JCloud(vps=jnp.asarray(gcloud.vps.numpy(), dtype),
                dirs=jnp.asarray(gcloud.dirs.numpy(), dtype),
                depth=jnp.asarray(gcloud.depth.numpy(), dtype),
                valid=jnp.asarray(gcloud.valid.numpy()))
    jp = jseg.Planes(params=jnp.asarray(planes.params.numpy()),
                     member_idx=jnp.asarray(planes.member_idx.numpy()),
                     member_weights=jnp.asarray(planes.member_weights.numpy()),
                     valid=jnp.asarray(planes.valid.numpy()))
    model = JScaledPolynomial(w=jnp.asarray([0.0], dtype), exponent=jnp.asarray([4.0], dtype))

    @jax.jit
    def f(jc, jp, model):
        feat = jseg.plane_neighborhood_features(jc, jp, model, None)
        loss = jloss.min_eigval_loss(feat, mask=feat.valid, normalization=True)[0]
        return feat.cov, feat.eigvals, loss

    cov, eigvals, loss = f(jc, jp, model)
    return {"cov": np.asarray(cov), "eigvals": np.asarray(eigvals), "loss": float(loss),
            "dtypes": [str(cov.dtype), str(eigvals.dtype)]}


def components(cov: np.ndarray):
    return [cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2],
            cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2]]


def solver_terms(cov: np.ndarray, dtype) -> dict:
    """q, p and r of the trigonometric solver (ops/eigh3._eigvals3_core) and
    its three eigenvalues, evaluated in ``dtype``."""
    a00, a11, a22, a01, a02, a12 = (torch.as_tensor(c, dtype=dtype) for c in components(cov))
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22
                    + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0)
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    r = det / (2.0 * p * p * p)
    lams = teigh3._eigvals3_core(a00, a11, a22, a01, a02, a12)
    return {"q": q.numpy(), "p": p.numpy(), "r": r.numpy(),
            "eigvals": torch.stack(lams, -1).numpy()}


def loss_of(eigvals: np.ndarray) -> float:
    """The normalised min-eigenvalue loss over all (valid) planes."""
    e = np.asarray(eigvals, np.float64)
    return float(np.mean(e[:, 0] / np.maximum(e.sum(1), 1e-6)))


def main():
    cfg = bench_config("cpu", 1)
    cfg.nn_type = "plane"
    t0 = time.perf_counter()
    data = prepare_sequences([create_dataset(cfg.train_names[0], cfg)], cfg)
    prep_s = time.perf_counter() - t0
    planes = data.neighbors[0]
    data64 = data.to(dtype=torch.float64)
    g32, g64 = global_cloud(data.batches[0]), global_cloud(data64.batches[0])
    with torch.no_grad():
        port32 = float(make_loss_fn(cfg)(load_model(cfg=cfg), data))
        port64 = float(make_loss_fn(cfg)(load_model(cfg=cfg, dtype=torch.float64), data64))
        f32 = tseg.plane_neighborhood_features(g32, planes, load_model(cfg=cfg))
        f64 = tseg.plane_neighborhood_features(g64, planes.to(dtype=torch.float64),
                                               load_model(cfg=cfg, dtype=torch.float64))
    cov32, cov64 = f32.cov.numpy(), f64.cov.numpy()
    jax64 = jax_features(g64, planes.to(dtype=torch.float64), jnp.float64)
    jax32_on = jax_features(g32, planes, jnp.float32)
    with jax.enable_x64(False):
        jax32_off = jax_features(g32, planes, jnp.float32)
    trig32 = solver_terms(cov32, torch.float32)
    trig64 = solver_terms(cov64, torch.float64)

    lam64 = f64.eigvals.numpy()[:, 0]
    members = (planes.member_idx >= 0).sum(1).numpy()
    big = int(members.argmax())

    def lam_rel(eigvals):
        return ((np.asarray(eigvals[:, 0], np.float64) - lam64) / lam64).tolist()

    def rel(x):
        return abs(x - port64) / abs(port64)

    out = {
        "scene": cfg.train_names[0], "points": int(data.batches[0].cloud.depth.numel()),
        "planes": len(planes), "members": members.tolist(), "prep_s": prep_s,
        "loss_f64": port64,
        "loss_rel": {
            "port_f32": rel(port32),
            "port_f32_cov_f32_solver": rel(loss_of(trig32["eigvals"])),
            "jax_f32_x64_off": rel(jax32_off["loss"]),
            "jax_f32_x64_on": rel(jax32_on["loss"]),
            "jax_f64": rel(jax64["loss"])},
        "jax_dtypes_cov_eigvals": {"f32_x64_off": jax32_off["dtypes"],
                                   "f32_x64_on": jax32_on["dtypes"], "f64": jax64["dtypes"]},
        "lam1_f64": lam64.tolist(),
        "lam1_rel": {
            "port_f32": lam_rel(f32.eigvals.numpy()),
            "port_f32_cov_f32_solver": lam_rel(trig32["eigvals"]),
            "jax_f32_x64_off": lam_rel(jax32_off["eigvals"]),
            "jax_f32_cov_f64_solver": lam_rel(
                teigh3.eigvals3(torch.tensor(jax32_off["cov"], dtype=torch.float64)).numpy())},
        "cov_f32_max_rel": {
            "port": float(np.abs(cov32 - cov64).max() / np.abs(cov64).max()),
            "jax_x64_off": float(np.abs(jax32_off["cov"] - cov64).max() / np.abs(cov64).max())},
        "largest_plane": {
            "index": big, "members": int(members[big]),
            "f32_solver_on_port_f32_cov": {k: np.asarray(v)[big].tolist()
                                           for k, v in trig32.items()},
            "f64": {k: np.asarray(v)[big].tolist() for k, v in trig64.items()},
            "ulp_q_f32": float(np.spacing(np.float32(trig32["q"][big])))},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
