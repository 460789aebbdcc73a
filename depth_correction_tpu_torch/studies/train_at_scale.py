"""Production-scale training demo: a ~850k-point global cloud on one card.

Port of the JAX package's scripts/train_at_scale.py: the points-per-global-
cloud axis end to end, with grid establishment on the device (kernel X2),
the prep's gather moments (P7), no host KD-tree, and the training step on
either moments engine: ``DC_MOMENTS_BACKEND=gather`` (default; K = 32,
capped) or ``cellwin`` (the uncapped within-r graph, kernels K1 and K2;
``nn_max_neighbors`` ignored). If the cell-window build declines, prep
falls back to the gather moments, as in the JAX package; the engine that
ran and the builder's reason are printed.

Usage: python -m depth_correction_tpu_torch.studies.train_at_scale
           [--density D] [--size WxLxH] [--steps N] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import sys
import time

import torch

from . import add_device_arg

WARMUP_STEPS = 3


def apply_settings(cfg, density: float = 300.0, size: str = "32_32_6", backend=None,
                   float_type: str = "float32"):
    """The JAX script's settings (scripts/train_at_scale.py:50-66) on
    ``cfg``, a config of either package; ``backend`` defaults to
    ``$DC_MOMENTS_BACKEND`` or ``gather``."""
    cfg.float_type = float_type
    cfg.nn_backend = "grid"  # on-device establishment, no host KD-tree
    cfg.train_names = ["open_box/n_6_size_%s_height_1_density_%g" % (size, density)]
    cfg.min_depth, cfg.max_depth = 1.0, 40.0
    cfg.grid_res = 0.1
    cfg.nn_r, cfg.nn_k = 0.25, 0
    cfg.nn_max_neighbors = 32
    cfg.min_valid_neighbors = 5
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = [[0, 1, 0, 0.25], [1, 2, 0.25, 1.0]]
    cfg.loss = "min_eigval_loss"
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.lr = 2e-4
    cfg.moments_backend = backend or os.environ.get("DC_MOMENTS_BACKEND", "gather")
    return cfg


def scale_config(density: float = 300.0, size: str = "32_32_6", backend=None,
                 device: str = "cuda", float_type: str = "float32"):
    """The port's :class:`Config` with :func:`apply_settings` on ``device``."""
    from ..config import Config

    cfg = apply_settings(Config(), density, size, backend, float_type)
    cfg.device = device
    return cfg


def load_scans(cfg) -> list:
    """The scene's (scan, pose) pairs, generated once."""
    from ..datasets import create_dataset

    return [(scan, pose) for scan, pose in create_dataset(cfg.train_names[0], cfg)]


def prepare(cfg, scans):
    """``prepare_sequences`` of the scans, the peak device bytes counted
    from its start. Returns (data, seconds)."""
    from ..train import prepare_sequences

    device = cfg.torch_device()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    data = prepare_sequences([scans], cfg)
    return data, time.perf_counter() - t0


def counts(data) -> dict:
    """The JAX script's integer counts: global points, query rows, rows in
    the loss and K."""
    mask = data.masks[0]
    return {"global": int(data.batches[0].cloud.valid.sum()), "query": int(mask.numel()),
            "loss": int(mask.sum()), "k": int(data.neighbors[0].shape[1])}


def engine(data) -> dict:
    """The moments engine the step runs, the cell-window builder's note
    when it declined, and the exception-row share (built: the graph's;
    declined: the one the note gives, or None)."""
    cw = data.cellwin[0] if data.cellwin else None
    note = data.cellwin_notes[0] if data.cellwin_notes else None
    if cw is not None:
        rows = int((cw.row_map >= 0).sum())
        return {"engine": "cellwin", "note": None, "exc_share": cw.n_exc / max(rows, 1)}
    m = re.search(r"(\d+)/(\d+) exception rows", note or "")
    share = int(m.group(1)) / int(m.group(2)) if m else None
    return {"engine": "gather", "note": note, "exc_share": share}


def make_model(cfg):
    from ..models import ScaledPolynomial

    return ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=cfg.torch_dtype(),
                            device=cfg.torch_device())


def run_steps(cfg, data, steps: int = 10, warmup: int = WARMUP_STEPS, plain: bool = False):
    """``warmup`` Adam steps, then ``steps`` timed ones, each ending in a
    synchronisation. The exponent is a buffer, so Adam updates w alone (the
    JAX script's ``trainable_mask``); the optimizer is optax's Adam
    (``optim.Adam``). Returns {"losses" (each step's, at the parameters it
    starts from), "step_ms" (the timed steps'), "w" (after the last)}."""
    from ..optim import Adam
    from ..train import make_loss_fn

    device = cfg.torch_device()
    model = make_model(cfg)
    loss_fn = make_loss_fn(cfg, plain=plain)
    opt = Adam([model.w], lr=cfg.lr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, data)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, step_ms = [], []
    for _ in range(warmup):
        losses.append(step())
    sync()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    return {"losses": [float(v) for v in losses], "step_ms": step_ms,
            "w": float(model.w.detach()[0])}


def report_prep(c: dict, eng: dict, prep_s: float, seconds: dict) -> None:
    """The JAX script's first ``[scale]`` line, the prep's parts and the
    engine."""
    print("[scale] %d global points, %d query rows (%d in loss), K=%d (prep %.0fs)"
          % (c["global"], c["query"], c["loss"], c["k"], prep_s), flush=True)
    print("[scale] prep seconds: %s" % ", ".join("%s %.3f" % kv for kv in seconds.items()))
    print("[scale] engine: %s%s" % (
        eng["engine"], "" if eng["exc_share"] is None
        else " (exception rows %.2f%%)" % (100.0 * eng["exc_share"])))
    if eng["note"]:
        print("[scale] the cell-window build %s" % eng["note"])


def report_run(c: dict, run: dict, device) -> None:
    """The JAX script's second ``[scale]`` line (the mean of the timed
    steps), their median and spread, and the peak device bytes."""
    times = run["step_ms"]
    if times:
        dt = sum(times) / len(times) / 1e3
        print("[scale] %.1f ms/step, %.3g corrected points/sec/chip, final loss %.3e, w %.3e"
              % (dt * 1e3, c["global"] / dt, run["losses"][-1], run["w"]), flush=True)
        print("[scale] step median %.3f ms, spread %.3f-%.3f ms over %d steps"
              % (statistics.median(times), min(times), max(times), len(times)))
    if device.type == "cuda":
        print("[scale] peak device bytes %d" % torch.cuda.max_memory_allocated(device))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--density", type=float, default=300.0, help="open-box surface density")
    p.add_argument("--size", default="32_32_6",
                   help="box size WxLxH tokens (32_32_6 -> ~850k global points after the "
                        "0.1 m grid)")
    p.add_argument("--steps", type=int, default=10)
    add_device_arg(p)
    args = p.parse_args(argv)

    cfg = scale_config(args.density, args.size, device=args.device)
    device = cfg.torch_device()
    t0 = time.perf_counter()
    scans = load_scans(cfg)
    data, _ = prepare(cfg, scans)
    prep_s = time.perf_counter() - t0
    c, eng = counts(data), engine(data)
    report_prep(c, eng, prep_s, dict(data.prep_seconds))
    run = run_steps(cfg, data, args.steps)
    report_run(c, run, device)
    out = dict(c, **eng, **run, prep_s=prep_s, prep_seconds=dict(data.prep_seconds))
    if device.type == "cuda":
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
