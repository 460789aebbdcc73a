#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):

1. build   — compile the CUDA kernels of depth_correction_tpu_torch/csrc.
2. kernels — K1 (cell-window moments forward) and K2 (backward) against
   their plain torch versions, float32 and float64, on a seeded synthetic
   graph at row_cap = pt_cap = 128.
3. slice   — the uncapped min-eigenvalue training step at the JAX bench's
   configuration (bench.py:bench_config(uncapped=True)), scene
   open_box/n_6_size_20_20_5_height_1_density_400, prepared with scipy
   neighbors, trained for 8 Adam steps through train(); both kernels must
   have launched, the loss at w=0 must match the float64 plain path within
   1e-5 relative, and K1/K2 are checked and timed at the slice's shapes.
4. node    — the online corrector at the JAX bench's node workload
   (bench.py:build_node_scan: the raw 129,000-point scan of
   open_box/n_6_size_20_20_5_height_1_density_215, slab engine, float32)
   through DepthCorrector.process and correct_cloud; X1 must have launched
   and meet its bars against the float64 plain version on the node's own
   sorted inputs; the corrected points are held against the port's plain
   float64 node path; node_ms, node_e2e_ms and node_points are printed.
5. small   — a scan of the same box below 65,536 padded points
   (density 100), routed to the brute engine (K = 32): P7 must have
   launched and meet its bars on the node's own neighbour table; then P7
   and its plain version are timed at the shapes of
   scripts/exp_pallas_gather.py's stage 2 and held within 1e-5 relative.

The last two lines of stdout are a JSON object with per-kernel numbers and
{"ok": true, "device": {...}}. Without a CUDA device the script fails
before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

STEPS = 8
DEVICE = "cuda"
SCENE = "open_box/n_6_size_20_20_5_height_1_density_400"
NODE_SCENE = "open_box/n_6_size_20_20_5_height_1_density_215"
SMALL_SCENE = "open_box/n_6_size_20_20_5_height_1_density_100"
NODE_REPS = 20  # chained calls per node_ms batch
E2E_REPS = 10
POINTS_ABS_BAR = 1e-4  # m, corrected points against the float64 plain node
PROBE_REL_BAR = 1e-5  # P7 at the probe's shapes, relative to max |output|
# Bars against the float64 plain version.
MEAN_ABS_BAR = 1e-5  # m
COMPS_ABS_BAR = 1e-6  # m^2
GRAD_REL_BAR = 1e-4  # relative to max |grad|
LOSS_REL_BAR = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> float:
    from depth_correction_tpu_torch.ops import _kernels

    info = _kernels.build()
    _kernels.load()
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    log("build: %.2f s (%s)" % (info["seconds"], os.path.basename(info["path"])))
    return info["seconds"]


def _uncapped_graph(pts, r):
    from scipy.spatial import cKDTree

    lists = cKDTree(pts).query_ball_point(pts, r, workers=-1)
    import numpy as np

    nn = np.full((len(pts), max(len(l) for l in lists)), -1, np.int64)
    for i, l in enumerate(lists):
        nn[i, : len(l)] = sorted(l)
    return nn


def synthetic_graph(seed: int = 0, n: int = 40000, r: float = 0.35):
    """The tests' kind of scene (half a noisy plane, half a volume), larger."""
    import numpy as np

    from depth_correction_tpu_torch.ops.cellwin import build_cellwin_graph

    rng = np.random.default_rng(seed)
    n1 = n // 2
    p1 = np.c_[rng.uniform(-6, 6, (n1, 2)), 0.02 * rng.standard_normal(n1)]
    p2 = rng.uniform(-6, 6, (n - n1, 3))
    pts = np.vstack([p1, p2])
    nn = _uncapped_graph(pts, r)
    # Query rows as the slice's prep keeps them: a random 70% among the
    # points with at least min_valid_neighbors (5) neighbors. Rows with
    # fewer have a covariance normalizer of max(s0 - 1, 1e-6), whose
    # cotangents the loss never produces.
    keep = (rng.uniform(size=n) < 0.7) & ((nn >= 0).sum(1) >= 5)
    qrows = np.flatnonzero(keep)
    g = build_cellwin_graph(pts, np.ones(n, bool), qrows, nn[qrows], r,
                            row_cap=128, pt_cap=128, span_limit=512)
    if g is None:
        raise RuntimeError("synthetic cellwin graph declined")
    return pts, g


def compare_kernels(pts_sorted, dev, seed: int, label: str, card: str = ""):
    """K1/K2 against the plain versions (float32 and float64) on the same
    float32 inputs; raises on a missed bar. Returns per-kernel numbers,
    with times when ``card`` (the nvidia-smi line) is given."""
    import numpy as np
    import torch

    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.ops.features import _cotangent_table

    f_args = (dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    raw_k = cw.cellwin_fwd(pts_sorted, *f_args)
    torch.cuda.synchronize()
    raw_32 = cw.cellwin_fwd_plain(pts_sorted, *f_args)
    raw_64 = cw.cellwin_fwd_plain(pts_sorted.double(), *f_args)
    rows = (dev.row_map >= 0).clone()
    rows[dev.exc_slots] = False  # exception rows are recomputed by gather
    res = {}
    for name, ref in (("f32", raw_32), ("f64", raw_64)):
        d = (raw_k.double() - ref.double())[:, rows].abs()
        res[name] = (float(d[0:3].max()), float(d[3:9].max()))
        log("  %s K1 vs plain %s: mean max abs %.3e m, comps max abs %.3e m^2 "
            "(%d rows, %d exception rows excluded)"
            % (label, name, res[name][0], res[name][1], int(rows.sum()), dev.n_exc))
    if not (res["f64"][0] <= MEAN_ABS_BAR and res["f64"][1] <= COMPS_ABS_BAR):
        raise RuntimeError("%s K1 misses its bars vs float64: %s" % (label, res["f64"]))

    gen = torch.Generator(device="cpu").manual_seed(seed)
    g_rows = torch.randn((9, raw_k.shape[1]), generator=gen, dtype=torch.float64)
    g_rows = torch.where(rows.cpu()[None], g_rows, torch.zeros_like(g_rows)).to(pts_sorted.device)
    table_64 = _cotangent_table(raw_64[0:3], raw_64[9], (g_rows[0:3], tuple(g_rows[3:9])))
    table_32 = table_64.float().contiguous()
    b_args = (dev.b_start, dev.b_len, dev.b_ctr, dev.r2)
    grad_k = cw.cellwin_bwd(pts_sorted, dev.q_est, dev.est_sorted, table_32, *b_args)
    torch.cuda.synchronize()
    grad_32 = cw.cellwin_bwd_plain(pts_sorted, dev.q_est, dev.est_sorted, table_32, *b_args)
    grad_64 = cw.cellwin_bwd_plain(pts_sorted.double(), dev.q_est, dev.est_sorted,
                                   table_32.double(), *b_args)
    gres = {}
    for name, ref in (("f32", grad_32), ("f64", grad_64)):
        d = (grad_k.double() - ref.double()).abs()
        scale = float(ref.double().abs().max())
        gres[name] = (float(d.max()), float(d.max()) / max(scale, 1e-30))
        log("  %s K2 vs plain %s: grad max abs %.3e, relative to max |grad| %.3e"
            % (label, name, gres[name][0], gres[name][1]))
    if not np.isfinite(gres["f64"][1]) or gres["f64"][1] > GRAD_REL_BAR:
        raise RuntimeError("%s K2 misses its bar vs float64: %s" % (label, gres["f64"]))
    out = {"fwd_err": max(res["f64"]), "bwd_err": gres["f64"][0]}
    if card:
        out["fwd_ms"] = cuda_ms(lambda: cw.cellwin_fwd(pts_sorted, *f_args), reps=50)
        out["fwd_plain_ms"] = cuda_ms(lambda: cw.cellwin_fwd_plain(pts_sorted, *f_args), reps=5)
        bargs = (pts_sorted, dev.q_est, dev.est_sorted, table_32) + b_args
        out["bwd_ms"] = cuda_ms(lambda: cw.cellwin_bwd(*bargs), reps=50)
        out["bwd_plain_ms"] = cuda_ms(lambda: cw.cellwin_bwd_plain(*bargs), reps=5)
        log("  %s timing (float32): K1 %.4f ms vs plain %.4f ms; K2 %.4f ms vs plain %.4f ms (%s)"
            % (label, out["fwd_ms"], out["fwd_plain_ms"], out["bwd_ms"], out["bwd_plain_ms"], card))
    return out


def phase_kernels():
    import torch

    from depth_correction_tpu_torch.ops.cellwin import graph_to_device

    pts, g = synthetic_graph()
    log("synthetic graph: %d rows -> %d row tiles, %d point tiles, ns_f %d, ns_b %d, "
        "%d exception rows" % (g.n_rows, g.n_row_tiles, g.n_pt_tiles, g.ns_f, g.ns_b, g.n_exc))
    dev = graph_to_device(g, DEVICE)
    pts_sorted = torch.as_tensor(pts, dtype=torch.float32, device=DEVICE)[dev.perm].contiguous()
    compare_kernels(pts_sorted, dev, seed=1, label="synthetic")


def bench_config():
    """bench.py:bench_config(uncapped=True), with scipy establishment."""
    from depth_correction_tpu_torch.config import Config

    cfg = Config()
    cfg.nn_backend = "scipy"
    cfg.device = DEVICE
    cfg.float_type = "float32"
    cfg.dataset = "open_box"
    cfg.train_names = [SCENE]
    cfg.min_depth, cfg.max_depth = 1.0, 25.0
    cfg.grid_res = 0.1
    cfg.nn_r, cfg.nn_k = 0.25, 0
    cfg.min_valid_neighbors = 5
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = [[0, 1, 0, 0.25], [1, 2, 0.25, 1.0]]
    cfg.loss = "min_eigval_loss"
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.lr = 2e-4
    cfg.nn_max_neighbors = None
    cfg.moments_backend = "auto"
    cfg.n_opt_iters = STEPS
    cfg.plot_period = 1
    return cfg


def phase_slice(card: str):
    import math

    import torch

    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.ops.features import permute_rows
    from depth_correction_tpu_torch.preproc import global_cloud
    from depth_correction_tpu_torch.train import (
        TrainCallbacks, make_loss_fn, make_optimizer, prepare_sequences, train,
    )

    cfg = bench_config()

    class Record(TrainCallbacks):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.w = {}

        def train_loss(self, it, model, pose_deltas, loss):
            self.w[it] = float(model.w.detach()[0])

    # The main path: datasets -> prep -> train(); counts from this run only.
    cw.reset_launch_counts()
    t0 = time.perf_counter()
    ds = create_dataset(cfg.train_names[0], cfg)
    data = prepare_sequences([ds], cfg)
    prep_s = time.perf_counter() - t0
    for part, s in data.prep_seconds.items():
        log("prep %s: %.3f s" % (part, s))
    log("prep total: %.3f s" % prep_s)
    graph = data.cellwin[0]
    if graph is None:
        raise RuntimeError("the cellwin build declined: the slice would not run the kernels")
    rec = Record(cfg)
    model, history = train(cfg, callbacks=rec, train_data=data)
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES}
    log("main path launches: K1 %d, K2 %d" % (launches["fwd"], launches["bwd"]))
    if launches["fwd"] <= 0 or launches["bwd"] <= 0:
        raise RuntimeError("a kernel of the path was not launched: %s" % launches)
    losses = [h[1] for h in history]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError("non-finite loss: %s" % losses)
    step_ms = statistics.median(h[2] for h in history[1:])
    w_final = float(model.w.detach()[0])
    log("slice: %d points, %d rows -> %d row tiles x %d, %d point tiles, %d exception rows"
        % (data.batches[0].cloud.depth.numel(), int((graph.row_map >= 0).sum()),
           graph.f_start.shape[0], graph.q_est.shape[1] // graph.f_start.shape[0],
           graph.b_start.shape[0], graph.n_exc))
    log("losses: %s" % ", ".join("%.9e" % v for v in losses))
    log("w: %s" % ", ".join("%.6e" % rec.w[i] for i in sorted(rec.w)))

    # float64 plain reference on the same graph: loss at w=0 and 6 Adam steps.
    data64 = data.to(dtype=torch.float64)
    loss_plain = make_loss_fn(cfg, plain=True)
    ref = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float64, device=DEVICE)
    opt = make_optimizer(cfg, [ref.w])
    ref_losses = []
    for _ in range(6):
        opt.zero_grad()
        value = loss_plain(ref, data64)
        value.backward()
        ref_losses.append(float(value.detach()))
        opt.step()
    w6_ref = float(ref.w.detach()[0])
    loss_rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    w_rel = abs(rec.w[6] - w6_ref) / max(abs(w6_ref), 1e-30)
    log("loss at w=0: kernels %.9e vs float64 plain %.9e (rel %.3e)"
        % (losses[0], ref_losses[0], loss_rel))
    log("w after 6 steps: kernels %.6e vs float64 plain %.6e (rel %.3e)"
        % (rec.w[6], w6_ref, w_rel))
    if not loss_rel <= LOSS_REL_BAR:
        raise RuntimeError("loss at w=0 misses the 1e-5 bar: %.3e" % loss_rel)

    profile = profile_steps(cfg, data, card)

    # Kernels at the slice's own shapes, on the step's inputs at w=0.
    with torch.no_grad():
        zero = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float32, device=DEVICE)
        ps = permute_rows(global_cloud(data.batches[0], model=zero).get_points(),
                          graph.perm, graph.inv).contiguous()
        k = compare_kernels(ps, graph, seed=2, label="slice", card=card)
    return {
        "launches": launches, "kernels": k, "step_ms": step_ms, "prep_s": prep_s,
        "loss_rel": loss_rel, "w_rel": w_rel, "w_final": w_final, "profile": profile,
    }


def profile_steps(cfg, data, card: str, n: int = 3):
    """Where a step's time goes: ``n`` training steps under torch.profiler."""
    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.train import make_loss_fn, make_optimizer

    model = load_model(cfg=cfg)
    loss_fn = make_loss_fn(cfg)
    opt = make_optimizer(cfg, [model.w])

    def step():
        opt.zero_grad()
        loss_fn(model, data).backward()
        opt.step()

    return profile_calls(step, card, "step", n)


def profile_calls(fn, card: str, unit: str, n: int = 3):
    """``n`` calls of ``fn`` under torch.profiler, after one warm call:
    wall ms per call, device-busy ms per call (sum of kernel times), device
    kernels per call and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n

    # Kernels (and copies) only: the CPU-side ops that launched them report
    # the same device time again.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    kernels = sum(e.count for e in events) / n
    log("profile: %.3f ms/%s wall, %.3f ms/%s device busy (%.1f%%), %.0f device "
        "kernels/%s (%s)" % (wall_ms, unit, busy_ms, unit, 100.0 * busy_ms / wall_ms,
                             kernels, unit, card))
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log("  %-60s %9.3f ms/%s  x%d" % (e.key[:60], e.self_device_time_total / 1e3 / n,
                                          unit, e.count // n))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels_per_call": kernels}


def node_config(backend):
    """bench.py:build_node_scan's configuration: bench_config(True) with
    the node's engine (None routes by scan size)."""
    cfg = bench_config()
    cfg.nn_backend = backend
    return cfg


def node_scan(name: str):
    """A raw scan as the node receives it (bench.py:build_node_scan)."""
    from depth_correction_tpu_torch.datasets.synthetic import OpenBoxDataset

    return OpenBoxDataset(name=name).local_cloud(0)


def drive_node(scan, cfg, card: str, label: str, batches: int, reps: int, e2e_reps: int):
    """The node's main path on the card: DepthCorrector.process (structured
    scan in, numpy out) and correct_cloud on a device-resident cloud; the
    launch counts of that run; per-scan times; the outputs against the
    port's plain float64 node path on the same kept points."""
    import copy

    import numpy as np
    import torch

    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.node import DepthCorrector, correct_cloud
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.preproc import pad_size

    model = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float32, device=DEVICE)
    node = DepthCorrector(cfg, model=model)
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))

    # The main path; counts from this run only.
    _kernels.reset_launch_counts()
    out = node.process(scan)
    outs = correct_cloud(model, cloud, cfg)
    torch.cuda.synchronize()
    launches = {"slab": _kernels.SLAB_LAUNCHES, "gather": _kernels.GATHER_LAUNCHES}
    kept = int(outs[4].sum())
    log("%s: %d raw points, padded %d, %d kept, %d corrected; launches X1 %d, P7 %d"
        % (label, len(scan), cloud.size, kept, int(outs[3].sum()), launches["slab"],
           launches["gather"]))
    if len(out) != kept or not all(np.isfinite(out[f]).all() for f in out.dtype.names):
        raise RuntimeError("%s: DepthCorrector output malformed (%d rows, %d kept)"
                           % (label, len(out), kept))
    for x in outs[:3]:
        if not bool(torch.isfinite(x[outs[4]]).all()):
            raise RuntimeError("%s: non-finite corrected output" % label)

    # Float64 plain reference on the same kept points (the voxel filter draws
    # its ranks in the cloud's float type, so the reference takes the kept
    # mask of the float32 run and skips the filter).
    cfg64 = copy.deepcopy(cfg)
    cfg64.grid_res = 0.0
    cloud64 = Cloud.from_structured_array(scan, dtype=torch.float64, device=DEVICE)
    cloud64 = cloud64.pad(cloud.size).replace(valid=outs[4])
    model64 = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float64, device=DEVICE)
    ref = correct_cloud(model64, cloud64, cfg64, plain=True)
    both = outs[3] & ref[3]
    pts_err = float((outs[0].double() - ref[0])[both].abs().max())
    log("%s vs float64 plain node: kept %d / %d, corrected %d / %d, mask differs on %d rows, "
        "points max abs %.3e m on %d rows corrected in both"
        % (label, kept, int(ref[4].sum()), int(outs[3].sum()), int(ref[3].sum()),
           int((outs[3] != ref[3]).sum()), pts_err, int(both.sum())))
    # The plain path in float32 on the same rows: the masks that float32
    # rounding flips without any kernel.
    ref32 = correct_cloud(model, cloud.replace(valid=outs[4]), cfg64, plain=True)
    log("%s: float32 plain node corrects %d; its mask differs from float64 plain on %d rows, "
        "from the kernels' on %d" % (label, int(ref32[3].sum()), int((ref32[3] != ref[3]).sum()),
                                    int((ref32[3] != outs[3]).sum())))
    if not pts_err <= POINTS_ABS_BAR:
        raise RuntimeError("%s: corrected points miss the %.0e m bar: %.3e"
                           % (label, POINTS_ABS_BAR, pts_err))

    # node_ms: chained calls on device-resident inputs, ending in a sync.
    batch_ms = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            outs = correct_cloud(model, cloud, cfg)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3 / reps)
    e2e = []
    for _ in range(e2e_reps):
        t0 = time.perf_counter()
        node.process(scan)
        e2e.append((time.perf_counter() - t0) * 1e3)
    res = {"launches": launches, "points": kept, "ms": statistics.median(batch_ms),
           "e2e_ms": statistics.median(e2e), "pts_err": pts_err, "outs": outs}
    log("%s: node_ms %.3f (median of %d batches of %d chained calls: %s), node_e2e_ms %.3f "
        "(median of %d, %.3f-%.3f), node_points %d (%s)"
        % (label, res["ms"], batches, reps, ", ".join("%.3f" % t for t in batch_ms),
           res["e2e_ms"], e2e_reps, min(e2e), max(e2e), kept, card))
    res["profile"] = profile_calls(lambda: correct_cloud(model, cloud, cfg), card, "scan")
    return res


def phase_node(card: str):
    import torch

    from depth_correction_tpu_torch.node import NODE_N_CELLS_PAD, _slab_layout
    from depth_correction_tpu_torch.ops import slabwin

    cfg = node_config("slab")
    t0 = time.perf_counter()
    scan = node_scan(NODE_SCENE)
    log("node scan %s: %d points (%.1f s)" % (NODE_SCENE, len(scan), time.perf_counter() - t0))
    res = drive_node(scan, cfg, card, "node", batches=3, reps=NODE_REPS, e2e_reps=E2E_REPS)
    if res["launches"]["slab"] <= 0:
        raise RuntimeError("X1 was not launched on the node's main path: %s" % res["launches"])

    # X1 on the node's own sorted inputs, against the float64 plain version.
    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.preproc import pad_size

    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))
    keep = res["outs"][4]
    pts_T, valid, ids, _, dims = _slab_layout(cloud.to_points(), keep, cfg.nn_r)
    lo, width, ctr, has = slabwin.slab_tile_spans(pts_T, valid, ids, dims, NODE_N_CELLS_PAD)
    r2 = float(cfg.nn_r) ** 2
    out = slabwin.slab_window_kernel(pts_T, valid, lo, width, ctr, r2)
    torch.cuda.synchronize()
    ref = slabwin.slab_window_moments_plain(pts_T.double(), valid, lo, width, ctr.double(), r2)
    d = (out.double() - ref)[:, valid].abs()
    err = (float(d[0:3].max()), float(d[3:9].max()))
    log("X1 vs plain float64 (%d slots, %d tiles, %d live, widest span %d): mean max abs "
        "%.3e m, comps max abs %.3e m^2" % (pts_T.shape[1], lo.shape[0], int(has.sum()),
                                          int(width.max()), err[0], err[1]))
    if not (err[0] <= MEAN_ABS_BAR and err[1] <= COMPS_ABS_BAR):
        raise RuntimeError("X1 misses its bars vs float64: %s" % (err,))
    res["x1_err"] = max(err)
    res["x1_ms"] = cuda_ms(lambda: slabwin.slab_window_kernel(pts_T, valid, lo, width, ctr, r2),
                           reps=50)
    res["x1_plain_ms"] = cuda_ms(
        lambda: slabwin.slab_window_moments_plain(pts_T, valid, lo, width, ctr, r2), reps=3)
    log("X1 timing (float32, node shapes): kernel %.4f ms vs plain %.4f ms (%s)"
        % (res["x1_ms"], res["x1_plain_ms"], card))
    return res


def phase_small(card: str):
    import numpy as np
    import torch

    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.ops import features
    from depth_correction_tpu_torch.ops.grid_hash import GRID_NN_MIN_POINTS
    from depth_correction_tpu_torch.ops.knn import radius_neighbors
    from depth_correction_tpu_torch.preproc import pad_size

    cfg = node_config(None)  # routed by size
    scan = node_scan(SMALL_SCENE)
    if pad_size(len(scan)) >= GRID_NN_MIN_POINTS:
        raise RuntimeError("the small scan would not route to the brute engine")
    res = drive_node(scan, cfg, card, "small", batches=1, reps=3, e2e_reps=3)
    if res["launches"]["gather"] <= 0:
        raise RuntimeError("P7 was not launched on the brute engine: %s" % res["launches"])

    # P7 on the node's own neighbour table, against the float64 plain version.
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))
    keep = res["outs"][4]
    points = cloud.to_points()
    _, nn = radius_neighbors(points, points, r=cfg.nn_r, k=32, valid_points=keep,
                             valid_query=keep)
    w = (nn >= 0).float()
    got = features.gather_moments(points, nn, w)
    torch.cuda.synchronize()
    ref = features.gather_moments_plain(points.double(), nn, w.double())
    err = (float((got[0].double() - ref[0])[:, keep].abs().max()),
           float((got[1].double() - ref[1])[:, keep].abs().max()))
    log("P7 vs plain float64 (node table %d x %d, %d kept rows): mean max abs %.3e m, comps "
        "max abs %.3e m^2" % (nn.shape[0], nn.shape[1], int(keep.sum()), err[0], err[1]))
    if not (err[0] <= MEAN_ABS_BAR and err[1] <= COMPS_ABS_BAR):
        raise RuntimeError("P7 misses its bars vs float64 on the node's table: %s" % (err,))
    res["p7_err"] = max(err)
    node_ms = cuda_ms(lambda: features.gather_moments(points, nn, w), reps=50)
    node_plain_ms = cuda_ms(lambda: features.gather_moments_plain(points, nn, w), reps=5)
    log("P7 timing (float32, node table): kernel %.4f ms vs plain %.4f ms (%s)"
        % (node_ms, node_plain_ms, card))

    # The probe's stage-2 shapes (scripts/exp_pallas_gather.py:75-81).
    rng = np.random.default_rng(0)
    m, mq, k = 390144, 223744, 32
    pts = torch.as_tensor(rng.normal(size=(3, m)), dtype=torch.float32, device=DEVICE)
    idx = torch.as_tensor(rng.integers(0, m, (mq, k)), dtype=torch.int32, device=DEVICE)
    wp = torch.as_tensor(rng.random((mq, k)) > 0.1, dtype=torch.float32, device=DEVICE)
    got = features.gather_moments(pts, idx, wp)
    ref = features.gather_moments_plain(pts.T.double(), idx, wp.double())
    rel = max(float((g.double() - r).abs().max()) / float(r.abs().max())
              for g, r in zip(got, ref))
    log("P7 vs plain float64 at the probe's shapes (M %d, MQ %d, K %d): max error %.3e of "
        "max |output|" % (m, mq, k, rel))
    if not rel <= PROBE_REL_BAR:
        raise RuntimeError("P7 misses the %.0e relative bar at the probe's shapes: %.3e"
                           % (PROBE_REL_BAR, rel))
    res["p7_ms"] = cuda_ms(lambda: features.gather_moments(pts, idx, wp), reps=20)
    pts_n3 = pts.T.contiguous()
    res["p7_plain_ms"] = cuda_ms(lambda: features.gather_moments_plain(pts_n3, idx, wp), reps=3)
    log("P7 timing (float32, probe shapes): kernel %.4f ms vs plain %.4f ms (%s)"
        % (res["p7_ms"], res["p7_plain_ms"], card))
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import depth_correction_tpu_torch  # noqa: F401  (fails outside the repo)

    card = card_line()
    log(card)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    log("[phase 1] build")
    phase_build()
    log("[phase 2] kernels vs plain (synthetic graph)")
    phase_kernels()
    log("[phase 3] slice (bench configuration, %d Adam steps)" % STEPS)
    res = phase_slice(card)
    log("median step: %.3f ms over steps 1..%d; prep %.1f s; total %.1f s (%s)"
        % (res["step_ms"], STEPS - 1, res["prep_s"], time.perf_counter() - t0, card))
    log("[phase 4] node (bench node scan, slab engine)")
    node = phase_node(card)
    log("[phase 5] node small scan (brute engine) and P7")
    small = phase_small(card)
    log("node_ms %.3f, node_e2e_ms %.3f, node_points %d; small scan (brute): node_ms %.3f, "
        "node_e2e_ms %.3f, node_points %d; total %.1f s (%s)"
        % (node["ms"], node["e2e_ms"], node["points"], small["ms"], small["e2e_ms"],
           small["points"], time.perf_counter() - t0, card))
    k = res["kernels"]
    log(card)
    print(json.dumps({"kernels": [
        {"name": "cellwin_fwd (K1)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/cellwin.cu",
         "replaces": "depth_correction_tpu/ops/cellwin.py:700",
         "launches": res["launches"]["fwd"], "max_abs_err": k["fwd_err"],
         "ms": k["fwd_ms"], "plain_ms": k["fwd_plain_ms"]},
        {"name": "cellwin_bwd (K2)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/cellwin.cu",
         "replaces": "depth_correction_tpu/ops/cellwin.py:837",
         "launches": res["launches"]["bwd"], "max_abs_err": k["bwd_err"],
         "ms": k["bwd_ms"], "plain_ms": k["bwd_plain_ms"]},
        {"name": "slab_window (X1)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/slabwin.cu",
         "replaces": "depth_correction_tpu/ops/slabwin.py:53",
         "launches": node["launches"]["slab"], "max_abs_err": node["x1_err"],
         "ms": node["x1_ms"], "plain_ms": node["x1_plain_ms"]},
        {"name": "gather_moments (P7)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/gather_moments.cu",
         "replaces": "scripts/exp_pallas_gather.py:83",
         "launches": small["launches"]["gather"], "max_abs_err": small["p7_err"],
         "ms": small["p7_ms"], "plain_ms": small["p7_plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
