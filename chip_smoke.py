#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):

1. build   — compile the CUDA kernels of depth_correction_tpu_torch/csrc.
2. kernels — K1 (cell-window moments forward) and K2 (backward) against
   their plain torch versions, float32 and float64, and against their
   first versions (csrc/cellwin_v1.cu: bit for bit, K2 also with an
   all-ones cotangent table), on a seeded synthetic graph at row_cap =
   pt_cap = 128; the pair tests the warps' box cull keeps, counted on the
   host, beside all of them.
3. slice   — the uncapped min-eigenvalue training step at the JAX bench's
   configuration (bench.py:bench_config(uncapped=True)), scene
   open_box/n_6_size_20_20_5_height_1_density_400, prepared with the
   bench's grid establishment (X2 for the 6 scans and the global cloud;
   prep seconds per part are printed beside the 26 s that scipy's cKDTree
   establishment took on an H100),
   trained for 8 Adam steps through train(); X2, K1 and K2 must have
   launched, the loss at w=0 must match the float64 plain path within 1e-5
   relative, and K1/K2 are checked as in phase 2 and timed at the slice's
   shapes, each in turns with its first version (v1, new, new, v1); the
   profiled step is taken with the new kernels and with the first
   versions.
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
6. probes  — the port's probe scripts (depth_correction_tpu_torch/scripts),
   each run with the launch counts zeroed just before and read just after:
   P1 (exp_cellwin_knockout: K1's knockout modes on the slice's own table
   from phase 3; `full` and `no_cull` must be bit-equal to K1, every mode
   meet its bars against its float64 plain version), P2 (exp_mosaic_dot_probe: the
   moment product in fp32 / tf32 / tf32x2 / tf32x3, torch.bmm timed beside
   it), P3-P5 (exp_mosaic_dot_probe2-4: the product with in-kernel
   operands and K1's structural pieces), at the TPU scripts' seeds and
   shapes. Every variant must be within 1e-5 (relative, per output row) of
   its float32 plain version; fp32 and tf32x3 within 1e-5 of the float64
   oracle; a table of ms per variant is printed.
7. grid    — X2 (the grid radius search) against its plain twin on the
   card, on phase 3's global cloud and on its first scan: index tables
   equal, distances within one float32 ulp, counts equal; against scipy's
   float64 sets on the scan (a pair may differ only within 1e-6 r of the
   radius); X2 timed at both sizes. X2 at the grid node's shapes (the
   traced 2^21-cell grid of phase 4's filtered scan; k = 32, the node's,
   and k = 16, below the scan's largest count, so the top-k cuts) against
   its plain twin, as above. Then the node's grid
   engine (X2 + P7, K = 32) on phase 4's scan, held within 1e-4 m of the
   float64 plain grid node, with node_ms and node_e2e_ms as phase 4
   measures them.
8. probes  — P6 (exp_mosaic_probe: the seven layout probes) and P8
   (exp_pallas_gather2: gather cases A-E, global and staged), each script
   run with the launch counts zeroed just before and read just after;
   every form exact against its plain version.

The last two lines of stdout are a JSON object with per-kernel numbers
(time, plain time, launches, error, the bound and what sets it, the
library call's time where one PyTorch call computes the same function;
for K1 and K2 also their first versions' time `v1_ms`, both kernels'
own durations by the profiler `kernel_ms` / `v1_kernel_ms`, the pair
tests the box cull keeps `pairs_kept`, counted by the host model of the
cull (scripts/cellwin_cull.py) and not read from the kernels, and the
first versions' bound `bound_all_pairs_ms`, which charges every span pair
test) and {"ok": true, "device": {...}}.
Without a CUDA device the script fails before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

STEPS = 8
DEVICE = "cuda"
NODE_SCENE = "open_box/n_6_size_20_20_5_height_1_density_215"
SMALL_SCENE = "open_box/n_6_size_20_20_5_height_1_density_100"
NODE_REPS = 20  # chained calls per node_ms batch
E2E_REPS = 10
POINTS_ABS_BAR = 1e-4  # m, corrected points against the float64 plain node
# X2's cut check at the grid node's shapes: below the node scan's largest
# within-r count (27), so the top-k drops neighbours.
GRID_CUT_K = 16
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


def kernel_ms(fn, device, reps: int) -> float:
    """Mean ms per call of ``fn``'s kernels alone (torch.profiler)."""
    from depth_correction_tpu_torch.scripts import kernel_ms as timer

    return timer(fn, device, reps)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call, by CUDA events around ``reps`` calls."""
    from depth_correction_tpu_torch.scripts import device_ms

    return device_ms(fn, DEVICE, reps, warmup)


# Published peaks of one H100 SXM (NVIDIA data sheet; dense): the bounds
# below are the larger of bytes / HBM rate and the operations of each type
# over that type's peak rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12}


def bound(nbytes: float, ops: dict) -> tuple:
    """(bound_ms, "bytes" or "operations") for ``nbytes`` moved once and
    ``ops`` {type: count} done at the card's published peaks. fp32 runs on
    the CUDA cores and tf32 on the tensor cores, pipes that issue side by
    side, so the operations take the longest type's time, not the sum."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Float operations of one pair test (3 subtractions, a multiply and two
# fmas) and of one warp's box test of a window entry (per axis 2
# subtractions and 2 max, then the same distance).
PAIR_OPS, BOX_OPS = 8, 17


def cellwin_fwd_bound(graph, pairs: int, members: int, box_tests: int = 0) -> tuple:
    """K1's bound on ``graph`` (P1's ``full`` does the same work): ``pairs``
    membership tests and ``box_tests`` warp box tests (the box cull's kept
    tests and its tests, or every span pair test and none for the first
    version), ~19 float ops per member, an epilogue per row; positions,
    establishment positions, span tables and centres read once,
    (10, mq_pad) written once."""
    m_pad, mq_pad = graph.est_sorted.shape[1], graph.q_est.shape[1]
    t1, ns = graph.f_start.shape
    return bound(m_pad * 24 + mq_pad * 12 + t1 * (ns * 8 + 12) + mq_pad * 40,
                 {"fp32": PAIR_OPS * pairs + BOX_OPS * box_tests + 19 * members + 30 * mq_pad})


def cellwin_bwd_bound(graph, pairs: int, members: int, box_tests: int = 0) -> tuple:
    """K2's bound on ``graph``: its own pair tests and box tests as in
    :func:`cellwin_fwd_bound`, 9 adds per member (the same member pairs as
    K1's), 15 float ops per point; positions, establishment positions,
    cotangents, span tables and centres read once, (m_pad, 3) written once."""
    m_pad, mq_pad = graph.est_sorted.shape[1], graph.q_est.shape[1]
    t2, ns_b = graph.b_start.shape
    return bound(m_pad * 24 + mq_pad * 48 + t2 * (ns_b * 8 + 12) + m_pad * 12,
                 {"fp32": PAIR_OPS * pairs + BOX_OPS * box_tests + 9 * members + 15 * m_pad})


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


def bit_equal(a, b) -> bool:
    """float32 tensors equal bit for bit (-0.0 and 0.0 differ)."""
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def pairs_kept(dev) -> dict:
    """(pair tests K1's / K2's warps make after the box cull, all pair tests
    (span lengths x tile slots), the warps' box tests), from the host model
    of the cull (scripts/cellwin_cull.py) on the graph in the kernels'
    float32 form: the kernels count nothing."""
    from depth_correction_tpu_torch.scripts import cellwin_cull as cull

    t0 = time.perf_counter()
    res = {"fwd": cull.cull_pair_tests(dev.q_est, cull.ROW_PAD, dev.est_sorted, dev.f_start,
                                       dev.f_len, dev.f_ctr, dev.r2),
           "bwd": cull.cull_pair_tests(dev.est_sorted, cull.POINT_PAD, dev.q_est, dev.b_start,
                                       dev.b_len, dev.b_ctr, dev.r2)}
    log("  pair tests kept by the box cull (host model): K1 %d of %d (%.4f), %d box tests; "
        "K2 %d of %d (%.4f), %d box tests (%.1f s)"
        % (res["fwd"][0], res["fwd"][1], res["fwd"][0] / res["fwd"][1], res["fwd"][2],
           res["bwd"][0], res["bwd"][1], res["bwd"][0] / res["bwd"][1], res["bwd"][2],
           time.perf_counter() - t0))
    return res


def in_turns(first, second, reps: int = 50) -> tuple:
    """(first ms, second ms): CUDA-event means over ``reps`` launches each,
    timed in turns first, second, second, first; each the mean of its two."""
    a1 = cuda_ms(first, reps=reps)
    b1 = cuda_ms(second, reps=reps)
    b2 = cuda_ms(second, reps=reps)
    a2 = cuda_ms(first, reps=reps)
    log("    turns (ms): %.4f, %.4f, %.4f, %.4f" % (a1, b1, b2, a2))
    return (a1 + a2) / 2, (b1 + b2) / 2


def compare_kernels(pts_sorted, dev, seed: int, label: str, card: str = ""):
    """K1/K2 against the plain versions (float32 and float64) and against
    their first versions (bit for bit; K2 also with an all-ones cotangent
    table) on the same float32 inputs; raises on a missed bar. Returns
    per-kernel numbers, with times when ``card`` (the nvidia-smi line) is
    given."""
    import numpy as np
    import torch

    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.ops.features import _cotangent_table

    f_args = (dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    raw_k = cw.cellwin_fwd(pts_sorted, *f_args)
    raw_v1 = cw.cellwin_fwd_v1(pts_sorted, *f_args)
    torch.cuda.synchronize()
    same = bit_equal(raw_k, raw_v1)
    same9 = bit_equal(raw_k[9], raw_v1[9])
    log("  %s K1 vs its first version: bit-equal %s (max %d ulp), member counts (row 9) equal %s"
        % (label, same, _f32_ulps(raw_k, raw_v1), same9))
    if not (same and same9):
        raise RuntimeError("%s K1 differs from its first version" % label)
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
    grad_v1 = cw.cellwin_bwd_v1(pts_sorted, dev.q_est, dev.est_sorted, table_32, *b_args)
    ones = torch.ones_like(table_32)
    ones_k = cw.cellwin_bwd(pts_sorted, dev.q_est, dev.est_sorted, ones, *b_args)
    ones_v1 = cw.cellwin_bwd_v1(pts_sorted, dev.q_est, dev.est_sorted, ones, *b_args)
    torch.cuda.synchronize()
    same, same1 = bit_equal(grad_k, grad_v1), bit_equal(ones_k, ones_v1)
    log("  %s K2 vs its first version: bit-equal %s (max %d ulp); all-ones table bit-equal %s"
        % (label, same, _f32_ulps(grad_k, grad_v1), same1))
    if not (same and same1):
        raise RuntimeError("%s K2 differs from its first version" % label)
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
    out = {"fwd_err": max(res["f64"]), "bwd_err": gres["f64"][0], "kept": pairs_kept(dev)}
    if card:
        log("  %s K1 first version, new:" % label)
        out["fwd_v1_ms"], out["fwd_ms"] = in_turns(
            lambda: cw.cellwin_fwd_v1(pts_sorted, *f_args),
            lambda: cw.cellwin_fwd(pts_sorted, *f_args))
        out["fwd_plain_ms"] = cuda_ms(lambda: cw.cellwin_fwd_plain(pts_sorted, *f_args), reps=5)
        bargs = (pts_sorted, dev.q_est, dev.est_sorted, table_32) + b_args
        log("  %s K2 first version, new:" % label)
        out["bwd_v1_ms"], out["bwd_ms"] = in_turns(lambda: cw.cellwin_bwd_v1(*bargs),
                                                   lambda: cw.cellwin_bwd(*bargs))
        out["bwd_plain_ms"] = cuda_ms(lambda: cw.cellwin_bwd_plain(*bargs), reps=5)
        # The kernels' own durations (profiler), in the same turns.
        calls = {"fwd_v1": lambda: cw.cellwin_fwd_v1(pts_sorted, *f_args),
                 "fwd": lambda: cw.cellwin_fwd(pts_sorted, *f_args),
                 "bwd_v1": lambda: cw.cellwin_bwd_v1(*bargs), "bwd": lambda: cw.cellwin_bwd(*bargs)}
        for name in ("fwd_v1", "fwd", "bwd", "bwd_v1"):
            out[name + "_kernel_ms"] = kernel_ms(calls[name], DEVICE, reps=20)
        log("  %s timing (float32): K1 %.4f ms (first version %.4f, %.2fx; kernel alone %.4f vs "
            "%.4f) vs plain %.4f ms; K2 %.4f ms (first version %.4f, %.2fx; kernel alone %.4f vs "
            "%.4f) vs plain %.4f ms (%s)"
            % (label, out["fwd_ms"], out["fwd_v1_ms"], out["fwd_v1_ms"] / out["fwd_ms"],
               out["fwd_kernel_ms"], out["fwd_v1_kernel_ms"], out["fwd_plain_ms"], out["bwd_ms"],
               out["bwd_v1_ms"], out["bwd_v1_ms"] / out["bwd_ms"], out["bwd_kernel_ms"],
               out["bwd_v1_kernel_ms"], out["bwd_plain_ms"], card))
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
    """bench.py:bench_config(uncapped=True), grid establishment."""
    from depth_correction_tpu_torch.scripts import bench_config as config

    return config(DEVICE, STEPS)


def phase_slice(card: str):
    import math

    import torch

    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.scripts.exp_cellwin_knockout import points_at_w0
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
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ds = create_dataset(cfg.train_names[0], cfg)
    data = prepare_sequences([ds], cfg)
    prep_s = time.perf_counter() - t0
    grid_launches = _kernels.GRID_LAUNCHES
    for part, s in data.prep_seconds.items():
        log("prep %s: %.3f s%s" % (part, s, " (scipy's cKDTree on an H100: 26 s)"
                                   if part == "global_neighbors" else ""))
    log("prep total: %.3f s (nn_backend %r; X2 launches in prep %d)"
        % (prep_s, cfg.nn_backend, grid_launches))
    if grid_launches <= 0:
        raise RuntimeError("X2 was not launched by the grid establishment of the prep")
    graph = data.cellwin[0]
    if graph is None:
        raise RuntimeError("the cellwin build declined: the slice would not run the kernels")
    rec = Record(cfg)
    model, history = train(cfg, callbacks=rec, train_data=data)
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES, "grid": grid_launches}
    log("main path launches: K1 %d, K2 %d, X2 %d" % (launches["fwd"], launches["bwd"],
                                                   launches["grid"]))
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
    log("the same step with the first versions of K1 and K2 (csrc/cellwin_v1.cu):")
    with first_versions():
        profile_v1 = profile_steps(cfg, data, card)

    # Kernels at the slice's own shapes, on the step's inputs at w=0.
    ps = points_at_w0(data, graph, DEVICE)
    with torch.no_grad():
        k = compare_kernels(ps, graph, seed=2, label="slice", card=card)
    return {
        "launches": launches, "kernels": k, "step_ms": step_ms, "prep_s": prep_s,
        "loss_rel": loss_rel, "w_rel": w_rel, "w_final": w_final, "profile": profile,
        "profile_v1": profile_v1, "graph": graph, "ps": ps, "data": data, "cfg": cfg,
    }


@contextlib.contextmanager
def first_versions():
    """The training step's K1 and K2 swapped for their first versions (the
    step calls the wrappers through ops/cellwin.py's module names)."""
    from depth_correction_tpu_torch.ops import cellwin as cw

    saved = cw.cellwin_fwd, cw.cellwin_bwd
    cw.cellwin_fwd, cw.cellwin_bwd = cw.cellwin_fwd_v1, cw.cellwin_bwd_v1
    try:
        yield
    finally:
        cw.cellwin_fwd, cw.cellwin_bwd = saved


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
    launches = {"slab": _kernels.SLAB_LAUNCHES, "gather": _kernels.GATHER_LAUNCHES,
                "grid": _kernels.GRID_LAUNCHES}
    kept = int(outs[4].sum())
    log("%s: %d raw points, padded %d, %d kept, %d corrected; launches X1 %d, P7 %d, X2 %d"
        % (label, len(scan), cloud.size, kept, int(outs[3].sum()), launches["slab"],
           launches["gather"], launches["grid"]))
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
    # Bound: every row of a live tile tests every slot of its three spans
    # (~8 float ops) and accumulates each member (~19); bytes: positions,
    # validity, span tables and centres read once, (10, n) written once.
    n, t = pts_T.shape[1], lo.shape[0]
    live = valid.reshape(t, -1).any(1)
    pairs = int((width.long().sum(1) * live).sum()) * (n // t)
    members = float(out[9][valid].sum())
    res["x1_bound"] = bound(n * (12 + 1 + 40) + t * 36,
                            {"fp32": 8 * pairs + 19 * members + 30 * n})
    res["x1_ms"] = cuda_ms(lambda: slabwin.slab_window_kernel(pts_T, valid, lo, width, ctr, r2),
                           reps=50)
    res["x1_plain_ms"] = cuda_ms(
        lambda: slabwin.slab_window_moments_plain(pts_T, valid, lo, width, ctr, r2), reps=3)
    log("X1 timing (float32, node shapes): kernel %.4f ms vs plain %.4f ms (%s)"
        % (res["x1_ms"], res["x1_plain_ms"], card))
    res["scan"] = scan
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
    # Bound: each index, weight and point byte read once, (10, MQ) written
    # once; ~22 float ops per (row, neighbour).
    res["p7_bound"] = bound(mq * k * 8 + m * 12 + mq * 10 * 4, {"fp32": 22 * mq * k})
    pts_n3 = pts.T.contiguous()
    res["p7_plain_ms"] = cuda_ms(lambda: features.gather_moments_plain(pts_n3, idx, wp), reps=3)
    log("P7 timing (float32, probe shapes): kernel %.4f ms vs plain %.4f ms (%s)"
        % (res["p7_ms"], res["p7_plain_ms"], card))
    return res


def _window_bound(win, q, kw, passes: int) -> tuple:
    """Bound of one moment_window call (P3-P5) from its inputs: the span
    columns the spans need (features, 10 x 128 TF32 products per pass over
    the non-zero feature rows, and ~8 float ops per membership test), the
    window columns read once (the union of the spans' columns of a staged
    table), q, the tables and the (16, 128 T1) output."""
    import torch

    from depth_correction_tpu_torch.ops.moment_window import span_bounds

    t1, ns, s_len = kw["n_tiles"], kw["ns"], kw["s_len"]
    lo, hi = span_bounds(kw["lens"], kw.get("leads"), s_len, t1, ns)
    cols = int((hi - lo).clamp(min=0).sum())
    if "starts" in kw:
        col = torch.arange(s_len, device=lo.device)
        pos = kw["starts"].long()[..., None] + col
        read = ((col >= lo[..., None]) & (col < hi[..., None]) & (pos >= 0)
                & (pos < win.shape[1]))
        cols = int(read.sum())
        win_bytes = int(torch.unique(pos[read]).numel()) * 6 * 4
    else:
        win_bytes = ns * 6 * s_len * 4
    tables = sum(kw[k].numel() * 4 for k in ("lens", "starts", "leads", "ctr")
                 if isinstance(kw.get(k), torch.Tensor))
    nbytes = win_bytes + 3 * q.shape[1] * 4 + tables + 16 * 128 * t1 * 4
    ops = {"fp32": 8 * 128 * cols + 12 * cols}
    if passes:
        ops["tf32"] = passes * 2 * 10 * 128 * cols
    else:
        ops["fp32"] += 2 * 10 * 128 * cols
    return bound(nbytes, ops)


def phase_probes(card: str, graph, ps, kept: tuple):
    """The probe scripts P1-P5 on the card; each script's launches are
    counted alone. ``kept`` is K1's (kept pair tests, all pair tests, box
    tests) on ``graph`` (:func:`pairs_kept`), for P1's bound. Returns the
    kernels-line entries of P1-P5 and the slice table's pair tests and
    members (P1's counts)."""
    import torch

    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.ops.cellwin_knockout import cellwin_knockout_plain
    from depth_correction_tpu_torch.ops.moment_dot import moment_dot_plain
    from depth_correction_tpu_torch.ops.moment_window import moment_window_plain
    from depth_correction_tpu_torch.scripts import (
        exp_cellwin_knockout as p1, exp_mosaic_dot_probe as p2, exp_mosaic_dot_probe2 as p3,
        exp_mosaic_dot_probe3 as p4, exp_mosaic_dot_probe4 as p5,
    )

    failures = []

    def bar(ok: bool, what: str):
        if not ok:
            failures.append(what)

    # P1 on the slice's own table (the w = 0 positions of phase 3).
    r1, n1 = counted(lambda: p1.run(ps, graph), "KNOCKOUT_LAUNCHES")
    args = (graph.q_est, graph.est_sorted, graph.f_start, graph.f_len, graph.f_ctr, graph.r2)
    k1 = cw.cellwin_fwd(ps, *args)
    same = bit_equal(k1, r1["modes"]["full"]["out"])
    same_nc = bit_equal(k1, r1["modes"]["no_cull"]["out"])
    log("P1 on the slice's table: %d row tiles x %d, %d rows held, %d pair tests, %d members; "
        "full bit-equal to K1: %s, no_cull bit-equal to K1: %s"
        % (r1["t1"], r1["row_cap"], r1["rows"], r1["pairs"], r1["members"], same, same_nc))
    bar(same, "P1 full is not bit-equal to K1")
    bar(same_nc, "P1 no_cull is not bit-equal to K1")
    full_ms = r1["modes"]["full"]["ms"]
    for mode, e in r1["modes"].items():
        er = e["errors"]
        log("  P1 %-9s %9.4f ms  %5.0f%% of full; kernel alone %9.4f ms  %5.0f%%  %s"
            % (mode, e["ms"], 100.0 * e["ms"] / full_ms, e["kernel_ms"],
               100.0 * e["kernel_ms"] / r1["modes"]["full"]["kernel_ms"],
               ", ".join("%s %.3e" % kv for kv in sorted(er.items()))))
        bar(er["count"] == 0, "P1 %s member counts differ" % mode)
        if mode in ("full", "no_cull"):
            bar(er["mean_abs"] <= MEAN_ABS_BAR and er["comps_abs"] <= COMPS_ABS_BAR,
                "P1 full misses K1's bars: %s" % er)
        else:
            bar(er["rel"] <= PROBE_REL_BAR, "P1 %s misses %.0e: %s" % (mode, PROBE_REL_BAR, er))
    plain1 = cuda_ms(lambda: cellwin_knockout_plain(ps, *args, "full"), reps=1, warmup=1)
    full = r1["modes"]["full"]["errors"]
    entries = [{
        "name": "cellwin_knockout (P1)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/cellwin_knockout.cu",
        "replaces": "scripts/exp_cellwin_knockout.py:35", "launches": n1,
        "max_abs_err": max(full["mean_abs"], full["comps_abs"]),
        "ms": r1["modes"]["full"]["ms"], "plain_ms": plain1,
        "bound": cellwin_fwd_bound(graph, kept[0], r1["members"], kept[2]),
        "bound_all_pairs_ms": cellwin_fwd_bound(graph, r1["pairs"], r1["members"])[0],
        "library_ms": None, "variants": {m: e["ms"] for m, e in r1["modes"].items()}}]

    # P2 at the TPU script's shapes, with torch.bmm beside it.
    dev = torch.device(DEVICE)
    r2, n2 = counted(lambda: p2.run(dev, library=True), "DOT_LAUNCHES")
    for v, e in r2["variants"].items():
        log("  P2 %-7s %9.4f ms  oracle %.3e, plain f32 %.3e, f64 %.3e"
            % (v, e["ms"], e["oracle"], e["err32"], e["err64"]))
        bar(e["err32"] <= PROBE_REL_BAR, "P2 %s misses %.0e vs its plain version: %.3e"
            % (v, PROBE_REL_BAR, e["err32"]))
        if v in ("fp32", "tf32x3"):
            bar(e["oracle"] <= PROBE_REL_BAR, "P2 %s misses %.0e vs the oracle: %.3e"
                % (v, PROBE_REL_BAR, e["oracle"]))
    lib = r2["library"]
    log("  P2 torch.bmm (one call, the same %d products): fp32 %.4f ms, TF32 allowed %.4f ms; "
        "allow_tf32 back to %s" % (p2.T1, lib["fp32"], lib["tf32"],
                                   torch.backends.cuda.matmul.allow_tf32))
    a, b, _ = p2.inputs(dev)
    e = r2["variants"]["tf32x3"]
    dot_bytes = a.numel() * 4 + b.numel() * 4 + e["out"].numel() * 4
    entries.append({
        "name": "moment_dot (P2)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/moment_dot.cu",
        "replaces": "scripts/exp_mosaic_dot_probe.py:50", "launches": n2,
        "max_abs_err": e["abs64"], "ms": e["ms"],
        "plain_ms": cuda_ms(lambda: moment_dot_plain(a, b, p2.T1, "tf32x3"), reps=3, warmup=1),
        "bound": bound(dot_bytes, {"tf32": 3 * 2 * 16 * p2.NS * p2.S * p2.R * p2.T1}),
        "library_ms": lib["fp32"], "variants": {v: x["ms"] for v, x in r2["variants"].items()}})

    # P3-P5: the product with in-kernel operands; headline variants
    # tf32x3, E_all and J_all.
    win, q, ln = p3.inputs(dev)
    p3_kw = dict(n_tiles=p3.T1, ns=p3.NS, s_len=p3.S, lens=ln)
    cases = {
        "P3": (p3, "tf32x3", "scripts/exp_mosaic_dot_probe2.py:39",
               lambda: (win, q, p3_kw)),
        "P4": (p4, "E_all", "scripts/exp_mosaic_dot_probe3.py:133",
               lambda: p4.variant_args("E_all", p4.inputs(dev))),
        "P5": (p5, "J_all", "scripts/exp_mosaic_dot_probe4.py:66",
               lambda: p5.inputs(dev, ("J_all",))["J_all"]),
    }
    for label, (mod, head, replaces, head_args) in cases.items():
        res, n = counted(lambda: mod.run(dev), "WINDOW_LAUNCHES")
        for v, e in res["variants"].items():
            log("  %s %-18s %9.4f ms  %splain f32 %.3e, f64 %.3e"
                % (label, v, e["ms"], "oracle %.3e, " % e["oracle"] if "oracle" in e else "",
                   e["err32"], e["err64"]))
            bar(e["err32"] <= PROBE_REL_BAR, "%s %s misses %.0e vs its plain version: %.3e"
                % (label, v, PROBE_REL_BAR, e["err32"]))
            # fp32 and tf32x3 (every P4/P5 variant) are exact products of
            # float32 features: held against float64 too, except after the
            # epilogue, whose float32 division by s0 - 1 on few-member
            # columns measures float32 rounding, not the product.
            key = "oracle" if "oracle" in e else "err64"
            exact = v in ("fp32", "tf32x3") if label == "P3" else v in p4.VARIANTS[:3]
            if exact:
                bar(e[key] <= PROBE_REL_BAR, "%s %s misses %.0e vs float64: %.3e"
                    % (label, v, PROBE_REL_BAR, e[key]))
        hw, hq, hkw = head_args()
        prec = "tf32x3"
        e = res["variants"][head]
        entries.append({
            "name": "moment_window (%s)" % label, "route": "cuda",
            "source": "depth_correction_tpu_torch/csrc/moment_window.cu",
            "replaces": replaces, "launches": n, "max_abs_err": e["abs64"], "ms": e["ms"],
            "plain_ms": cuda_ms(lambda: moment_window_plain(hw, hq, p3.R2, prec=prec, **hkw),
                                reps=2, warmup=1),
            "bound": _window_bound(hw, hq, hkw, passes=3), "library_ms": None,
            "variants": {v: x["ms"] for v, x in res["variants"].items()}})

    log("probe table (ms per call, %s):" % card)
    log("  %-26s %10s %10s %10s  %s" % ("kernel", "ms", "plain ms", "bound ms", "variants"))
    for en in entries:
        log("  %-26s %10.4f %10.4f %10.4f  %s" % (
            en["name"], en["ms"], en["plain_ms"], en["bound"][0],
            ", ".join("%s %.4f" % kv for kv in en["variants"].items())))
    if failures:
        raise RuntimeError("probe bars missed: " + "; ".join(failures))
    return entries, (r1["pairs"], r1["members"])


def counted(fn, attr: str):
    """Run ``fn`` with the launch counts zeroed just before and read just
    after; raises if the counter ``attr`` of ops/_kernels.py stayed 0."""
    import torch

    from depth_correction_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    n = getattr(_kernels, attr)
    log("  script: %d launches (%s), %.2f s" % (n, attr, time.perf_counter() - t0))
    if n <= 0:
        raise RuntimeError("%s was not launched by its probe script" % attr)
    return res, n


def _f32_ulps(a, b) -> int:
    """Largest distance in float32 ulps between finite a and b."""
    import torch

    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def check_grid_query(label: str, points, valid, r: float, card: str) -> dict:
    """X2 on ``points`` (all rows query) against its plain twin on the card:
    top-k (k = the prep's suggest_k_max) and counts; timed; its bound from
    the runs it reads. Raises on a missed bar."""
    import torch

    from depth_correction_tpu_torch.ops import grid_hash as gh
    from depth_correction_tpu_torch.ops.knn import suggest_k_max

    k = suggest_k_max(points, r=r, valid_points=valid)
    grid, _ = gh._build_grid(points, valid, r, None, None)
    (pts_T, val_s, ids_s, order, mins, dims, cell, _) = grid
    r2 = torch.full((), r, dtype=torch.float32) ** 2
    args = (points, valid, pts_T, val_s, ids_s, order, mins, dims, r2)
    d, idx = gh.grid_query(*args, k, None, cell)
    counts = gh.grid_query(*args, 0, None, cell)
    torch.cuda.synchronize()
    # The plain twin's window: the JAX query's dense table and width.
    starts, width = gh._query_window(ids_s, int(dims.prod()))
    pd, pidx = gh._grid_query_plain(*args, k, width, cell, starts)
    pcounts = gh._grid_query_plain(*args, 0, width, cell, starts)
    fin = torch.isfinite(pd)
    same_idx = bool(torch.equal(idx, pidx))
    same_fin = bool(torch.equal(fin, torch.isfinite(d)))
    ulps = _f32_ulps(d[fin], pd[fin]) if same_fin and bool(fin.any()) else -1
    same_counts = bool(torch.equal(counts, pcounts))
    err = float((d[fin] - pd[fin]).abs().max()) if same_fin else float("inf")
    # The runs X2 reads: each valid query's 9 columns, [lower_bound(lo),
    # lower_bound(hi + 1)) in the sorted ids.
    col_ok, lo, hi, _, _ = gh._query_columns(points, mins, dims, cell)
    ids64 = ids_s.long()
    runs = torch.searchsorted(ids64, hi + 1) - torch.searchsorted(ids64, lo)
    pairs = int((torch.where(col_ok, runs, 0).sum(1) * valid).sum())
    members = int(counts.sum())
    log("X2 %s: %d points (%d valid), k %d (largest count %d), window %d; kernel vs plain: "
        "index tables equal %s, finite pattern equal %s, distances within %d ulp, counts equal "
        "%s; %d pair tests, %d members"
        % (label, points.shape[0], int(valid.sum()), k, int(counts.max()), width, same_idx,
           same_fin, ulps, same_counts, pairs, members))
    if not (same_idx and same_fin and 0 <= ulps <= 1 and same_counts):
        raise RuntimeError("X2 %s misses its bars against the plain twin" % label)
    n, nq = pts_T.shape[1], points.shape[0]
    res = {"k": k, "pairs": pairs, "members": members, "err": err, "idx": idx, "counts": counts,
           "ms": cuda_ms(lambda: gh.grid_query(*args, k, None, cell), reps=20),
           "counts_ms": cuda_ms(lambda: gh.grid_query(*args, 0, None, cell), reps=20),
           "plain_ms": cuda_ms(lambda: gh._grid_query_plain(*args, k, width, cell, starts),
                               reps=1, warmup=1),
           # Bound: 8 float ops per pair test; queries, the sorted table
           # (positions, ids, order) and the (Q, k) outputs moved once.
           "bound": bound(nq * 13 + n * 20 + nq * k * 8, {"fp32": 8 * pairs})}
    log("X2 %s timing (float32): top-%d %.4f ms, counts %.4f ms, plain %.4f ms, bound %.4f ms "
        "(%s) (%s)" % (label, k, res["ms"], res["counts_ms"], res["plain_ms"], res["bound"][0],
                       res["bound"][1], card))
    return res


def check_grid_node_neighbors(scan, ks) -> dict:
    """X2 at the grid node's shapes: the traced grid of 2^21 cells over the
    node scan's filtered float32 points, for each k of ``ks``, against the
    plain twin on the same grid, with the launch count zeroed just before
    each kernel call. Raises on a missed bar or when no row has more than
    the smallest k neighbours (the kernel's merge then drops keys)."""
    import numpy as np
    import torch

    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.node import _filter_impl, _grid_neighbors
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.preproc import pad_size

    cfg = node_config("grid")
    r = float(cfg.nn_r)
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))
    keep = _filter_impl(cloud, float(cfg.min_depth or 0.0), float(cfg.max_depth or np.inf),
                        float(cfg.grid_res or 0.0))
    points = cloud.replace(valid=keep).to_points()
    counts = _grid_neighbors(points, keep, r, 0, plain=True)
    res = {}
    for k in ks:
        _kernels.reset_launch_counts()
        d, idx = _grid_neighbors(points, keep, r, k, plain=False)
        torch.cuda.synchronize()
        launches = _kernels.GRID_LAUNCHES
        pd, pidx = _grid_neighbors(points, keep, r, k, plain=True)
        fin = torch.isfinite(pd)
        same_idx = bool(torch.equal(idx, pidx))
        same_fin = bool(torch.equal(fin, torch.isfinite(d)))
        ulps = _f32_ulps(d[fin], pd[fin]) if same_fin and bool(fin.any()) else -1
        res[k] = int((counts > k).sum())
        log("X2 grid node (traced grid, k %d): %d kept rows, %d with more than %d within r "
            "(largest count %d); kernel vs plain: index tables equal %s, finite pattern equal "
            "%s, distances within %d ulp; %d launch"
            % (k, int(keep.sum()), res[k], k, int(counts.max()), same_idx, same_fin, ulps,
               launches))
        if launches != 1 or not (same_idx and same_fin and 0 <= ulps <= 1):
            raise RuntimeError("X2 misses its bars against the plain twin at the grid node's "
                               "shapes (k %d)" % k)
    if res[min(ks)] <= 0:
        raise RuntimeError("no row of the grid node has more than %d neighbours: the top-k "
                           "cut was not exercised" % min(ks))
    return res


def phase_grid(card: str, data, cfg, scan):
    """X2 on the slice's global cloud and first scan, against its plain
    twin and scipy's float64 sets; X2 at the grid node's shapes; the
    node's grid engine on the bench node scan."""
    from depth_correction_tpu_torch.preproc import global_cloud
    from depth_correction_tpu_torch.scripts.exp_grid_prep_diff import scipy_pairs_differ

    r = float(cfg.nn_r)
    batch = data.batches[0]
    g = global_cloud(batch)
    res = {"global": check_grid_query("global cloud", g.get_points().contiguous(), g.valid, r,
                                      card)}
    scan0 = batch.cloud.map(lambda x: x[0])
    pts, valid = scan0.to_points().contiguous(), scan0.valid
    res["scan"] = check_grid_query("scan 0", pts, valid, r, card)
    # Against scipy's float64 sets on the scan's float32 points (the global
    # cloud's take minutes of host time: scripts/exp_grid_prep_diff.py).
    t0 = time.perf_counter()
    differ, worst = scipy_pairs_differ(pts, valid, res["scan"]["idx"], r)
    log("X2 scan 0 vs scipy float64 sets: %d ordered pairs differ, largest |d - r| %.3e m "
        "(bar %.1e m; %.1f s)" % (differ, worst, 1e-6 * r, time.perf_counter() - t0))
    if worst > 1e-6 * r:
        raise RuntimeError("X2 differs from scipy's sets away from the radius: %.3e" % worst)
    res["scipy_differ"] = differ

    # The node's own k, and a k below the scan's largest count, so the
    # kernel's merge drops keys.
    k_node = int(node_config("grid").nn_max_neighbors or 32)
    res["node_x2"] = check_grid_node_neighbors(scan, (k_node, GRID_CUT_K))
    # The node's grid engine on the bench node scan (phase 4's).
    node = drive_node(scan, node_config("grid"), card, "grid node", batches=3, reps=NODE_REPS,
                      e2e_reps=E2E_REPS)
    if node["launches"]["grid"] <= 0 or node["launches"]["gather"] <= 0:
        raise RuntimeError("X2 / P7 were not launched by the grid node: %s" % node["launches"])
    res["node"] = node
    return res


def phase_probes_p6_p8(card: str):
    """The P6 and P8 scripts on the card; each script's launches are counted
    alone. Returns their kernels-line entries."""
    import torch

    from depth_correction_tpu_torch.ops.gather_probe import gather_probe, gather_probe_plain
    from depth_correction_tpu_torch.ops.layout_probe import layout_probe, layout_probe_plain
    from depth_correction_tpu_torch.scripts import exp_mosaic_probe as p6
    from depth_correction_tpu_torch.scripts import exp_pallas_gather2 as p8

    dev = torch.device(DEVICE)
    failures = []
    r6, n6 = counted(lambda: p6.run(dev), "LAYOUT_LAUNCHES")
    r6b, n6b = counted(lambda: p6.run(dev, reps=1, first=200.0), "LAYOUT_LAUNCHES")
    for name, e in r6["probes"].items():
        e2 = r6b["probes"][name]
        log("  P6 %-22s %-4s (sum %.3e; x[0,0] = 200: %s, sum %.3e) %9.4f ms"
            % (name, "OK" if e["err"] == 0 else "FAIL", e["sum"],
               "OK" if e2["err"] == 0 else "FAIL", e2["sum"], e["ms"]))
        if e["err"] != 0 or e2["err"] != 0:
            failures.append("P6 %s differs from its plain version" % name)
    x = p6.inputs(dev)
    head = "dot_tlhs"
    # At these sizes the events time the host's issue rate; the profiler
    # gives the device time per call.
    busy6 = profile_calls(lambda: layout_probe(x, head), card, "call", n=20)["busy_ms"]
    ones = torch.ones((8, 128), device=dev)
    entries = [{
        "name": "layout_probe (P6)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/layout_probe.cu",
        "replaces": "scripts/exp_mosaic_probe.py:37", "launches": n6 + n6b,
        "max_abs_err": max(max(e["err"] for e in r["probes"].values()) for r in (r6, r6b)),
        "ms": r6["probes"][head]["ms"],
        "plain_ms": cuda_ms(lambda: layout_probe_plain(x, head), reps=20),
        # Bound: x read once and the (512, 128) output written once; three
        # TF32 passes of 2 x 512 x 128 x 8.
        "bound": bound(x.numel() * 4 + 4 * p6.S * 128, {"tf32": 3 * 2 * p6.S * 128 * 8}),
        "library_ms": cuda_ms(lambda: torch.matmul(x.T, ones), reps=20),
        "device_busy_ms": busy6,
        "variants": {n: e["ms"] for n, e in r6["probes"].items()}}]

    r8, n8 = counted(lambda: p8.run(dev), "GATHER_PROBE_LAUNCHES")
    for case, forms in r8["cases"].items():
        for form, e in forms.items():
            if e is None:
                log("  P8 %s %-7s n/a (the staged row does not fit one block's shared memory)"
                    % (case, form))
                continue
            log("  P8 %s %-7s %-4s err %.1e %9.4f ms"
                % (case, form, "OK" if e["err"] == 0 else "FAIL", e["err"], e["ms"]))
            if e["err"] != 0:
                failures.append("P8 %s %s differs from its plain version" % (case, form))
    xb, ib, axis = p8.inputs(dev)["B"]
    plain8 = cuda_ms(lambda: gather_probe_plain(xb, ib, axis), reps=20)
    busy8 = profile_calls(lambda: gather_probe(xb, ib, axis, "global"), card, "call",
                          n=20)["busy_ms"]
    entries.append({
        "name": "gather_probe (P8)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/gather_probe.cu",
        "replaces": "scripts/exp_pallas_gather2.py:35", "launches": n8,
        "max_abs_err": max(e["err"] for f in r8["cases"].values() for e in f.values() if e),
        "ms": r8["cases"]["B"]["global"]["ms"], "plain_ms": plain8,
        # Bound (case B): x, the indices and the output moved once.
        "bound": bound(xb.numel() * 4 + ib.numel() * 8, {"fp32": 0}),
        # The plain version is one PyTorch call (torch.gather).
        "library_ms": plain8, "device_busy_ms": busy8,
        "variants": {"%s_%s" % (c, f): e["ms"] for c, fs in r8["cases"].items()
                     for f, e in fs.items() if e}})
    if failures:
        raise RuntimeError("probe bars missed: " + "; ".join(failures))
    return entries


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
    log("median step: %.3f ms over steps 1..%d; prep %.1f s; device busy %.3f ms/step (first "
        "versions of K1, K2: %.3f); total %.1f s (%s)"
        % (res["step_ms"], STEPS - 1, res["prep_s"], res["profile"]["busy_ms"],
           res["profile_v1"]["busy_ms"], time.perf_counter() - t0, card))
    log("[phase 4] node (bench node scan, slab engine)")
    node = phase_node(card)
    log("[phase 5] node small scan (brute engine) and P7")
    small = phase_small(card)
    log("node_ms %.3f, node_e2e_ms %.3f, node_points %d; small scan (brute): node_ms %.3f, "
        "node_e2e_ms %.3f, node_points %d; total %.1f s (%s)"
        % (node["ms"], node["e2e_ms"], node["points"], small["ms"], small["e2e_ms"],
           small["points"], time.perf_counter() - t0, card))
    log("[phase 6] probes P1-P5 (depth_correction_tpu_torch/scripts)")
    probes, (pairs, members) = phase_probes(card, res["graph"], res["ps"],
                                            res["kernels"]["kept"]["fwd"])
    log("[phase 7] grid: X2 on the slice's clouds, the node's grid engine")
    grid = phase_grid(card, res["data"], res["cfg"], node["scan"])
    gnode = grid["node"]
    log("grid node: node_ms %.3f, node_e2e_ms %.3f, node_points %d; total %.1f s (%s)"
        % (gnode["ms"], gnode["e2e_ms"], gnode["points"], time.perf_counter() - t0, card))
    log("[phase 8] probes P6, P8 (depth_correction_tpu_torch/scripts)")
    probes += phase_probes_p6_p8(card)
    log("build + all phases: %.1f s (%s)" % (time.perf_counter() - t0, card))
    k = res["kernels"]
    g = res["graph"]
    kept_f, kept_b = k["kept"]["fwd"], k["kept"]["bwd"]
    kernels = [
        {"name": "cellwin_fwd (K1)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/cellwin.cu",
         "replaces": "depth_correction_tpu/ops/cellwin.py:700",
         "launches": res["launches"]["fwd"], "max_abs_err": k["fwd_err"],
         "ms": k["fwd_ms"], "v1_ms": k["fwd_v1_ms"], "kernel_ms": k["fwd_kernel_ms"],
         "v1_kernel_ms": k["fwd_v1_kernel_ms"], "plain_ms": k["fwd_plain_ms"],
         "bound": cellwin_fwd_bound(g, kept_f[0], members, kept_f[2]),
         "bound_all_pairs_ms": cellwin_fwd_bound(g, pairs, members)[0],
         "pairs_kept": kept_f[0], "library_ms": None},
        {"name": "cellwin_bwd (K2)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/cellwin.cu",
         "replaces": "depth_correction_tpu/ops/cellwin.py:837",
         "launches": res["launches"]["bwd"], "max_abs_err": k["bwd_err"],
         "ms": k["bwd_ms"], "v1_ms": k["bwd_v1_ms"], "kernel_ms": k["bwd_kernel_ms"],
         "v1_kernel_ms": k["bwd_v1_kernel_ms"], "plain_ms": k["bwd_plain_ms"],
         "bound": cellwin_bwd_bound(g, kept_b[0], members, kept_b[2]),
         "bound_all_pairs_ms": cellwin_bwd_bound(g, kept_b[1], members)[0],
         "pairs_kept": kept_b[0], "library_ms": None},
        {"name": "slab_window (X1)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/slabwin.cu",
         "replaces": "depth_correction_tpu/ops/slabwin.py:53",
         "launches": node["launches"]["slab"], "max_abs_err": node["x1_err"],
         "ms": node["x1_ms"], "plain_ms": node["x1_plain_ms"], "bound": node["x1_bound"],
         "library_ms": None},
        {"name": "gather_moments (P7)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/gather_moments.cu",
         "replaces": "scripts/exp_pallas_gather.py:83",
         "launches": small["launches"]["gather"], "max_abs_err": small["p7_err"],
         "ms": small["p7_ms"], "plain_ms": small["p7_plain_ms"], "bound": small["p7_bound"],
         "library_ms": None},
        {"name": "grid_query (X2)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/grid_query.cu",
         "replaces": "depth_correction_tpu/ops/grid_hash.py:108",
         "launches": res["launches"]["grid"], "max_abs_err": grid["global"]["err"],
         "ms": grid["global"]["ms"], "plain_ms": grid["global"]["plain_ms"],
         "bound": grid["global"]["bound"], "library_ms": None,
         "variants": {"global_counts": grid["global"]["counts_ms"], "scan": grid["scan"]["ms"],
                      "scan_counts": grid["scan"]["counts_ms"]}},
    ] + probes
    for en in kernels:
        en["bound_ms"], en["bound_by"] = en.pop("bound")
        log("%-26s %10.4f ms, bound %.4f ms (%s), %d launches" % (
            en["name"], en["ms"], en["bound_ms"], en["bound_by"], en["launches"]))
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
