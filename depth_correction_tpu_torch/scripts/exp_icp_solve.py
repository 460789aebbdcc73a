"""X6 (an ICP step's gate and normal equations, ``csrc/icp_solve.cu``) on
one CUDA card at the SLAM drift evaluation's shapes: the bench scene
(``scripts.SCENE``, r = 0.25, corrected by the paper's bias model, 5 mm
range noise: six scans of ~65,000 rows), scan 1 registered on scan 0 for
the single step.

It prints, as one JSON line (also written to
``chiprun_out/exp_icp_solve.json``):

- X6 against its plain twin on the same float32 inputs: the threshold and
  the inliers (equal) and the largest T gap;
- X6's time a step by CUDA events and by the profiler's kernel durations
  (its two kernels and the sort), each kernel's share, the plain twin's
  time (events; it reads two positions back each call) and the bound: the
  step's needed bytes once at 3.35 TB/s;
- three steps in turns, each in an alignment of 8 iterations (X3 then the
  step) and in ``slam_odometry`` over the six scans (ms a registered scan,
  the measure of ``slam_scan_ms``): ``twin`` (the plain twin, the step
  before X6, with masked_quantile's host read), ``device_pick`` (the same
  torch step with the quantile's two positions picked on the card, so no
  host read and no new kernel) and ``x6``; with the card's busy share and
  device operations under the profiler (the T read at the end included).

    python -m depth_correction_tpu_torch.scripts.exp_icp_solve [--reps 50]
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import time

import torch

from . import SCENE, bench_config, device_ms, kernel_ms, require_card

HBM_BYTES_PER_S = 3.35e12
ITERS = 8


def _scene(card):
    """The bench scene's corrected clouds on the card, their ground-truth
    poses, a perturbed odometry prior, and X6's inputs for scan 1 placed by
    its prior in scan 0."""
    from ..datasets import create_dataset
    from ..models import ScaledPolynomial
    from ..ops.knn import knn_d2
    from ..ops.se3 import transform_points
    from ..slam_eval import perturb_odometry, slam_clouds

    cfg = bench_config(card.type)
    cfg.depth_noise = 0.005
    ds = create_dataset(SCENE, cfg)
    ds = [ds[i] for i in range(len(ds))]
    model = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float32, device=card)
    clouds, poses = slam_clouds(ds, cfg, model)
    prior = perturb_odometry(poses, [1e-4] * 3 + [2.5e-3] * 3, seed=5)
    src, tgt = clouds[1], clouds[0].transform(
        torch.as_tensor(poses[0], dtype=torch.float32, device=card)).with_points()
    T = torch.as_tensor(prior[1], dtype=torch.float32, device=card)
    pts = transform_points(T, src.get_points())
    d2, idx = knn_d2(tgt.points, pts, k=1, valid_points=tgt.valid)
    step = {"T": T, "d2": d2[:, 0].contiguous(), "idx": idx[:, 0].contiguous(), "src_pts": pts,
            "src_valid": src.valid, "tgt_pts": tgt.points, "tgt_normals": tgt.normals}
    return step, src, tgt, clouds, prior


def _bytes(step, inliers: int) -> int:
    """The step's needed bytes: each row's d2, idx, validity and placed
    point once, each inlier's target point and normal once; T and the
    outputs are negligible."""
    return step["d2"].shape[0] * (4 + 4 + 1 + 12) + inliers * 24


def device_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """``ops/reduce.py``'s ``masked_quantile`` with its two order
    statistics' positions picked on the card: no host read."""
    x = x.reshape(-1)
    mask = mask.reshape(-1)
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    n = mask.sum()
    pos = q * torch.clamp(n - 1, min=0).to(x.dtype)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(x.dtype)
    v_lo, v_hi = xs[torch.stack([lo, hi]).clamp(0, x.shape[0] - 1)]
    return v_lo * (1.0 - frac) + v_hi * frac


@contextlib.contextmanager
def step_variant(name: str):
    """``slam_eval``'s ICP step as ``name``: ``x6`` (as it is), ``twin``
    (the plain twin: masked_quantile's host read) or ``device_pick`` (the
    twin with :func:`device_quantile`)."""
    from .. import slam_eval
    from ..ops import icp

    def twin(*args, plain=False):
        return icp.icp_update_plain(*args)

    update, quantile = slam_eval.icp_update, icp.masked_quantile
    if name != "x6":
        slam_eval.icp_update = twin
    if name == "device_pick":
        icp.masked_quantile = device_quantile
    try:
        yield
    finally:
        slam_eval.icp_update, icp.masked_quantile = update, quantile


def _kernel_shares(fn, reps: int) -> dict:
    """Device ms a call by kernel name, from one profile of ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return {e.key[:60]: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0}


def _busy_share(fn) -> tuple:
    """(the card's busy share of one call's wall time under the profiler,
    the device operations it ran: kernels, copies, memsets)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e6 / wall, len(spans)


def main(argv=None) -> None:
    import argparse

    from .. import slam_eval
    from ..ops import _kernels
    from ..ops.icp import icp_update, icp_update_plain
    from ..ops.knn import knn_d2
    from ..ops.reduce import masked_quantile
    from ..ops.se3 import transform_points

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    card = require_card()
    build = _kernels.build()
    lines = build["log"].splitlines()
    # ptxas's report of X6's kernels: each entry's line and the three after it.
    ptxas = [ln.strip() for i, line in enumerate(lines)
             if "Compiling entry function" in line and "icp_" in line for ln in lines[i:i + 4]]
    step, src, tgt, clouds, prior = _scene(card)
    q = 0.8
    out = {"card": torch.cuda.get_device_name(0), "rows": int(step["d2"].shape[0]),
           "targets": int(step["tgt_pts"].shape[0]), "build_s": build["seconds"]}

    stats = torch.empty(_kernels.ICP_STATS, dtype=torch.float64, device=card)
    T6, err6 = icp_update(*step.values(), q, stats=stats)
    T32, err32 = icp_update_plain(*step.values(), q)
    step64 = {k: (v.double() if v.is_floating_point() else v) for k, v in step.items()}
    T64, err64 = icp_update_plain(*step64.values(), q)
    stats = stats.cpu()
    ok = (step["idx"] >= 0) & step["src_valid"]
    d = torch.sqrt(step["d2"])
    thr = masked_quantile(d, ok, q)
    w = ok & (d <= thr)
    out.update(ok_rows=int(stats[29]), inliers=int(stats[28]), thr=float(stats[30]),
               thr_equal=float(stats[30]) == float(thr),
               thr_equal_device_pick=bool(torch.equal(device_quantile(d, ok, q), thr)),
               inliers_equal=int(stats[28]) == int(w.sum()),
               T_gap_f32_twin=float((T6.double() - T32.double()).abs().max()),
               T_gap_f64_twin=float((T6.double() - T64).abs().max()),
               err=[float(err6), float(err32), float(err64)])

    x6 = lambda: icp_update(*step.values(), q)  # noqa: E731
    twin = lambda: icp_update_plain(*step.values(), q)  # noqa: E731
    out["x6_ms_events"] = device_ms(x6, card, args.reps)
    out["x6_ms_device"] = kernel_ms(x6, card, args.reps)
    out["x6_kernels_ms"] = _kernel_shares(x6, args.reps)
    out["plain_ms_events"] = device_ms(twin, card, args.reps)
    out["bytes"] = _bytes(step, int(stats[28]))
    out["bound_ms"] = out["bytes"] / HBM_BYTES_PER_S * 1e3

    src_pts, tgt_pts, tgt_normals = src.get_points(), tgt.points, tgt.normals
    T0 = step["T"]

    def align():
        T = T0
        for _ in range(ITERS):
            pts = transform_points(T, src_pts)
            d2, idx = knn_d2(tgt_pts, pts, k=1, valid_points=tgt.valid)
            T, _ = slam_eval.icp_update(T, d2[:, 0], idx[:, 0], pts, src.valid, tgt_pts,
                                        tgt_normals, q)
        return T.cpu()

    def odometry():
        return slam_eval.slam_odometry(clouds, prior, n_iters=ITERS, inlier_ratio=q)

    names = ("twin", "device_pick", "x6")
    scans = len(clouds) - 1
    for label, fn, per in (("align", align, 1), ("odometry", odometry, scans)):
        results = {}
        for name in names:
            with step_variant(name):
                fn()
                results[name] = fn()
        times = {k: [] for k in names}
        for _ in range(10):
            for name in names + names[::-1]:
                with step_variant(name):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    times[name].append((time.perf_counter() - t0) * 1e3 / per)
        busy = {}
        for name in names:
            with step_variant(name):
                busy[name] = _busy_share(fn)
        unit = "ms" if per == 1 else "ms_per_scan"
        out["%s_%s" % (label, unit)] = {k: statistics.median(v) for k, v in times.items()}
        out["%s_%s_quartiles" % (label, unit)] = {k: statistics.quantiles(v, n=4)
                                                  for k, v in times.items()}
        out["%s_busy_share" % label] = {k: v[0] for k, v in busy.items()}
        out["%s_ops_per_%s" % (label, "iteration" if per == 1 else "scan")] = {
            k: v[1] / (ITERS if per == 1 else scans) for k, v in busy.items()}
        ref = torch.as_tensor(results["x6"]).double().cpu()
        out["%s_T_gap_to_x6" % label] = {
            k: float((torch.as_tensor(v).double().cpu() - ref).abs().max())
            for k, v in results.items() if k != "x6"}
    out["ptxas"] = ptxas
    line = json.dumps(out)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "exp_icp_solve.json"), "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
