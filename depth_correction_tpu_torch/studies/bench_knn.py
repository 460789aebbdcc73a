"""Neighbour-engine scaling: the grid search (kernel X2) against the brute
search (kernel X3) and the host's scipy cKDTree.

Port of the JAX package's scripts/bench_knn.py: establishment at scale
(uniform points in a box scaled so a ball holds ~25 points whatever N),
r 0.25, k 48. Each engine is timed as the mean of ``--reps`` calls after
one warm-up, every call ending in a device synchronisation. At the sizes up
to 131,072 the grid's sets are compared with the brute search's, and with
scipy's float64 balls on the rows whose ball fits in k (a pair may differ
only within 1e-6 r of the radius, where float32 decides it).

Usage: python -m depth_correction_tpu_torch.studies.bench_knn [--sizes N,...]
           [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import add_device_arg, torch_device

SIZES = (131072, 524288, 1048576)
R, K = 0.25, 48
CHECK_MAX = 131072  # the sets are compared at sizes up to this
RADIUS_TIE_REL = 1e-6


def uniform_points(n: int, rng) -> np.ndarray:
    """~Indoor-map density after grid filtering: the box is scaled so the
    expected ball count is ~25 regardless of N (bench_knn.py:45-47)."""
    side = (n * (4.0 / 3.0) * np.pi / 25.0) ** (1.0 / 3.0) * 0.25
    return rng.uniform(0, side, (n, 3)).astype(np.float32)


def timeit(fn, device, reps: int = 3):
    """(mean seconds of ``reps`` calls after one warm-up, the last output);
    each call ends in a synchronisation."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        sync()
    return (time.perf_counter() - t0) / reps, out


def row_sets(idx: np.ndarray) -> list:
    return [frozenset(int(j) for j in row if j >= 0) for row in idx]


def scipy_mismatch(pts: np.ndarray, sets: list, balls: list, r: float, k: int) -> dict:
    """Rows whose within-r set differs from scipy's float64 ball, among
    those whose ball fits in ``k``; ``ties_only``: every differing pair
    lies within :data:`RADIUS_TIE_REL` r of the radius."""
    p64 = pts.astype(np.float64)
    rows, ties_only = 0, True
    fit = [len(b) <= k for b in balls]
    for i, (s, b) in enumerate(zip(sets, balls)):
        if not fit[i] or s == frozenset(b):
            continue
        rows += 1
        diff = np.asarray(sorted(s.symmetric_difference(b)), np.int64)
        d = np.linalg.norm(p64[diff] - p64[i], axis=1)
        ties_only &= bool((np.abs(d - r) <= RADIUS_TIE_REL * r).all())
    return {"rows": rows, "ties_only": ties_only, "rows_fit": int(sum(fit))}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", default=",".join(str(n) for n in SIZES))
    p.add_argument("--reps", type=int, default=3)
    add_device_arg(p)
    args = p.parse_args(argv)

    from scipy.spatial import cKDTree

    from ..ops.grid_hash import grid_radius_neighbors
    from ..ops.knn import radius_neighbors

    device = torch_device(args.device)
    rng = np.random.default_rng(0)
    r, k = R, K
    rows = []
    for n in (int(s) for s in args.sizes.split(",")):
        pts = uniform_points(n, rng)
        dev = torch.as_tensor(pts, device=device)

        t_grid, (_, ig) = timeit(lambda: grid_radius_neighbors(dev, r=r, k=k), device,
                                 args.reps)
        row = "N=%8d  grid %8.1f ms" % (n, t_grid * 1e3)
        print(row, flush=True)
        t_scan, (_, it) = timeit(lambda: radius_neighbors(dev, r=r, k=k), device, args.reps)
        row += "  scan %8.1f ms" % (t_scan * 1e3)
        res = {"n": n, "grid_ms": t_grid * 1e3, "scan_ms": t_scan * 1e3}
        check = n <= CHECK_MAX
        if check:
            grid_sets = row_sets(ig.cpu().numpy())
            res["sets_equal"] = grid_sets == row_sets(it.cpu().numpy())
            row += "  sets_equal=%s" % res["sets_equal"]

        t0 = time.perf_counter()
        tree = cKDTree(pts)
        balls = tree.query_ball_point(pts, r, workers=-1)
        res["scipy_ms"] = (time.perf_counter() - t0) * 1e3
        row += "  scipy %8.1f ms" % res["scipy_ms"]
        sizes = np.array([len(b) for b in balls])
        res["ball_mean"], res["ball_max"] = float(sizes.mean()), int(sizes.max())
        row += "  (mean |ball| %.1f, max %d)" % (res["ball_mean"], res["ball_max"])
        if check:
            res["scipy"] = scipy_mismatch(pts, grid_sets, balls, r, k)
            row += "  scipy_sets: %d rows differ (radius ties only: %s)" % (
                res["scipy"]["rows"], res["scipy"]["ties_only"])
        print(row, flush=True)
        rows.append(res)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
