"""Localization accuracy from static-interval tracker data.

Port of the JAX package's scripts/localization_accuracy.py (reference:
scripts/localization_accuracy): detect the intervals where the tracked
sensor stood still (total-station crystal motion below a threshold), then
report the localization accuracy of the estimated poses inside them: the
mean position error against the tracker, and the rotation / translation
drift between consecutive static poses.

Input: a CSV ``t x y z`` of tracker positions plus a poses CSV of 4x4 rows
(slam_poses schema, reference: scripts/robot_data:190-204), or nothing: a
synthetic trajectory demonstrates the pipeline.

Usage: python -m depth_correction_tpu_torch.studies.localization_accuracy
           [--tracker CSV --poses CSV] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import add_device_arg, torch_device


def synthetic_tracks(n=120, seed=0):
    """Stop-and-go trajectory: 4 stations, noisy SLAM estimate."""
    rng = np.random.default_rng(seed)
    times = np.arange(n, dtype=np.float64) * 0.1
    stations = np.asarray([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [2.0, 2.0, 0.0], [0.0, 2.0, 0.0]])
    pos = np.zeros((n, 3))
    seg = n // 8
    for i in range(4):
        a, b = 2 * i * seg, (2 * i + 1) * seg
        pos[a:b] = stations[i]  # static interval
        if 2 * i + 2 <= 8:
            c = min((2 * i + 2) * seg, n)
            t = np.linspace(0, 1, c - b)[:, None]
            nxt = stations[(i + 1) % 4]
            pos[b:c] = stations[i] * (1 - t) + nxt * t  # moving
    T_est = np.tile(np.eye(4), (n, 1, 1))
    T_est[:, :3, 3] = pos + 0.02 * rng.normal(size=(n, 3))
    return times, pos, T_est


def station_errors(times, pos, T_est, min_duration: float = 1.0, max_motion: float = 0.01,
                   device="cpu"):
    """(static intervals, representative indices, position error, mean
    relative angle, mean relative offset); the errors None without an
    interval. The poses are compared in float64 on ``device``."""
    from ..metrics import localization_errors, static_intervals, tracker_position_error

    intervals = static_intervals(times, pos, min_duration=min_duration, max_motion=max_motion)
    if not intervals:
        return intervals, [], None, None, None
    # One representative pose and tracker position per static interval.
    idx = [a + (b - a) // 2 for a, b in intervals]
    T = torch.as_tensor(np.asarray(T_est)[idx], dtype=torch.float64, device=device)
    err = float(tracker_position_error(T, np.asarray(pos)[idx]))
    T_gt = np.tile(np.eye(4), (len(idx), 1, 1))
    T_gt[:, :3, 3] = np.asarray(pos)[idx]
    _, _, rel_angle, rel_offset = localization_errors(
        torch.as_tensor(T_gt, device=device), T)
    return (intervals, idx, err, float(rel_angle.mean()), float(rel_offset.mean()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tracker", default=None, help="CSV with rows 't x y z'")
    p.add_argument("--poses", default=None, help="CSV of 4x4 pose rows (16 values)")
    p.add_argument("--min-duration", type=float, default=1.0)
    p.add_argument("--max-motion", type=float, default=0.01)
    p.add_argument("--out", default="gen/localization_accuracy")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..utils.io import append

    device = torch_device(args.device)
    if args.tracker and args.poses:
        track = np.atleast_2d(np.genfromtxt(args.tracker))
        times, pos = track[:, 0], track[:, 1:4]
        T_est = np.genfromtxt(args.poses).reshape(-1, 4, 4)
    else:
        print("no input CSVs; running the synthetic stop-and-go demo")
        times, pos, T_est = synthetic_tracks()

    intervals, idx, err, rel_angle, rel_offset = station_errors(
        times, pos, T_est, args.min_duration, args.max_motion, device)
    print("static intervals:", intervals)
    if not intervals:
        print("no static intervals found")
        return None
    print("localization accuracy over %d static stations: position error "
          "%.4g m; rel angle %.4g rad, rel offset %.4g m"
          % (len(idx), err, rel_angle, rel_offset))
    os.makedirs(args.out, exist_ok=True)
    append(os.path.join(args.out, "localization_accuracy.csv"),
           "%d %.9g %.9g %.9g\n" % (len(idx), err, rel_angle, rel_offset))
    return err


if __name__ == "__main__":
    main(sys.argv[1:])
