"""Rigid alignment of two trajectories (SLAM path against tracker path).

Port of the JAX package's scripts/paths_alignment.py (reference:
scripts/paths_alignment:166-233): estimate the SE(3) transform aligning a
source path to a target path with Kabsch/Umeyama
(``ops.se3.absolute_orientation``), iterating nearest-point
correspondences when the paths are unsynchronized (small trajectory ICP),
and report the residuals before and after.

Inputs: two CSVs of positions (rows ``x y z`` or ``t x y z``); without
arguments a synthetic demo runs.

Usage: python -m depth_correction_tpu_torch.studies.paths_alignment
           [--source CSV --target CSV] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import add_device_arg, torch_device


def align_paths(source: np.ndarray, target: np.ndarray, iters: int = 10, paired: bool = None,
                device="cpu"):
    """SE(3) aligning ``source`` onto ``target`` (the transforms solved in
    float64 on ``device``).

    :param paired: rows correspond 1:1 (default: True when equal length).
        Unpaired paths iterate nearest-neighbor correspondences.
    :return: (T (4, 4), rms_before, rms_after).
    """
    from ..ops.se3 import absolute_orientation

    source = np.asarray(source, np.float64)
    target = np.asarray(target, np.float64)
    if paired is None:
        paired = len(source) == len(target)

    def solve(x, y):
        return absolute_orientation(torch.as_tensor(x.T, device=device),
                                    torch.as_tensor(y.T, device=device)).cpu().numpy()

    def rms(a, b):
        return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))

    if paired:
        T = solve(source, target)
        aligned = source @ T[:3, :3].T + T[:3, 3]
        return T, rms(source, target), rms(aligned, target)

    from scipy.spatial import cKDTree

    tree = cKDTree(target)
    T = np.eye(4)
    cur = source.copy()
    before = float(np.sqrt(np.mean(tree.query(cur, k=1, workers=-1)[0] ** 2)))
    for _ in range(iters):
        d, idx = tree.query(cur, k=1, workers=-1)
        T_step = solve(cur, target[idx])
        cur = cur @ T_step[:3, :3].T + T_step[:3, 3]
        T = T_step @ T
    after = float(np.sqrt(np.mean(tree.query(cur, k=1, workers=-1)[0] ** 2)))
    return T, before, after


def _load(path):
    rows = np.atleast_2d(np.genfromtxt(path))
    return rows[:, -3:]  # x y z (skip a leading time column if present)


def synthetic_paths(seed: int = 0):
    """A helix and a rotated, shifted, noisy copy of it (paths_alignment.py:88-97)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, 200)
    target = np.stack([np.cos(t) * 3, np.sin(t) * 3, 0.2 * t], axis=1)
    ang = 0.7
    R = np.asarray([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    source = (target - [1.0, 2.0, 0.5]) @ R  # misaligned copy
    source += 0.01 * rng.normal(size=source.shape)
    return source, target


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", default=None)
    p.add_argument("--target", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    device = torch_device(args.device)
    if args.source and args.target:
        source, target = _load(args.source), _load(args.target)
    else:
        print("no input CSVs; running the synthetic demo")
        source, target = synthetic_paths()

    T, before, after = align_paths(source, target, device=device)
    print("alignment transform:\n", np.array_str(T, precision=4))
    print("RMS residual: %.4g m -> %.4g m" % (before, after))
    return T, before, after


if __name__ == "__main__":
    main(sys.argv[1:])
