"""The benchmark's open-box scene, made on the device from a seed.

A three-walled box (a floor and the walls at -y and -x) seen from a circle
of jittered viewpoints, as ``datasets/synthetic.OpenBoxDataset`` lays it
out, rewritten in torch so that a scene of a million points is drawn in a
few large calls on the card. Every number comes from ``torch.Generator``s
seeded from ``--seed`` and the scan's index, so one seed gives one scene on
any device of one kind, and the program and the reference get the same
scans.

A scan passes through what a recording and its loader do to it, in the
order of the program's ``create_dataset``: the depth bounds and the
voxel-grid thinning (one point a voxel, the one of lowest seeded rank) on
the clean points, when ``thin`` is set; then the known incidence-angle
depth bias (the inverse of a ScaledPolynomial, from the analytic normals);
then Gaussian range noise along the ray. A scan is handed on as a numpy
structured array of float64 ``x``, ``y``, ``z`` in the sensor's frame (the
viewpoint is the origin), with its 4 x 4 world pose.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["SceneParams", "open_box", "scan_seed", "structured"]

_MASK63 = (1 << 63) - 1


class SceneParams(dict):
    """The scene's keys of a configuration file (``scene``): ``n`` scans,
    ``size`` [x, y, z] m, ``height`` m, ``density`` points a square metre,
    ``min_depth`` / ``max_depth`` m, ``grid_res`` m (0: no thinning),
    ``bias_w`` / ``bias_exponent`` (the ScaledPolynomial injected),
    ``noise`` m (the range noise's sigma)."""

    @property
    def size(self):
        return tuple(float(s) for s in self["size"])


def scan_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit seed for scan ``index``'s ``stream`` of draws (a fixed mix
    of the run's seed, the index and the stream)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index) * 0xBF58476D1CE4E5B9
         + int(stream) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & ((1 << 64) - 1)
    x ^= x >> 32
    return x & _MASK63


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _euler_xyz(e: torch.Tensor) -> torch.Tensor:
    """3 x 3 rotation of extrinsic x, y, z angles (scipy's ``from_euler('xyz')``)."""
    cx, cy, cz = torch.cos(e)
    sx, sy, sz = torch.sin(e)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).reshape(3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).reshape(3, 3)
    return rz @ ry @ rx


def scan_pose(p: SceneParams, seed: int, i: int, device) -> torch.Tensor:
    """Scan ``i``'s world pose (4 x 4 float64): on a circle of radius a third
    of the box around its centre at ``height``, facing along the circle's
    angle, jittered by up to 0.1 rad and 0.1 m."""
    g = _gen(device, scan_seed(seed, i, 0))
    jitter = torch.rand(6, generator=g, device=device, dtype=torch.float64)
    a = i * 2.0 * math.pi / int(p["n"])
    e = 0.1 * jitter[:3]
    e = e + torch.tensor([0.0, 0.0, a], dtype=torch.float64, device=device)
    T = torch.eye(4, dtype=torch.float64, device=device)
    T[:3, :3] = _euler_xyz(e)
    sx, sy, _ = p.size
    T[:3, 3] = torch.tensor([math.cos(a) * sx / 3, math.sin(a) * sy / 3, float(p["height"])],
                            dtype=torch.float64, device=device) + 0.1 * jitter[3:]
    return T


def _box_points(p: SceneParams, seed: int, i: int, device):
    """World points of the box (floor, -y wall, -x wall) at ``density`` a
    square metre, uniform, and their analytic normals."""
    sx, sy, sz = p.size
    dens = float(p["density"])
    patches = [((sx, sy, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
               ((sx, 0.0, sz), (0.0, -sy / 2, sz / 2), (0.0, 1.0, 0.0)),
               ((0.0, sy, sz), (-sx / 2, 0.0, sz / 2), (1.0, 0.0, 0.0))]
    counts = []
    for size, _, _ in patches:
        ext = [s for s in size if s > 0.0]
        counts.append(max(int(dens * math.prod(ext)), 1))
    g = _gen(device, scan_seed(seed, i, 1))
    u = torch.rand(sum(counts), 3, generator=g, device=device, dtype=torch.float64) - 0.5
    size = torch.cat([torch.tensor(s, dtype=torch.float64, device=device).expand(c, 3)
                      for (s, _, _), c in zip(patches, counts)])
    off = torch.cat([torch.tensor(o, dtype=torch.float64, device=device).expand(c, 3)
                     for (_, o, _), c in zip(patches, counts)])
    nrm = torch.cat([torch.tensor(n, dtype=torch.float64, device=device).expand(c, 3)
                     for (_, _, n), c in zip(patches, counts)])
    return u * size + off, nrm


def _thin(pts: torch.Tensor, grid_res: float, g: torch.Generator) -> torch.Tensor:
    """Indices of one point a voxel of ``grid_res``: the lowest seeded rank
    wins; the kept indices in ascending order."""
    cell = torch.floor(pts / grid_res).to(torch.int64)
    cell = cell - cell.min(0).values
    dims = cell.max(0).values + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    rank = torch.rand(pts.shape[0], generator=g, device=pts.device, dtype=torch.float64)
    order = torch.argsort(rank, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    k = key[order]
    first = torch.ones_like(k, dtype=torch.bool)
    first[1:] = k[1:] != k[:-1]
    return torch.sort(order[first]).values


def open_box(params: dict, seed: int, device="cuda", ids=None, thin: bool = True) -> list:
    """The scans ``ids`` (default all ``n``) as (structured float64 x/y/z
    array in the sensor frame, (4, 4) float64 pose) pairs, made on
    ``device``."""
    p = SceneParams(params)
    ids = range(int(p["n"])) if ids is None else ids
    out = []
    for i in ids:
        T = scan_pose(p, seed, i, device)
        world, nrm = _box_points(p, seed, i, device)
        R, t = T[:3, :3], T[:3, 3]
        pts = (world - t) @ R            # the sensor frame: R^T (x - t)
        nrm = nrm @ R
        depth = pts.norm(dim=1)
        if thin:
            keep = torch.ones_like(depth, dtype=torch.bool)
            if p.get("min_depth"):
                keep &= depth >= float(p["min_depth"])
            if p.get("max_depth"):
                keep &= depth <= float(p["max_depth"])
            idx = torch.nonzero(keep).reshape(-1)
            if p.get("grid_res"):
                idx = idx[_thin(pts[idx], float(p["grid_res"]),
                                _gen(device, scan_seed(seed, i, 2)))]
            pts, nrm, depth = pts[idx], nrm[idx], depth[idx]
        dirs = pts / depth[:, None]
        w = torch.tensor(p.get("bias_w", [0.0]), dtype=torch.float64, device=device)
        ex = torch.tensor(p.get("bias_exponent", [4.0]), dtype=torch.float64, device=device)
        if bool((w != 0).any()):
            cos = (dirs * nrm).sum(1).abs().clamp(0.0, 1.0)
            gamma = torch.arccos(cos)
            bias = (gamma[:, None] ** ex) @ w
            depth = depth / (1.0 - bias)
        if float(p.get("noise", 0.0)):
            g = _gen(device, scan_seed(seed, i, 3))
            depth = depth + float(p["noise"]) * torch.randn(
                depth.shape, generator=g, device=device, dtype=torch.float64)
        out.append((structured((dirs * depth[:, None]).cpu().numpy()), T.cpu().numpy()))
    return out


def structured(pts: np.ndarray) -> np.ndarray:
    """(N, 3) float64 points as the datasets' structured x/y/z array."""
    arr = np.empty(len(pts), dtype=[("x", "f8"), ("y", "f8"), ("z", "f8")])
    arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    return arr
