"""A street of box-shaped buildings and parked cars, made on the device from
a seed: the benchmark's stand-in for a 50-scan Semantic KITTI window (a car
driving down an urban street, a scan every metre).

Layout (world frame, metres; x along the street, z up):

- the ground: one rectangle at z = 0 under every point within
  ``max_depth`` of the drive;
- two rows of buildings facing each other across ``street_width``, blocks
  ``block`` long with ``gap`` between them, ``building_depth`` deep and
  ``building_height`` tall, the far row shifted by half a period: each
  block's façade and its two side walls;
- parked cars along both kerbs, ``kerb`` m in from the façades: boxes of
  ``car_size`` [length, width, height], one every ``car_every`` m, each its
  four sides and its roof.

Every surface lies half a ``grid_res`` off the faces of the voxels of that
size, so that range noise does not split one surface over two voxel
layers. The sensor drives along y = 0 at ``height``, scan ``i`` at x =
``i * step``, each pose jittered as ``scene.scan_pose`` jitters it (up to
0.1 rad about each axis and 0.1 m along each). Points are drawn uniform on
every surface at ``density`` a square metre, with no occlusion (as in the
open box), and each scan then passes through the open box's steps: the
depth bounds and the voxel thinning in the sensor's frame, the
incidence-angle bias from the analytic normals, the range noise. A scan is
handed on as ``scene.open_box`` hands it on.

Unlike the open box, whose far side sees the floor alone (x, y and the yaw
then have no constraint in a registration), every scan here sees surfaces
facing along x, y and z.
"""
from __future__ import annotations

import math

import torch

from .scene import _euler_xyz, _gen, _thin, scan_seed, structured

__all__ = ["scan_pose", "street", "surfaces"]


def _box(lo, hi, faces):
    """Rectangles (size, centre, normal) of the faces of the axis-aligned
    box [lo, hi] named in ``faces`` (``-x``, ``+x``, ``-y``, ``+y``, ``+z``)."""
    size = [h - l for l, h in zip(lo, hi)]
    mid = [(l + h) / 2 for l, h in zip(lo, hi)]
    out = []
    for f in faces:
        ax = "xyz".index(f[1])
        s, c = list(size), list(mid)
        s[ax] = 0.0
        c[ax] = hi[ax] if f[0] == "+" else lo[ax]
        n = [0.0, 0.0, 0.0]
        n[ax] = 1.0 if f[0] == "+" else -1.0
        out.append((s, c, n))
    return out


def surfaces(p: dict) -> list:
    """The street's rectangles (size [x, y, z] with one zero, centre,
    outward normal), the half-voxel shift applied."""
    reach = float(p["max_depth"])
    x0, x1 = -reach, (int(p["n"]) - 1) * float(p["step"]) + reach
    half = float(p["street_width"]) / 2
    block, gap = float(p["block"]), float(p["gap"])
    depth, tall = float(p["building_depth"]), float(p["building_height"])
    out = [([x1 - x0, 2 * reach, 0.0], [(x0 + x1) / 2, 0.0, 0.0], [0.0, 0.0, 1.0])]
    period = block + gap
    for side in (-1.0, 1.0):
        start = x0 - period - (period / 2 if side > 0 else 0.0)
        face = "+y" if side < 0 else "-y"
        ya, yb = sorted((side * half, side * (half + depth)))
        k = 0
        while start + k * period < x1:
            a = start + k * period
            out += _box([a, ya, 0.0], [a + block, yb, tall], [face, "-x", "+x"])
            k += 1
        length, width, high = (float(v) for v in p["car_size"])
        yc = side * (half - float(p["kerb"]))
        c = x0
        while c < x1:
            out += _box([c, yc - width / 2, 0.0], [c + length, yc + width / 2, high],
                        ["-x", "+x", "-y", "+y", "+z"])
            c += float(p["car_every"])
    shift = float(p["grid_res"]) / 2
    return [(s, [v + shift for v in c], n) for s, c, n in out]


def scan_pose(p: dict, seed: int, i: int, device) -> torch.Tensor:
    """Scan ``i``'s world pose (4 x 4 float64): at x = ``i * step`` on
    the street's axis at ``height``, facing along x, jittered as
    ``scene.scan_pose`` jitters a pose."""
    g = _gen(device, scan_seed(seed, i, 0))
    jitter = torch.rand(6, generator=g, device=device, dtype=torch.float64)
    T = torch.eye(4, dtype=torch.float64, device=device)
    T[:3, :3] = _euler_xyz(0.1 * jitter[:3])
    T[:3, 3] = torch.tensor([i * float(p["step"]), 0.0, float(p["height"])],
                            dtype=torch.float64, device=device) + 0.1 * jitter[3:]
    return T


def _points(rects, density: float, seed: int, i: int, device):
    """World points uniform on the rectangles at ``density`` a square
    metre, and their normals."""
    counts = [max(int(density * math.prod(x for x in s if x > 0.0)), 1) for s, _, _ in rects]
    g = _gen(device, scan_seed(seed, i, 1))
    u = torch.rand(sum(counts), 3, generator=g, device=device, dtype=torch.float64) - 0.5
    reps = torch.tensor(counts, device=device)

    def each(k):
        col = torch.tensor([r[k] for r in rects], dtype=torch.float64, device=device)
        return torch.repeat_interleave(col, reps, dim=0)

    return u * each(0) + each(1), each(2)


def street(params: dict, seed: int, device="cuda", ids=None) -> list:
    """The scans ``ids`` (default all ``n``) as (structured float64 x/y/z
    array in the sensor frame, (4, 4) float64 pose) pairs, made on
    ``device``."""
    rects = surfaces(params)
    ids = range(int(params["n"])) if ids is None else ids
    out = []
    for i in ids:
        T = scan_pose(params, seed, i, device)
        world, nrm = _points(rects, float(params["density"]), seed, i, device)
        R, t = T[:3, :3], T[:3, 3]
        pts = (world - t) @ R
        nrm = nrm @ R
        depth = pts.norm(dim=1)
        keep = (depth >= float(params["min_depth"])) & (depth <= float(params["max_depth"]))
        idx = torch.nonzero(keep).reshape(-1)
        idx = idx[_thin(pts[idx], float(params["grid_res"]), _gen(device, scan_seed(seed, i, 2)))]
        pts, nrm, depth = pts[idx], nrm[idx], depth[idx]
        dirs = pts / depth[:, None]
        w = torch.tensor(params["bias_w"], dtype=torch.float64, device=device)
        ex = torch.tensor(params["bias_exponent"], dtype=torch.float64, device=device)
        if bool((w != 0).any()):
            gamma = torch.arccos((dirs * nrm).sum(1).abs().clamp(0.0, 1.0))
            depth = depth / (1.0 - (gamma[:, None] ** ex) @ w)
        if float(params.get("noise", 0.0)):
            g = _gen(device, scan_seed(seed, i, 3))
            depth = depth + float(params["noise"]) * torch.randn(
                depth.shape, generator=g, device=device, dtype=torch.float64)
        out.append((structured((dirs * depth[:, None]).cpu().numpy()), T.cpu().numpy()))
    return out
