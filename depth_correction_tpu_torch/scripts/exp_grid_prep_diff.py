"""Why the bench slice's training graph differs between grid and scipy
establishment.

    python -m depth_correction_tpu_torch.scripts.exp_grid_prep_diff

Loads the scans of the bench slice (:func:`bench_config`) once and prepares
them four ways on the card:

- ``grid``: the grid search (kernel X2), each row's neighbours by distance;
- ``grid_index``: the same tables with each row reordered by index, which
  is scipy's order;
- ``grid_index_k``: that, cut to the longest row, which is scipy's K;
- ``scipy``: cKDTree on the host, the sets in float64.

Each prep prints its per-scan planar rows, the loss's query rows, their
members (the sum of their neighbour counts) and the graph's row tiles, and
how many rows' masks differ from scipy's prep. Then X2's sets on the global
cloud against scipy's float64 sets (:func:`scipy_pairs_differ`): a pair may
differ only within 1e-6 r of the radius, where float32 and float64 decide
membership apart.
"""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from . import bench_config, require_card

VARIANTS = ("grid", "grid_index", "grid_index_k", "scipy")


def scipy_pairs_differ(points, valid, idx, r: float):
    """A neighbour table ``idx`` (N, K) (K at least every count, -1
    padded) against scipy's float64 ball sets of the same valid points.
    Self pairs are left out of both.

    :return: (number of ordered pairs in one set only, the largest |d - r|
        among them in metres, 0.0 when none).
    """
    from scipy.spatial import cKDTree

    p64 = points.detach().double().cpu().numpy()
    n = len(p64)
    rows = np.flatnonzero(valid.cpu().numpy())
    pairs = cKDTree(p64[rows]).query_pairs(r, output_type="ndarray")  # i < j, d <= r
    a, b = rows[pairs[:, 0]], rows[pairs[:, 1]]
    want = np.concatenate([a * n + b, b * n + a])
    nn = idx.cpu().numpy().astype(np.int64)
    i = np.repeat(np.arange(n, dtype=np.int64), nn.shape[1])
    j = nn.reshape(-1)
    keep = (j >= 0) & (j != i)
    got = i[keep] * n + j[keep]
    diff = np.setxor1d(want, got)
    if not diff.size:
        return 0, 0.0
    pa, pb = diff // n, diff % n
    return int(diff.size), float(np.abs(np.linalg.norm(p64[pa] - p64[pb], axis=1) - r).max())


def _by_index(dist, idx, cut: bool):
    """Each row's neighbours in ascending index, -1 last; ``cut`` drops the
    columns past the longest row."""
    last = torch.iinfo(torch.int64).max
    key = torch.where(idx >= 0, idx.long(), torch.full_like(idx.long(), last))
    _, perm = torch.sort(key, dim=1, stable=True)
    dist, idx = torch.gather(dist, 1, perm), torch.gather(idx, 1, perm)
    if cut:
        k = max(int((idx >= 0).sum(1).max()), 1)
        dist, idx = dist[:, :k], idx[:, :k]
    return dist, idx


@contextlib.contextmanager
def _reordered(variant: str):
    """Reorder the device engines' tables for the ``grid_index*`` variants."""
    from .. import preproc

    engine = preproc._device_radius_neighbors
    if variant.startswith("grid_index"):
        preproc._device_radius_neighbors = lambda *a, **kw: _by_index(
            *engine(*a, **kw), cut=variant.endswith("_k"))
    try:
        yield
    finally:
        preproc._device_radius_neighbors = engine


def prep(scans, cfg, variant: str) -> dict:
    """One prep of the loaded ``scans``: its masks and graph sizes."""
    from ..train import prepare_sequences

    c = cfg.copy()
    if variant == "scipy":
        c.nn_backend = "scipy"
    t0 = time.perf_counter()
    with _reordered(variant):
        data = prepare_sequences([scans], c)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    batch, graph = data.batches[0], data.cellwin[0]
    scan_mask = batch.cloud.mask.reshape(-1)
    qrows = data.query_rows[0]
    query = torch.zeros_like(scan_mask)
    query[qrows[qrows >= 0]] = True
    return {"data": data, "scan_mask": scan_mask, "query": query, "seconds": seconds,
            "members": int(data.weights[0].sum()), "k": data.neighbors[0].shape[1],
            "tiles": None if graph is None else graph.f_start.shape[0]}


def run(device) -> dict:
    from ..datasets import create_dataset
    from ..preproc import establish_neighborhoods, global_cloud

    cfg = bench_config(str(device))
    t0 = time.perf_counter()
    scans = [(scan, pose) for scan, pose in create_dataset(cfg.train_names[0], cfg)]
    print("loaded %d scans in %.1f s" % (len(scans), time.perf_counter() - t0), flush=True)
    res = {v: prep(scans, cfg, v) for v in VARIANTS}
    ref = res["scipy"]
    for v in VARIANTS:
        e = res[v]
        print("%-13s K %4d: %d planar scan rows (%d differ from scipy's), %d query rows "
              "(%d differ), %d members, %s row tiles; prep %.1f s"
              % (v, e["k"], int(e["scan_mask"].sum()),
                 int((e["scan_mask"] != ref["scan_mask"]).sum()), int(e["query"].sum()),
                 int((e["query"] != ref["query"]).sum()), e["members"], e["tiles"],
                 e["seconds"]), flush=True)

    g = global_cloud(res["grid"]["data"].batches[0])
    r = float(cfg.nn_r)
    idx, _ = establish_neighborhoods(g, cfg)
    t0 = time.perf_counter()
    differ, worst = scipy_pairs_differ(g.get_points(), g.valid, idx, r)
    print("global cloud: %d points (%d valid), X2 K %d vs scipy float64 sets: %d ordered "
          "pairs differ, largest |d - r| %.3e m (bar %.1e m; %.1f s on the host)"
          % (g.size, int(g.valid.sum()), idx.shape[1], differ, worst, 1e-6 * r,
             time.perf_counter() - t0), flush=True)
    res["global"] = {"differ": differ, "worst": worst}
    return res


def main(argv=None) -> int:
    device = require_card()
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
