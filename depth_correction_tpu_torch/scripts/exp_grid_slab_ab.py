"""X1 (the slab-window moments) and X2 (the grid radius search) against
their first versions (csrc/slabwin_v1.cu, csrc/grid_query_v1.cu) at the
main paths' shapes, on one CUDA card: each pair checked bit for bit and
timed in turns (first version, redesign, redesign, first version) by CUDA
events, with the share of pair tests X1's warp cull keeps (host model,
scripts/slab_cull.py).

- X2 on the bench slice's global cloud and first scan as prep establishes
  them (top-k at suggest_k_max, and counts), and on the grid node's traced
  grid of the bench node scan at k = 32 (the node's) and 16;
- X1 on the bench node scan's slab layout.

    python -m depth_correction_tpu_torch.scripts.exp_grid_slab_ab

chip_smoke.py phases 4 and 7 run the same comparisons (:func:`x1_ab`,
:func:`x2_ab`) inside its checks.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import bench_config, device_ms, in_turns, require_card

__all__ = ["NODE_SCENE", "grid_node_inputs", "in_turns", "node_slab_inputs", "slice_clouds",
           "x1_ab", "x2_ab"]

# bench.py:build_node_scan's scene.
NODE_SCENE = "open_box/n_6_size_20_20_5_height_1_density_215"


def _bit_equal(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def x2_ab(points, valid, r: float, k: int, reps: int = 20, grid=None) -> dict:
    """X2 and its first version on ``points`` (every row queries) at top-k
    and counts: ``equal`` (index tables, distances bit for bit, counts),
    the times in turns (``ms``, ``v1_ms``, ``counts_ms``, ``v1_counts_ms``),
    the redesign's times with the queries in their own order instead of the
    grid's (``own_order_ms``, ``own_order_counts_ms``) and the outputs.
    ``grid``: the sorted grid to query (default ``_build_grid`` of the
    points, as prep builds it)."""
    from ..ops import grid_hash as gh

    if grid is None:
        grid = gh._build_grid(points, valid, r, None, None)[0][:7]
    pts_T, val_s, ids_s, order, mins, dims, cell = grid
    r2 = torch.full((), r, dtype=torch.float32) ** 2
    args = (points, valid, pts_T, val_s, ids_s, order, mins, dims, r2)

    def new(kk, own_points=True):
        return lambda: gh.grid_query(*args, kk, None, cell, own_points=own_points)

    def old(kk):
        return lambda: gh.grid_query_v1(*args, kk, None, cell)

    d, idx = new(k)()
    d1, idx1 = old(k)()
    counts, counts1 = new(0)(), old(0)()
    torch.cuda.synchronize()
    equal = {"idx": bool(torch.equal(idx, idx1)), "d": _bit_equal(d, d1),
             "counts": bool(torch.equal(counts, counts1))}
    dev = points.device
    v1_ms, ms, turns = in_turns(old(k), new(k), dev, reps)
    v1_counts_ms, counts_ms, cturns = in_turns(old(0), new(0), dev, reps)
    return {"k": k, "equal": equal, "ms": ms, "v1_ms": v1_ms, "counts_ms": counts_ms,
            "v1_counts_ms": v1_counts_ms, "turns": turns, "counts_turns": cturns,
            "own_order_ms": device_ms(new(k, False), dev, reps),
            "own_order_counts_ms": device_ms(new(0, False), dev, reps),
            "d": d, "idx": idx, "counts": counts, "largest_count": int(counts.max())}


def x1_ab(pts_T, valid, lo, width, ctr, r2: float, reps: int = 50) -> dict:
    """X1 and its first version on one slab layout: ``equal`` (bit for bit),
    the times in turns, and the host model's pair tests (``kept``, ``all``,
    ``box``)."""
    from ..ops import slabwin
    from . import slab_cull

    out = slabwin.slab_window_kernel(pts_T, valid, lo, width, ctr, r2)
    ref = slabwin.slab_window_kernel_v1(pts_T, valid, lo, width, ctr, r2)
    torch.cuda.synchronize()
    v1_ms, ms, turns = in_turns(
        lambda: slabwin.slab_window_kernel_v1(pts_T, valid, lo, width, ctr, r2),
        lambda: slabwin.slab_window_kernel(pts_T, valid, lo, width, ctr, r2), pts_T.device,
        reps)
    t0 = time.perf_counter()
    kept, all_pairs, box = slab_cull.cull_pair_tests(pts_T, valid, lo, width, ctr, r2)
    return {"equal": _bit_equal(out, ref), "ms": ms, "v1_ms": v1_ms, "turns": turns,
            "kept": kept, "all": all_pairs, "box": box, "model_s": time.perf_counter() - t0,
            "out": out}


def slice_clouds(device):
    """The bench slice's global cloud and first scan as prep builds them
    (filtered feature clouds, ground-truth poses): ((points, valid) of the
    global cloud, (points, valid) of scan 0), float32 on ``device``."""
    from ..datasets import create_dataset
    from ..preproc import global_cloud, local_feature_cloud, pad_size, sequence_batch

    cfg = bench_config(str(device))
    ds = create_dataset(cfg.train_names[0], cfg)
    scans = [(scan, pose) for scan, pose in ds]
    pad = max(pad_size(len(s)) for s, _ in scans)
    clouds = [local_feature_cloud(s, cfg, pad_to=pad) for s, _ in scans]
    batch = sequence_batch(clouds, np.stack([np.asarray(p) for _, p in scans]))
    g = global_cloud(batch)
    scan0 = batch.cloud.map(lambda x: x[0])
    return ((g.get_points().contiguous(), g.valid),
            (scan0.to_points().contiguous(), scan0.valid), float(cfg.nn_r))


def _node_points(device, backend: str):
    """The bench node scan, padded and filtered as the node does: (config,
    points, keep)."""
    from ..cloud import Cloud
    from ..datasets.synthetic import OpenBoxDataset
    from ..node import _filter_impl
    from ..preproc import pad_size

    cfg = bench_config(str(device))
    cfg.nn_backend = backend
    scan = OpenBoxDataset(name=NODE_SCENE).local_cloud(0)
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=device)
    cloud = cloud.pad(pad_size(cloud.size))
    keep = _filter_impl(cloud, float(cfg.min_depth or 0.0), float(cfg.max_depth or np.inf),
                        float(cfg.grid_res or 0.0))
    return cfg, cloud.replace(valid=keep).to_points(), keep


def grid_node_inputs(device):
    """The grid node's query on the bench node scan: (points, keep, r, the
    traced grid as node._grid_neighbors sorts it)."""
    from ..node import NODE_N_CELLS_PAD
    from ..ops.grid_hash import grid_sort_traced

    cfg, points, keep = _node_points(device, "grid")
    r = float(cfg.nn_r)
    return points, keep, r, grid_sort_traced(points, keep, r, NODE_N_CELLS_PAD)


def node_slab_inputs(device):
    """The slab node's X1 inputs on the bench node scan: (pts_T, valid, lo,
    width, ctr, r2)."""
    from ..node import NODE_N_CELLS_PAD, _slab_layout
    from ..ops.slabwin import slab_tile_spans

    cfg, points, keep = _node_points(device, "slab")
    pts_T, valid, ids, _, dims = _slab_layout(points, keep, cfg.nn_r)
    lo, width, ctr, _ = slab_tile_spans(pts_T, valid, ids, dims, NODE_N_CELLS_PAD)
    return pts_T, valid, lo, width, ctr, float(cfg.nn_r) ** 2


def _x2_line(label, res) -> str:
    return ("X2 %s: top-%d %.4f ms (first version %.4f; queries in their own order %.4f), "
            "counts %.4f ms (first version %.4f; own order %.4f); largest count %d; equal %s" % (
                label, res["k"], res["ms"], res["v1_ms"], res["own_order_ms"], res["counts_ms"],
                res["v1_counts_ms"], res["own_order_counts_ms"], res["largest_count"],
                res["equal"]))


def main(argv=None) -> int:
    from ..ops.knn import suggest_k_max

    device = require_card()
    t0 = time.perf_counter()
    x1 = x1_ab(*node_slab_inputs(device))
    print("X1 node scan: %.4f ms (first version %.4f; turns %s); bit-equal %s; host model: "
          "%d of %d pair tests kept (%.4f), %d box tests (%.1f s)"
          % (x1["ms"], x1["v1_ms"], ", ".join("%.4f" % t for t in x1["turns"]), x1["equal"],
             x1["kept"], x1["all"], x1["kept"] / x1["all"], x1["box"], x1["model_s"]),
          flush=True)
    ok = x1["equal"]
    points, keep, r, grid = grid_node_inputs(device)
    for k in (32, 16):
        res = x2_ab(points, keep, r, k, grid=grid)
        print(_x2_line("grid node", res), flush=True)
        ok &= all(res["equal"].values())
    (gp, gv), (sp, sv), r = slice_clouds(device)
    for label, (p, v) in (("global cloud", (gp, gv)), ("scan 0", (sp, sv))):
        res = x2_ab(p, v, r, suggest_k_max(p, r=r, valid_points=v))
        print(_x2_line(label, res), flush=True)
        ok &= all(res["equal"].values())
    print("%s; %.1f s" % (torch.cuda.get_device_name(device), time.perf_counter() - t0))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
