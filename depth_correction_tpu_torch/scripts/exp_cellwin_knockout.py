"""Knockout profile of the cell-window forward kernel K1 on the card (P1).

Counterpart of scripts/exp_cellwin_knockout.py. The question it asks here:
where does K1's time go on an H100? It re-times K1 on the training slice's
real uncapped table with one part of its work removed at a time (each mode
a separate compile-time instance of K1's template, csrc/cellwin_fwd.cuh):

  full      K1 itself (bit-equal to ops.cellwin.cellwin_fwd)
  no_d2     membership test removed: every staged span entry is a member
  no_feats  features constant: every sum is the member count
  no_dot    the member count alone, no multiply-adds
  no_mask   no per-slot select: a {0, 1} weight multiplies every term
  empty     stage the spans and write q: the grid and staging floor
  no_cull   K1 with the warps' box cull off: full's output, and the time
            the cull saves

The TPU probe's dot1, kcat1 and kcat3 (arrangements of the matrix unit's
dot) have no counterpart in K1, which has no dot on this card; the
tensor-core product is asked about by exp_mosaic_dot_probe*.py. Each mode's
output is held against its float64 plain version on the same inputs.

    python -m depth_correction_tpu_torch.scripts.exp_cellwin_knockout [modes]

builds the slice's graph as chip_smoke.py does (the bench's uncapped
configuration, prep on the card, about a minute) and prints ms per mode.
"""
from __future__ import annotations

import sys

import torch

from ..ops.cellwin_knockout import MODES, cellwin_knockout, cellwin_knockout_plain
from . import bench_config, device_ms, kernel_ms, rel_rows, require_card

REPS = 20


def points_at_w0(data, graph, device):
    """The float32 points of ``data``'s first batch under a zero model (w =
    0), in ``graph``'s padded cell-sorted layout: K1's input at the step."""
    from ..models import ScaledPolynomial
    from ..ops.features import permute_rows
    from ..preproc import global_cloud

    with torch.no_grad():
        zero = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float32, device=device)
        return permute_rows(global_cloud(data.batches[0], model=zero).get_points(),
                            graph.perm, graph.inv).contiguous()


def slice_table(cfg):
    """Prep the slice of ``cfg`` and return (data, graph, points at w = 0 in
    the graph's layout)."""
    from ..datasets import create_dataset
    from ..train import prepare_sequences

    data = prepare_sequences([create_dataset(cfg.train_names[0], cfg)], cfg)
    graph = data.cellwin[0]
    if graph is None:
        raise RuntimeError("the cellwin build declined the slice")
    return data, graph, points_at_w0(data, graph, cfg.torch_device())


def knockout_errors(mode: str, got, ref, rows) -> dict:
    """``got`` against its float64 plain version ``ref`` on ``rows``:
    ``count`` (max abs difference of the member counts: row 9 of full and
    no_cull, rows 0..9 of no_feats, row 0 otherwise), ``rel`` (rel_rows
    over the ten rows); full and no_cull also ``mean_abs`` (m) and
    ``comps_abs`` (m^2)."""
    g, r = got.double()[:, rows], ref.double()[:, rows]
    count_rows = {"full": [9], "no_cull": [9], "no_feats": list(range(10)),
                  "empty": []}.get(mode, [0])
    d = (g - r).abs()
    out = {"rel": rel_rows(g, r),
           "count": float(d[count_rows].max()) if count_rows else 0.0}
    if mode in ("full", "no_cull"):
        out["mean_abs"] = float(d[0:3].max())
        out["comps_abs"] = float(d[3:9].max())
    return out


def run(pts_sorted, dev, modes=MODES, reps: int = REPS) -> dict:
    """Time every knockout mode on one table and hold its output against
    the float64 plain version.

    :param pts_sorted: (m_pad, 3) float32 positions in the graph's layout.
    :param dev: ``ops.cellwin.CellWinDevice`` on the same device.
    :return: {"modes": {mode: {"ms" (CUDA events), "kernel_ms" (the kernel's
        own time, torch.profiler), "out", "errors"}},
        "pairs" (membership tests: sum of span lengths x rows per tile),
        "members" (from full's counts), "rows" (real rows, exception rows
        excluded), "row_cap", "t1"}.
    """
    args = (dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    device = pts_sorted.device
    rows = (dev.row_map >= 0).clone()
    rows[dev.exc_slots] = False  # boundary rows: the gather path recomputes them
    p64 = pts_sorted.double()
    res = {}
    for mode in modes:
        def call(mode=mode):
            return cellwin_knockout(pts_sorted, *args, mode)

        ms = device_ms(call, device, reps)
        k_ms = kernel_ms(call, device, reps, warmup=0)
        out = call()
        res[mode] = {"ms": ms, "kernel_ms": k_ms, "out": out, "errors": knockout_errors(
            mode, out, cellwin_knockout_plain(p64, *args, mode), rows)}
    t1 = dev.f_start.shape[0]
    row_cap = dev.q_est.shape[1] // t1
    out = {"modes": res, "rows": int(rows.sum()), "row_cap": row_cap, "t1": t1,
           "pairs": int(dev.f_len.long().sum()) * row_cap}
    if "full" in res:
        s0 = res["full"]["out"][9]
        out["members"] = int(torch.round(s0[s0 >= 1.0]).sum())
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    modes = tuple(argv[0].split(",")) if argv else MODES
    device = require_card()
    cfg = bench_config(str(device))
    data, graph, ps = slice_table(cfg)
    res = run(ps, graph, modes)
    print("table: %d row tiles x %d rows, %d real rows, %d pair tests, %s members"
          % (res["t1"], res["row_cap"], res["rows"], res["pairs"], res.get("members", "-")))
    print("%-10s %10s %10s  %s" % ("mode", "ms", "kernel ms", "vs float64 plain"))
    for mode, e in res["modes"].items():
        print("%-10s %10.4f %10.4f  %s" % (mode, e["ms"], e["kernel_ms"], ", ".join(
            "%s %.3e" % kv for kv in sorted(e["errors"].items()))))
    print(torch.cuda.get_device_name(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
