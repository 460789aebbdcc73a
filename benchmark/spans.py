"""The program's spans (``depth_correction_tpu_torch/utils/trace.py``) on
the card, after a cell's own set-up:

- ``cost``: what tracing costs: the host's microseconds a bare span (off,
  inside ``trace.recording()``, under a profiler), then a cell's items
  (registrations, steps, scans) with tracing off and inside
  ``trace.recording()``, in turns (off, on, on, off, ...);
- ``idle``: one profiled pass of a cell's items (CPU and CUDA activities)
  and its device-idle time by the span open on the host
  (``trace.idle_by_span``), the attribution the benchmark's profile, which
  keeps device operations only, cannot make.

    python3 benchmark/spans.py cost|idle [--cells box_r25.slam,...]
        [--rounds 8] [--seed n] [--seconds 1]

Prints one JSON line each. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def _items(cell, state):
    """(a call that runs some items, the items it runs)."""
    kind = cell.traffic["driver"]
    if kind == "slam":
        from depth_correction_tpu_torch.slam_eval import slam_odometry

        t = cell.traffic
        return (lambda: slam_odometry(state["clouds"], state["priors"], int(t["n_iters"]),
                                      float(t["inlier_ratio"])), len(state["clouds"]) - 1)
    if kind == "train":
        return (lambda: cell.driver._run(state), int(state["cfg"].n_opt_iters))

    def scans():
        for scan in state["pool"]:
            state["corrector"].process(scan)

    return scans, len(state["pool"])


def measure(name: str, rounds: int, seed: int, seconds: float) -> dict:
    """The cell's ms an item off and inside ``trace.recording()``, in
    turns, each measurement about ``seconds`` long."""
    import torch

    from depth_correction_tpu_torch.utils import trace

    cell = harness.Cell(name, harness.load_manifest(unproven=True))
    state = cell.driver.setup(cell, seed, "cuda")
    one, items = _items(cell, state)
    t0 = time.perf_counter()
    one()
    reps = max(1, int(seconds / (time.perf_counter() - t0)))
    ms = {"off": [], "on": []}
    spans = 0
    for r in range(rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            trace.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace.recording() if mode == "on" else contextlib.nullcontext():
                for _ in range(reps):
                    one()
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3 / (reps * items))
            if mode == "on":
                spans = len(trace.records()) / (reps * items)
    trace.reset()
    diff = [b - a for a, b in zip(ms["off"], ms["on"])]
    return {"cell": name, "card": torch.cuda.get_device_name(0), "items_a_round": reps * items,
            "off_ms": statistics.median(ms["off"]), "on_ms": statistics.median(ms["on"]),
            "diff_ms": diff, "diff_median_ms": statistics.median(diff),
            "spans_an_item": spans, "off_all": ms["off"], "on_all": ms["on"]}


def span_us(n: int = 200_000) -> dict:
    """The host's microseconds a span (enter and exit, nothing inside):
    off, inside ``trace.recording()``, and under a CPU profiler session
    (a tenth as many spans)."""
    from torch.profiler import ProfilerActivity, profile

    from depth_correction_tpu_torch.utils import trace

    out = {}
    for mode in ("off", "on", "profiled", "off", "on", "profiled"):
        trace.reset()
        k = n // 10 if mode == "profiled" else n
        with (trace.recording() if mode == "on" else
              profile(activities=[ProfilerActivity.CPU]) if mode == "profiled" else
              contextlib.nullcontext()):
            t0 = time.perf_counter()
            for _ in range(k):
                with trace.span("icp.gate"):
                    pass
            us = (time.perf_counter() - t0) * 1e6 / k
        out.setdefault("span_%s_us" % mode, []).append(us)
    trace.reset()
    return out


def idle(name: str, seed: int) -> dict:
    """One profiled pass of the cell's items: its wall and the device-idle
    ms by span, an item. A training cell's pass is ``fit``'s own trace of
    steps 2-6 (``Config.profile_dir``), read from the file it writes."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.profiling import PAD_S
    from depth_correction_tpu_torch.utils import trace

    cell = harness.Cell(name, harness.load_manifest(unproven=True))
    state = cell.driver.setup(cell, seed, "cuda")
    one, items = _items(cell, state)
    out = {"cell": name, "card": torch.cuda.get_device_name(0)}
    if cell.traffic["driver"] == "train":
        with tempfile.TemporaryDirectory() as tmp:
            state["cfg"].profile_dir = tmp
            one()
            with open(os.path.join(tmp, "idle_by_span_it002-006.json")) as f:
                by = json.load(f)
        return dict(out, items=5, idle_ms_an_item={k: v * 1e3 / 5 for k, v in by.items()})
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PAD_S)
    by = trace.idle_by_span(prof.events())
    trace.reset()
    return dict(out, items=items, wall_ms_an_item=wall * 1e3 / items,
                idle_ms_an_item={k: v * 1e3 / items for k, v in by.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("cost", "idle"))
    ap.add_argument("--cells", default="box_r25.slam,box_k32_scale.train,box_r25.node")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--seconds", type=float, default=1.0, help="a measurement's length")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    if args.what == "cost":
        print(json.dumps(span_us()), flush=True)
    for name in args.cells.split(","):
        out = (measure(name, args.rounds, args.seed, args.seconds) if args.what == "cost"
               else idle(name, args.seed))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
