"""The benchmark's general harness: it finds a cell's configuration,
traffic mix, driver, limits and per-layer metrics by name, runs set-up, the
measured window and the comparison with the plain reference, and prints
one result line.

Layout (every part found by the names in ``BENCHMARK.json``):

- ``configs/<config>.json``: ``settings`` applied to the program's
  ``Config``, ``scene`` (the generator's parameters), ``source``,
  ``reduced``, ``assumed``;
- ``traffic/<traffic>.json``: ``driver`` (a module of ``drivers/``) and its
  parameters;
- ``limits/<config>.<traffic>.json``: each compared number's limit;
- ``unproven.json``: the entries of cells that are built and calibrated
  but not in ``BENCHMARK.json`` (their runs do not hold a bound yet);
  ``run.py`` runs such a cell by name all the same;
- ``metrics/<metric>.py``, or ``metrics/<base>.py`` for every metric
  named ``<base>.<suffix>`` that has no file of its own: a reader
  ``read(ctx)``, None where it finds nothing to read.

A driver module defines ``setup(cell, seed, device) -> state``,
``window(state, seconds, capture) -> dict``, ``judge(state) -> dict`` and,
for ``calibrate.py``, ``calibrate(cell, seed, device, seconds,
with_control) -> dict`` (see ``drivers/train.py``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

__all__ = ["Cell", "FORBIDDEN", "forbidden_modules", "load_manifest",
           "print_checks", "run_cell"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "depth_correction_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load_manifest(root: str = ROOT, unproven: bool = False) -> dict:
    """``BENCHMARK.json``; with ``unproven`` also the entries of
    ``benchmark/unproven.json`` (cells built but not held to a bound yet)
    whose names the manifest does not have."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    if unproven:
        extra = _json(os.path.join(root, "benchmark", "unproven.json"))
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            have = {x["name"] for x in man[key]}
            man[key] = man[key] + [x for x in extra[key] if x["name"] not in have]
    return man


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest, with everything found by its names."""

    def __init__(self, name: str, manifest: dict, bench_dir: str = BENCH_DIR,
                 root: str = ROOT):
        work = {w["name"]: w for w in manifest["workloads"]}
        if name not in work:
            raise KeyError("no workload %r in BENCHMARK.json" % name)
        self.name = name
        self.workload = work[name]
        self.chips = int(self.workload.get("chips", 1))
        conf = {c["name"]: c for c in manifest["configs"]}[self.workload["config"]]
        self.config = _json(os.path.join(root, conf["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = _json(os.path.join(bench_dir, "traffic", self.traffic_name + ".json"))
        self.limits = _json(os.path.join(bench_dir, "limits", name + ".json"))
        self.bench_dir = bench_dir
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._reports(m)]
        self.driver = importlib.import_module("benchmark.drivers." + self.traffic["driver"])

    def _reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``metrics/<metric>.py`` or, where there is
        none, of ``metrics/<base>.py`` (``base`` the name before its first
        dot), which serves every metric of that base; ``ctx["metric"]``
        names the metric read."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        if not os.path.exists(path):
            path = os.path.join(self.bench_dir, "metrics", metric.split(".")[0] + ".py")
        name = os.path.basename(path)[:-3]
        spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(
            ".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return lambda ctx: mod.read(dict(ctx, metric=metric))


def device_info(count: int, device: str) -> dict:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                             for i in range(count)))}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda") -> dict:
    """Set-up, the window and the comparison of one run; returns the
    result line's object."""
    import torch

    from . import profiling

    drv = cell.driver
    state = drv.setup(cell, seed, device)
    capture = profiling.capture if trace else None
    setup_s = time.perf_counter() - t_start
    win = drv.window(state, seconds, capture)
    if device == "cuda":
        torch.cuda.synchronize()
    info = device_info(cell.chips, device)
    verdict = drv.judge(state)  # frees the program's state, then the reference
    checks = {}
    ok = not verdict.get("errors")
    for key, value in verdict["numbers"].items():
        limit = float(cell.limits[key])
        checks[key] = {"value": value, "limit": limit}
        ok = ok and value is not None and value == value and value <= limit
    metrics = {}
    ctx = {"cell": cell, "window": win, "verdict": verdict, "profile": win.get("profile"),
           "state": state}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = win.get("profile")
        if prof is not None:
            info["busy_s"] = prof.busy_s()
            info["window_s"] = prof.wall_s
    else:
        values = dict(win["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    out = {"correct": bool(ok), "attempted": int(win["attempted"]),
           "failed": int(win.get("failed", 0)) + int(verdict.get("failed", 0)),
           "metrics": metrics, "device": info}
    if trace and win.get("profile") is not None:
        prof = win["profile"]
        out["breakdown"] = {"device_ops": prof.top_ops(), "idle_gaps": prof.idle_gaps()}
    for e in verdict.get("errors", []):
        print("check error: %s" % e, file=sys.stderr)
    out["checks"] = checks
    return out


def print_checks(out: dict) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for key, c in out["checks"].items():
        v = c["value"]
        state = "ok" if (v is not None and v == v and v <= c["limit"]) else "FAIL"
        print("check %s %r limit %r %s" % (key, v, c["limit"], state), file=sys.stderr)
    print("correct %s" % str(out["correct"]).lower(), file=sys.stderr)
