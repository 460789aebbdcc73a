"""Shared helpers of the benchmark's tests: a tiny copy of a cell (the same
configuration and traffic at a few thousand points) run on the CPU."""
from __future__ import annotations

import copy
import json
import os
import time

from benchmark import harness

TINY_SCENE = {"n": 3, "size": [4.0, 4.0, 2.0], "density": 200.0}


def tiny_cell(name: str, tmp_path, scene=None, traffic=None) -> harness.Cell:
    """The manifest's cell ``name`` with its configuration's scene cut to
    ``TINY_SCENE`` (written under ``tmp_path``) and its traffic updated
    with ``traffic``."""
    man = copy.deepcopy(harness.load_manifest(unproven=True))
    work = {w["name"]: w for w in man["workloads"]}[name]
    for c in man["configs"]:
        if c["name"] == work["config"]:
            conf = json.load(open(os.path.join(harness.ROOT, c["file"])))
            conf["scene"].update(TINY_SCENE if scene is None else scene)
            path = os.path.join(str(tmp_path), "tiny_%s.json" % c["name"])
            with open(path, "w") as f:
                json.dump(conf, f)
            c["file"] = path
    cell = harness.Cell(name, man)
    if traffic:
        cell.traffic = dict(cell.traffic, **traffic)
    return cell


TINY_TRAFFIC = {"box_r25.train": {"steps_per_run": 5},
                "box_k32_scale.train": {"steps_per_run": 5},
                "box_r25.node": {"density": 20.0, "pool": 2, "sample": 3},
                "box_r25.slam": {}}


def run_tiny(name: str, tmp_path, seconds: float = 0.5, seed: int = 2 ** 31 + 11) -> dict:
    cell = tiny_cell(name, tmp_path, traffic=TINY_TRAFFIC[name])
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(), device="cpu")
