"""A cell's whole run on the card (skips without one): one short run of
each cell prints its result line last, correct, with the device named."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_cuda_cell_runs_correct_on_the_card(card, cell):
    cmd = [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload", cell,
           "--seed", str(2 ** 31 + 2024), "--seconds", "2", "--trace", "0"]
    proc = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
