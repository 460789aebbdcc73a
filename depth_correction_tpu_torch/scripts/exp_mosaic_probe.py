"""The layout probes (P6) on the card.

Counterpart of scripts/exp_mosaic_probe.py, which ran seven tiny Pallas
kernels on x = arange(8 * 512).reshape(8, 512) float32 to see which vector
layouts Mosaic lowers. Here each probe is a CUDA kernel writing what the
Pallas body writes (ops/layout_probe.py, csrc/layout_probe.cu), and the
question is what each layout move costs on Hopper. For each probe: OK or
the mismatch against its plain version, the output's sum (as the TPU
script prints it) and ms per call.

    python -m depth_correction_tpu_torch.scripts.exp_mosaic_probe
"""
from __future__ import annotations

import sys

import torch

from ..ops.layout_probe import PROBES, S, layout_probe, layout_probe_plain
from . import device_ms, require_card

STEPS = 50


def inputs(device, first=None):
    """The script's input x (8, 512) float32 on ``device``; ``first`` sets
    x[0, 0] (the masks' length)."""
    x = torch.arange(8 * S, dtype=torch.float32).reshape(8, S)
    if first is not None:
        x[0, 0] = first
    return x.to(device)


def run(device, reps: int = STEPS, first=None) -> dict:
    """Time and check every probe on the script's input.

    :return: {"probes": {name: {"ms", "sum", "err", "out"}}} with ``err``
        the largest |kernel - plain| (float32 on the same input).
    """
    x = inputs(device, first)
    res = {}
    for name in PROBES:
        def call(name=name):
            return layout_probe(x, name)

        ms = device_ms(call, device, reps)
        out = call()
        err = float((out - layout_probe_plain(x, name)).abs().max())
        res[name] = {"ms": ms, "sum": float(out.double().sum()), "err": err, "out": out}
    return {"probes": res}


def main(argv=None) -> int:
    device = require_card()
    res = run(device)
    for name, e in res["probes"].items():
        print("%-4s %-22s (sum %.3e)  %8.4f ms/call  max err vs plain %.1e"
              % ("OK" if e["err"] == 0 else "FAIL", name, e["sum"], e["ms"], e["err"]))
    print(torch.cuda.get_device_name(device))
    return 0 if all(e["err"] == 0 for e in res["probes"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
