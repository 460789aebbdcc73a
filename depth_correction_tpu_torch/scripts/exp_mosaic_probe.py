"""The layout probes (P6) on the card.

Counterpart of scripts/exp_mosaic_probe.py, which ran seven tiny Pallas
kernels on x = arange(8 * 512).reshape(8, 512) float32 to see which vector
layouts Mosaic lowers. Here each probe is a CUDA kernel writing what the
Pallas body writes (ops/layout_probe.py, csrc/layout_probe.cu), and the
question is what each layout move costs on Hopper. For each probe: OK or
the mismatch against its plain version, the output's sum (as the TPU
script prints it) and ms per call, by the profiler's kernel durations and
by CUDA events, with torch.matmul(x.T, ones) beside dot_tlhs and
x.T.contiguous() beside transpose_f32 (yardsticks; the port never calls
them).

    python -m depth_correction_tpu_torch.scripts.exp_mosaic_probe
"""
from __future__ import annotations

import sys

import torch

from ..ops.layout_probe import PROBES, R, S, layout_probe, layout_probe_plain
from . import device_ms, kernel_ms, require_card

STEPS = 50


def inputs(device, first=None):
    """The script's input x (8, 512) float32 on ``device``; ``first`` sets
    x[0, 0] (the masks' length)."""
    x = torch.arange(8 * S, dtype=torch.float32).reshape(8, S)
    if first is not None:
        x[0, 0] = first
    return x.to(device)


def run(device, reps: int = STEPS, first=None) -> dict:
    """Time and check every probe on the script's input, by CUDA events (at
    this size they time the host's issue rate) and by the profiler's kernel
    durations; one PyTorch call computing the same layout is timed beside
    dot_tlhs (torch.matmul) and transpose_f32 (x.T.contiguous()).

    :return: {"probes": {name: {"ms", "kernel_ms", "sum", "err", "out"[,
        "library", "library_kernel_ms", "library_ms"]}}} with ``err`` the
        largest |kernel - plain| (float32 on the same input).
    """
    x = inputs(device, first)
    ones = torch.ones((8, R), dtype=x.dtype, device=device)
    library = {"dot_tlhs": ("torch.matmul", lambda: torch.matmul(x.T, ones)),
               "transpose_f32": ("x.T.contiguous", lambda: x.T.contiguous())}
    res = {}
    for name in PROBES:
        def call(name=name):
            return layout_probe(x, name)

        ms = device_ms(call, device, reps)
        out = call()
        err = float((out - layout_probe_plain(x, name)).abs().max())
        res[name] = {"ms": ms, "kernel_ms": kernel_ms(call, device, reps),
                     "sum": float(out.double().sum()), "err": err, "out": out}
        if name in library:
            label, fn = library[name]
            if not torch.equal(fn(), layout_probe_plain(x, name)):
                raise RuntimeError("%s does not compute %s" % (label, name))
            res[name].update(library=label, library_kernel_ms=kernel_ms(fn, device, reps),
                             library_ms=device_ms(fn, device, reps))
    return {"probes": res}


def main() -> int:
    device = require_card()
    res = run(device)
    for name, e in res["probes"].items():
        lib = ("; %s %.4f ms (events %.4f)" % (e["library"], e["library_kernel_ms"],
                                              e["library_ms"]) if "library" in e else "")
        print("%-4s %-22s (sum %.3e)  %8.4f ms/call (kernel %8.4f)  max err vs plain %.1e%s"
              % ("OK" if e["err"] == 0 else "FAIL", name, e["sum"], e["ms"], e["kernel_ms"],
                 e["err"], lib))
    ok = all(e["err"] == 0 for e in res["probes"].values())
    print(torch.cuda.get_device_name(device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
