"""The moment product with operands built in the kernel (P3).

Counterpart of scripts/exp_mosaic_dot_probe2.py, with its seed and shapes:
T1 = 512 tiles, each summing over NS = 5 spans the product of features
(16, S = 640) and the membership wm (640, R = 128), both built in the
kernel from windows (NS, 8, S) of normal(0.2) coordinates and q (8, R),
span length S - 37, r^2 = 0.0625 (ops/moment_window.py). The question it
asks here: does building the operands in the kernel change what the
tensor-core product costs, and which precision holds? Variants as in
exp_mosaic_dot_probe.py (fp32, tf32, tf32x2, tf32x3 for the TPU's highest,
default, split2_bits, split3_bits); the TPU's wm_bits_split3 (one pass of
hi + mid + lo, which recombine to the features exactly) is tf32.

For each: ms per call, the error relative to max |oracle| (the float64
plain version in fp32: the exact product of float64 features), and the
error against the variant's own plain version in float32 and float64.

    python -m depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe2
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.moment_dot import PRECISIONS
from ..ops.moment_window import moment_window, moment_window_plain
from . import device_ms, rel_max, rel_rows, require_card

T1 = 512
NS = 5
S = 640
R = 128
STEPS = 30
R2 = 0.0625


def inputs(device):
    """The TPU script's data (default_rng(0), :110-113): windows (NS, 8, S)
    and q (8, R), float32 on ``device``; the span length."""
    rng = np.random.default_rng(0)
    win = rng.normal(scale=0.2, size=(NS, 8, S)).astype(np.float32)
    q = rng.normal(scale=0.2, size=(8, R)).astype(np.float32)
    return torch.as_tensor(win, device=device), torch.as_tensor(q, device=device), S - 37


def window_case(win, q, prec: str, reps: int, oracle=None, **kw) -> dict:
    """Time moment_window(win, q, prec=prec, **kw) and hold its output
    against the plain version in float32 and float64 (and ``oracle``).

    :return: {"ms", "out", "err32", "err64" (rel_rows), "abs64" (largest
        absolute difference from the float64 plain version)[, "oracle"
        (rel_max)]}.
    """
    def call():
        return moment_window(win, q, R2, prec=prec, **kw)

    def wide(t):
        return None if t is None else t.double()

    ms = device_ms(call, win.device, reps)
    out = call()
    ref64 = moment_window_plain(win.double(), q.double(), R2, prec=prec,
                                **dict(kw, ctr=wide(kw.get("ctr"))))
    entry = {"ms": ms, "out": out,
             "err32": rel_rows(out, moment_window_plain(win, q, R2, prec=prec, **kw)),
             "err64": rel_rows(out, ref64), "abs64": float((out.double() - ref64).abs().max())}
    if oracle is not None:
        entry["oracle"] = rel_max(out, oracle)
    return entry


def run(device, variants=PRECISIONS, reps: int = STEPS) -> dict:
    """Time and check every precision at the TPU script's shapes (:data:`T1`
    tiles).

    :return: {"variants": {prec: window_case(...) with "oracle"}}.
    """
    win, q, ln = inputs(device)
    kw = dict(n_tiles=T1, ns=NS, s_len=S, lens=ln)
    oracle = moment_window_plain(win.double(), q.double(), R2, prec="fp32", **kw)
    return {"variants": {v: window_case(win, q, v, reps, oracle=oracle, **kw)
                         for v in variants}}


def print_variants(res: dict, label: str) -> None:
    for v, e in res["variants"].items():
        extra = "%.2e vs oracle, " % e["oracle"] if "oracle" in e else ""
        print("%-22s %9.4f ms/call (%s)  %s%.2e / %.2e vs plain f32 / f64"
              % (v, e["ms"], label, extra, e["err32"], e["err64"]))


def main() -> int:
    device = require_card()
    print_variants(run(device), "%d tiles x %d spans" % (T1, NS))
    print(torch.cuda.get_device_name(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
