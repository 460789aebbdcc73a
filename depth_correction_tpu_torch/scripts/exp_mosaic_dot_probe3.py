"""Which structural piece of K1 makes the moment product slow (P4).

Counterpart of scripts/exp_mosaic_dot_probe3.py, with its seed and shapes
(T1 = 512, NS = 5, S = 640, R = 128; every variant tf32x3, the TPU's
split3_bits). The TPU probe bisected which piece of its forward kernel
defeated Mosaic's lowering; here each piece is a compile-time switch of
csrc/moment_window.cu, added one at a time on top of P3's kernel:

  A_baseline         P3's structure: fixed windows, one span length
  B_scalar_prefetch  span lengths from a (T1, NS) device table (the TPU's
                     scalar-prefetch table is a plain table here)
  C_any_dma          + spans read from a big (8, T1 256 + S) table at
                     per-span starts (the TPU's span DMAs and semaphores:
                     here plain bounded loads into shared memory)
  D_epilogue         A + the division epilogue (:86-98)
  E_all              C + D (the TPU kernel's shape)

For each: ms per call and the error against its plain version in float32
and float64 (the float64 one is the exact product: tf32x3 is exact for
float32 features).

    python -m depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe3
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .exp_mosaic_dot_probe2 import NS, R, S, print_variants, window_case
from . import require_card

T1 = 512
STEPS = 20
PREC = "tf32x3"
VARIANTS = ("A_baseline", "B_scalar_prefetch", "C_any_dma", "D_epilogue", "E_all")


def inputs(device):
    """The TPU script's data (default_rng(0), :100-105), on ``device``."""
    rng = np.random.default_rng(0)
    win = rng.normal(scale=0.2, size=(NS, 8, S)).astype(np.float32)
    q = rng.normal(scale=0.2, size=(8, R)).astype(np.float32)
    big = rng.normal(scale=0.2, size=(8, T1 * 256 + S)).astype(np.float32)
    starts = (rng.integers(0, T1 * 2, T1 * NS) * 128).astype(np.int32)
    lens = np.full(T1 * NS, S - 37, np.int32)

    def t(x):
        return torch.as_tensor(x, device=device)

    return {"win": t(win), "q": t(q), "big": t(big),
            "starts": t(starts.reshape(T1, NS)), "lens": t(lens.reshape(T1, NS))}


def variant_args(name: str, d: dict) -> tuple:
    """(window, q, keyword arguments of moment_window) of variant ``name``."""
    kw = dict(n_tiles=T1, ns=NS, s_len=S, lens=S - 37)
    if name in ("B_scalar_prefetch", "C_any_dma", "E_all"):
        kw["lens"] = d["lens"]
    if name in ("D_epilogue", "E_all"):
        kw["epilogue"] = True
    if name in ("C_any_dma", "E_all"):
        return d["big"], d["q"], dict(kw, starts=d["starts"])
    return d["win"], d["q"], kw


def run(device, variants=VARIANTS, reps: int = STEPS) -> dict:
    """Time and check every variant: {"variants": {name: window_case(...)}}."""
    d = inputs(device)
    res = {}
    for name in variants:
        win, q, kw = variant_args(name, d)
        res[name] = window_case(win, q, PREC, reps, **kw)
    return {"variants": res}



def main() -> int:
    device = require_card()
    print_variants(run(device), "%d tiles x %d spans, %s" % (T1, NS, PREC))
    print(torch.cuda.get_device_name(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
