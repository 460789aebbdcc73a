"""The rest of K1's structure on top of P4's E (P5).

Counterpart of scripts/exp_mosaic_dot_probe4.py, with its seed and shapes
(T1 = 512, S = 640, R = 128; every variant tf32x3, the TPU's
split3_bits). On top of exp_mosaic_dot_probe3.py's E (span-length table,
spans staged from the big table, the epilogue), each a switch of
csrc/moment_window.cu:

  E_base(ns5)       P4's E
  F_moving_blocks   per-tile q columns (the TPU's moving blocks; here every
                    variant writes its own output slot, so only q moves)
  G_ctr_broadcast   per-tile centre shifts of q and the window
  H_lead_masks      two-sided lead <= col < lead + len masks
  I_ns15            NS = 15, the real span-slot count
  J_all             F + G + H at NS = 15 (K1's shape, modulo the data)

The data are drawn in the TPU script's order from one default_rng(0)
(:153-166), so every variant sees the same numbers as there. For each: ms
per call and the error against its plain version in float32 and float64.

    python -m depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe4
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .exp_mosaic_dot_probe2 import R, S, print_variants, window_case
from . import require_card

T1 = 512
STEPS = 20
PREC = "tf32x3"
# name -> (ns, moving, ctr_bcast, lead_mask), the TPU script's run list (:181-186)
VARIANTS = {
    "E_base(ns5)": (5, False, False, False),
    "F_moving_blocks": (5, True, False, False),
    "G_ctr_broadcast": (5, False, True, False),
    "H_lead_masks": (5, False, False, True),
    "I_ns15": (15, False, False, False),
    "J_all": (15, True, True, True),
}


def inputs(device, names=tuple(VARIANTS)):
    """Per variant: (big table, q, keyword arguments of moment_window),
    drawn as the TPU script draws them (every variant of VARIANTS is drawn,
    in order, so a subset sees the same numbers)."""
    rng = np.random.default_rng(0)
    big = torch.as_tensor(rng.normal(scale=0.2, size=(8, T1 * 256 + S)).astype(np.float32),
                          device=device)
    out = {}
    for name, (ns, moving, ctr_bcast, lead_mask) in VARIANTS.items():
        starts = (rng.integers(0, T1 * 2, T1 * ns) * 128).astype(np.int32)
        leads = (rng.integers(0, 1, T1 * ns) * 0).astype(np.int32)
        lens = np.full(T1 * ns, S - 37, np.int32)
        ctrs = rng.normal(scale=0.1, size=T1 * 3).astype(np.float32)
        q = rng.normal(scale=0.2, size=(8, T1 * R) if moving else (8, R)).astype(np.float32)
        if name not in names:
            continue

        def t(x):
            return torch.as_tensor(x, device=device)

        kw = dict(n_tiles=T1, ns=ns, s_len=S, lens=t(lens.reshape(T1, ns)),
                  starts=t(starts.reshape(T1, ns)), epilogue=True, per_tile_q=moving)
        if ctr_bcast:
            kw["ctr"] = t(ctrs.reshape(T1, 3))
        if lead_mask:
            kw["leads"] = t(leads.reshape(T1, ns))
        out[name] = (big, t(q), kw)
    return out


def run(device, variants=tuple(VARIANTS), reps: int = STEPS) -> dict:
    """Time and check every variant: {"variants": {name: window_case(...)}}."""
    cases = inputs(device, variants)
    return {"variants": {name: window_case(*cases[name][:2], PREC, reps, **cases[name][2])
                         for name in variants}}



def main() -> int:
    device = require_card()
    print_variants(run(device), "%d tiles, %s" % (T1, PREC))
    print(torch.cuda.get_device_name(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
