"""Knockout probe of the cell-window forward kernel (P1).

Counterpart of the Pallas probe ``scripts/exp_cellwin_knockout.py``
(``make_kernel``): K1 re-run on a real table with one part of its work
removed at a time, so the time each mode saves attributes K1's time. The
kernel is ``csrc/cellwin_knockout.cu``, K1's own template
(``csrc/cellwin_fwd.cuh``) instantiated once per mode; on CPU tensors the
wrapper runs :func:`cellwin_knockout_plain`.

Modes (what each one means on this card is in ``csrc/cellwin_fwd.cuh``):

- ``full``: K1 itself, bit-equal to ``ops.cellwin.cellwin_fwd``.
- ``no_d2``: no membership test; every staged entry of a span is a member.
- ``no_feats``: constant features; every sum is the member count.
- ``no_dot``: the member count alone, without the multiply-adds.
- ``no_mask``: no per-slot select; a {0, 1} weight multiplies each term.
- ``empty``: stage the spans, write q, nothing else.
- ``no_cull``: K1 with its warps' box cull switched off (every staged entry
  is tested): ``full``'s output bit for bit, so its extra time is what the
  cull buys.

Every mode but ``full`` and ``no_cull`` returns the raw row-centred sums (10, mq_pad)
[s0, Sx, Sy, Sz, Sxx, Syy, Szz, Sxy, Sxz, Syz] without the epilogue;
``empty`` returns q_est's x, y, z and zeros. The TPU probe's ``dot1``,
``kcat1`` and ``kcat3`` arrange the matrix unit's dot, which K1 on this card
does not have (:data:`NOT_CARRIED`); the tensor-core moment product is
probed by ``ops/moment_dot.py`` and ``ops/moment_window.py`` instead.
"""
from __future__ import annotations

import torch

from . import _kernels
from .cellwin import _fwd_windows, cellwin_fwd_plain

__all__ = ["MODES", "NOT_CARRIED", "cellwin_knockout", "cellwin_knockout_plain"]

MODES = ("full", "no_d2", "no_feats", "no_dot", "no_mask", "empty", "no_cull")
NOT_CARRIED = ("dot1", "kcat1", "kcat3")


def cellwin_knockout_plain(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr,
                           r2: float, mode: str):
    """Plain torch version of knockout ``mode`` on K1's inputs, in the
    dtype and on the device of ``pts_sorted`` -> (10, mq_pad)."""
    if mode not in MODES:
        raise ValueError("unknown knockout mode %r (modes: %s)" % (mode, ", ".join(MODES)))
    if mode in ("full", "no_cull"):
        return cellwin_fwd_plain(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr, r2)
    dt, dev = pts_sorted.dtype, pts_sorted.device
    if mode == "empty":
        out = torch.zeros((10, q_est.shape[1]), dtype=dt, device=dev)
        out[:3] = q_est[:3].to(device=dev, dtype=dt)
        return out
    zero = torch.zeros((), dtype=dt, device=dev)
    parts = []
    for d2, sl, xr, _, _ in _fwd_windows(pts_sorted, q_est, est_sorted, f_start, f_len,
                                         f_ctr):
        member = sl.expand(d2.shape) if mode == "no_d2" else (d2 <= r2) & sl
        s0 = member.sum(-1).to(dt)
        if mode == "no_feats":
            rows = [s0] * 10
        elif mode == "no_dot":
            rows = [s0] + [torch.zeros_like(s0)] * 9
        else:  # no_d2, no_mask: the ten row-centred sums of the members
            x0, x1, x2 = (torch.where(member, xk, zero) for xk in xr)
            rows = [s0, x0.sum(-1), x1.sum(-1), x2.sum(-1), (x0 * x0).sum(-1),
                    (x1 * x1).sum(-1), (x2 * x2).sum(-1), (x0 * x1).sum(-1),
                    (x0 * x2).sum(-1), (x1 * x2).sum(-1)]
        parts.append(torch.stack(rows, 0).reshape(10, -1))
    return torch.cat(parts, 1)


def cellwin_knockout(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr, r2: float,
                     mode: str):
    """P1 wrapper: the CUDA kernel for CUDA tensors (float32 only; anything
    else raises), :func:`cellwin_knockout_plain` for CPU tensors."""
    if mode not in MODES:
        raise ValueError("unknown knockout mode %r (modes: %s)" % (mode, ", ".join(MODES)))
    if pts_sorted.device.type == "cpu":
        return cellwin_knockout_plain(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr,
                                      r2, mode)
    return _kernels.launch_cellwin_knockout(MODES.index(mode), pts_sorted, q_est, est_sorted,
                                            f_start, f_len, f_ctr, r2)
