"""The moment product with in-kernel operands (P3, P4, P5).

Counterpart of the Pallas probes ``scripts/exp_mosaic_dot_probe2.py``
(P3), ``exp_mosaic_dot_probe3.py`` (P4, calls A-E) and
``exp_mosaic_dot_probe4.py`` (P5, E-J): per tile and span, build the
cell-window forward kernel's operands from an (8, S) window (rows: current
x, y, z, establishment x, y, z) and a tile of 128 query columns q,

    feats (16, S) = [1, x, y, z, xx, yy, zz, xy, xz, yz, 0 x 6] in the span,
    wm (S, 128)   = [d2(est_k, q_n) <= r2] in the span,

and sum feats @ wm over the spans into a (16, 128) block per tile. The
kernel is ``csrc/moment_window.cu``; on CPU tensors the wrapper runs
:func:`moment_window_plain`. Precisions as in ``ops/moment_dot.py``.

Switches (:data:`FLAG_BITS`), each a structural piece of K1 that the TPU
probes added one at a time: ``len_table`` (span lengths from an
(n_tiles, ns) table, P4-B), ``staged`` (windows read from a big (8, ncols)
table at per-span starts, P4-C), ``epilogue`` (the division epilogue,
P4-D), ``per_tile_q`` (per-tile q, P5-F), ``shift`` (tile-centre shifts,
P5-G), ``lead`` (two-sided lead masks, P5-H). A span covers the window
columns lead <= c < min(lead + len, S) (lead = 0 without ``lead``); with
``staged``, only those whose table column start + c lies in the table.

Membership is defined in float32, as the kernel computes it: d = (e - ctr)
- (q - ctr) rounded to float32, d2 = (dx dx + dy dy) + dz dz with every
operation rounded (no fused multiply-add). The features and the sums are
in the input's dtype.
"""
from __future__ import annotations

import torch

from . import _kernels
from .moment_dot import _prec_id, tf32_split

__all__ = ["FLAG_BITS", "moment_window", "moment_window_plain", "span_bounds",
           "window_flags"]

R = 128
FLAG_BITS = {"len_table": 1, "staged": 2, "epilogue": 4, "per_tile_q": 8, "shift": 16,
             "lead": 32}
# Elements of the largest (tiles, spans, S, 128) intermediate of the plain
# version.
_PLAIN_CHUNK_ELEMS = 1 << 24


def window_flags(lens, starts=None, leads=None, ctr=None, per_tile_q=False,
                 epilogue=False) -> int:
    """The switch bits implied by the arguments of :func:`moment_window`."""
    on = {"len_table": isinstance(lens, torch.Tensor), "staged": starts is not None,
          "epilogue": epilogue, "per_tile_q": per_tile_q, "shift": ctr is not None,
          "lead": leads is not None}
    return sum(bit for name, bit in FLAG_BITS.items() if on[name])


def span_bounds(lens, leads, s_len: int, n_tiles: int, ns: int):
    """(lo, hi), each (n_tiles, ns) int64: the span's window columns
    [lo, hi), hi clamped to S."""
    dev = lens.device if isinstance(lens, torch.Tensor) else (
        leads.device if leads is not None else None)
    ln = (lens.long() if isinstance(lens, torch.Tensor)
          else torch.full((n_tiles, ns), int(lens), dtype=torch.long, device=dev))
    lo = leads.long() if leads is not None else torch.zeros_like(ln)
    return lo, torch.clamp(lo + ln, max=s_len)


def _epilogue(acc):
    """scripts/exp_mosaic_dot_probe3.py:86-98 on (c, 10, R) sums -> (c, 10, R)."""
    s0 = torch.clamp(acc[:, 0], min=1e-12)
    m = acc[:, 1:4] / s0[:, None]
    den = torch.clamp(acc[:, 0] - 1.0, min=1e-6)
    cov = (acc[:, 4:7] - s0[:, None] * m * m) / den[:, None]
    return torch.cat([m, cov, acc[:, 7:10], s0[:, None]], 1)


def moment_window_plain(win, q, r2: float, n_tiles: int, ns: int, s_len: int, lens,
                        prec: str, starts=None, leads=None, ctr=None, per_tile_q=False,
                        epilogue=False):
    """Plain torch version of P3-P5 in the dtype of ``win`` -> (16, 128
    n_tiles). Arguments as :func:`moment_window`."""
    dt, dev = win.dtype, win.device
    lo, hi = span_bounds(lens, leads, s_len, n_tiles, ns)
    col = torch.arange(s_len, device=dev)
    span = (col >= lo.to(dev)[..., None]) & (col < hi.to(dev)[..., None])  # (T, ns, S)
    if starts is not None:  # columns outside the table are outside the span
        pos = starts.to(dev).long()[..., None] + col
        span &= (pos >= 0) & (pos < win.shape[1])
    if per_tile_q:
        qt = q[:3].reshape(3, n_tiles, R).permute(1, 0, 2)  # (T, 3, R)
    else:
        qt = q[:3].expand(n_tiles, 3, R)
    c3 = (ctr.to(device=dev, dtype=dt) if ctr is not None
          else torch.zeros((n_tiles, 3), dtype=dt, device=dev))
    step = max(1, _PLAIN_CHUNK_ELEMS // (ns * s_len * R))
    parts = []
    for a in range(0, n_tiles, step):
        b = min(n_tiles, a + step)
        msk = span[a:b]  # (c, ns, S)
        if starts is not None:
            idx = torch.where(msk, pos[a:b], 0)
            w6 = win[:6, idx].permute(1, 2, 0, 3)  # (c, ns, 6, S); reads bounded
        else:
            w6 = win[:, :6].expand(b - a, ns, 6, s_len)
        cc = c3[a:b][:, None, :, None]  # (c, 1, 3, 1)
        x = w6[:, :, 0:3] - cc  # (c, ns, 3, S) shifted current coords
        # Membership in float32, every operation rounded (the kernel's).
        e32 = w6[:, :, 3:6].float() - cc.float()
        q32 = qt[a:b].float() - c3[a:b].float()[:, :, None]  # (c, 3, R)
        d = [e32[:, :, k, :, None] - q32[:, None, k, None, :] for k in range(3)]
        d2 = d[0] * d[0]
        d2 = d2 + d[1] * d[1]
        d2 = d2 + d[2] * d[2]  # (c, ns, S, R)
        wm = ((d2 <= r2) & msk[..., None]).to(dt)
        x0, x1, x2 = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        feats = torch.stack([torch.ones_like(x0), x0, x1, x2, x0 * x0, x1 * x1, x2 * x2,
                             x0 * x1, x0 * x2, x1 * x2], 2)  # (c, ns, 10, S)
        feats = torch.where(msk[:, :, None, :], feats, torch.zeros((), dtype=dt, device=dev))
        lhs = feats.permute(0, 2, 1, 3).reshape(b - a, 10, ns * s_len)
        rhs = wm.reshape(b - a, ns * s_len, R)
        acc = sum(torch.bmm(c, rhs) for c in tf32_split(lhs, prec))  # (c, 10, R)
        if epilogue:
            acc = _epilogue(acc)
        acc = torch.cat([acc, torch.zeros((b - a, 6, R), dtype=dt, device=dev)], 1)
        parts.append(acc.permute(1, 0, 2).reshape(16, (b - a) * R))
    return torch.cat(parts, 1)


def moment_window(win, q, r2: float, n_tiles: int, ns: int, s_len: int, lens, prec: str,
                  starts=None, leads=None, ctr=None, per_tile_q=False, epilogue=False):
    """P3-P5 wrapper: the CUDA kernel for CUDA tensors (float32 only;
    anything else raises), :func:`moment_window_plain` for CPU tensors.

    :param win: (ns, 8, S) windows, one per span, shared by every tile; or,
        with ``starts``, the (8, ncols) table the spans are read from.
    :param q: (8, 128) query columns of every tile, or (8, 128 n_tiles)
        with ``per_tile_q``.
    :param lens: one span length for all spans (int), or an (n_tiles, ns)
        int32 table.
    :param prec: one of ``ops.moment_dot.PRECISIONS``.
    :param starts, leads: (n_tiles, ns) int32 span starts into the table and
        leads (two-sided masks); ``ctr``: (n_tiles, 3) tile centres.
    :param epilogue: apply the division epilogue to each column's sums.
    :return: (16, 128 n_tiles); tile t owns columns [128 t, 128 t + 128).
    """
    if win.device.type == "cpu":
        _prec_id(prec)
        return moment_window_plain(win, q, r2, n_tiles, ns, s_len, lens, prec, starts=starts,
                                   leads=leads, ctr=ctr, per_tile_q=per_tile_q,
                                   epilogue=epilogue)
    flags = window_flags(lens, starts, leads, ctr, per_tile_q, epilogue)
    return _kernels.launch_moment_window(_prec_id(prec), flags, win, q, r2, n_tiles, ns, s_len,
                                         lens, starts=starts, leads=leads, ctr=ctr)
