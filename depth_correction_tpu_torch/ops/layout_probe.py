"""The layout probes (P6).

Counterpart of the Pallas probes ``scripts/exp_mosaic_probe.py:k_*``: seven
tiny kernels over x (8, 512) float32, each writing a (512, 128) or (512, 8)
layout of it. The kernels are ``csrc/layout_probe.cu``; on CPU tensors the
wrapper runs :func:`layout_probe_plain`. :data:`PROBES` lists them in the script's order (its ``k_`` names
without the prefix) with their output shapes.
"""
from __future__ import annotations

import torch

from . import _kernels
from .moment_dot import tf32_split

__all__ = ["PROBES", "S", "R", "layout_probe", "layout_probe_plain"]

S, R = 512, 128
# name -> output shape, in the kernel's switch order.
PROBES = {
    "reshape_f32": (S, R),
    "iota_col": (S, R),
    "iota_col_full": (S, R),
    "bool_reshape": (S, R),
    "dot_tlhs": (S, R),
    "transpose_f32": (S, 8),
    "broadcast_row_to_col": (S, R),
}


def _check_name(name: str) -> int:
    if name not in PROBES:
        raise ValueError("unknown layout probe %r (probes: %s)" % (name, ", ".join(PROBES)))
    return list(PROBES).index(name)


def layout_probe_plain(x: torch.Tensor, name: str) -> torch.Tensor:
    """Plain torch version of probe ``name`` on x (8, 512), in x's dtype:
    row 0 as a column broadcast over 128 lanes (``reshape_f32``,
    ``broadcast_row_to_col``); the mask s < int(x[0, 0]) as a column
    (``iota_col``, ``iota_col_full``, ``bool_reshape``); x^T ones(8, 128)
    summed over the TF32 split's three components (``dot_tlhs``); x^T
    (``transpose_f32``)."""
    _check_name(name)
    if name in ("reshape_f32", "broadcast_row_to_col"):
        return x[0][:, None].expand(S, R).contiguous()
    if name in ("iota_col", "iota_col_full", "bool_reshape"):
        ln = int(x[0, 0])  # truncation toward zero, as astype(int32) does
        mask = torch.arange(S, device=x.device) < ln
        return mask[:, None].expand(S, R).to(x.dtype).contiguous()
    if name == "dot_tlhs":
        ones = torch.ones((8, R), dtype=x.dtype, device=x.device)
        return sum(c.T @ ones for c in tf32_split(x, "tf32x3"))
    return x.T.contiguous()


def layout_probe(x: torch.Tensor, name: str) -> torch.Tensor:
    """P6 wrapper: the CUDA kernel of probe ``name`` for CUDA tensors
    (float32 (8, 512) only; anything else raises), :func:`layout_probe_plain`
    for CPU tensors."""
    probe = _check_name(name)
    if x.device.type == "cpu":
        return layout_probe_plain(x, name)
    return _kernels.launch_layout_probe(probe, x, PROBES[name])
