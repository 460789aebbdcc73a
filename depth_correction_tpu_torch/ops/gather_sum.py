"""P7's stage-1 probe (P7a): a gather from a table held on chip, summed.

Counterpart of the Pallas probe ``scripts/exp_pallas_gather.py:main.
probe_kernel``: a (3, M) table gathered by (T, K) int32 indices, each
row's K columns summed into (3, T). The kernel is ``csrc/gather_sum.cu``
(the table read where it lies, in L2); on CPU tensors the wrapper runs
:func:`gather_sum_plain`, which adds in the kernel's order, so the two are
equal bit for bit.
"""
from __future__ import annotations

import torch

from . import _kernels

__all__ = ["gather_sum", "gather_sum_plain"]


def gather_sum_plain(pts_T: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(3, M) by (T, K) indices in [0, M) -> (3, T): out[:, t] = the sum
    over k = 0..K-1, in that order, of pts_T[:, idx[t, k]], in pts_T's
    dtype and on its device. An index outside [0, M) is undefined input,
    as for the kernel (here a negative one wraps, one past M raises)."""
    g = pts_T[:, idx.long()]  # (3, T, K)
    out = torch.zeros(g.shape[:2], dtype=pts_T.dtype, device=pts_T.device)
    for j in range(g.shape[2]):
        out = out + g[:, :, j]
    return out


def gather_sum(pts_T: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P7a wrapper: the CUDA kernel for CUDA tensors (float32 table, int32
    indices; another dtype or shape raises), :func:`gather_sum_plain` for
    CPU tensors. Indices must lie in [0, M): neither path checks them, and
    one outside is undefined input."""
    if pts_T.device.type == "cpu":
        return gather_sum_plain(pts_T, idx)
    return _kernels.launch_gather_sum(pts_T, idx)
