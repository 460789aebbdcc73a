"""The dynamic-gather probes (P8).

Counterpart of the Pallas probe ``scripts/exp_pallas_gather2.py``: cases
A-E, ``take_along_axis`` along a row (axis 1) or a column (axis 0), and a
1-D ``take`` (E, one row). Each case runs in two forms (:data:`FORMS`):
``global`` gathers from device memory, ``staged`` from shared memory after
staging the row (axis 1) or all of x (axis 0) in one block, or, for an
axis-1 row too long for one block, spread over the shared memory of a
cluster of :data:`CLUSTER_BLOCKS` blocks; it exists only where that fits
(:func:`staged_blocks`). The kernels are ``csrc/gather_probe.cu``; on CPU
tensors the wrapper runs :func:`gather_probe_plain`.
"""
from __future__ import annotations

import torch

from . import _kernels

__all__ = ["CLUSTER_BLOCKS", "FORMS", "STAGED_BYTES", "gather_probe", "gather_probe_plain",
           "staged_blocks", "staged_fits"]

FORMS = ("global", "staged")
# Shared memory one block may use on an H100 (the opt-in limit, 227 KB).
STAGED_BYTES = 232448
# Blocks of the cluster that holds a staged row too long for one block
# (csrc/gather_probe.cu's kCluster; 8 is the portable cluster size).
CLUSTER_BLOCKS = 8


def staged_blocks(x: torch.Tensor, axis: int) -> int:
    """The blocks whose shared memory holds the staged form's table: 1
    where x's row (axis 1) or all of x (axis 0), as float32, fits one
    block; :data:`CLUSTER_BLOCKS` where an axis-1 row fits a cluster's
    blocks in slices of a multiple of 4 floats; 0 where it fits neither."""
    x2 = x.reshape(1, -1) if x.dim() == 1 else x
    if 4 * (x2.shape[1] if axis == 1 else x2.numel()) <= STAGED_BYTES:
        return 1
    slice_cols = 4 * -(-x2.shape[1] // (4 * CLUSTER_BLOCKS))  # ceil(cols / 8) to a multiple of 4
    return CLUSTER_BLOCKS if axis == 1 and 4 * slice_cols <= STAGED_BYTES else 0


def staged_fits(x: torch.Tensor, axis: int) -> bool:
    """Whether the staged form exists for x (:func:`staged_blocks` > 0)."""
    return staged_blocks(x, axis) > 0


def gather_probe_plain(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``take_along_axis(x, idx, axis)`` (1-D x: ``x[idx]``), in x's dtype."""
    if x.dim() == 1:
        return x[idx.long()]
    return torch.gather(x, axis, idx.long())


def gather_probe(x: torch.Tensor, idx: torch.Tensor, axis: int, form: str) -> torch.Tensor:
    """P8 wrapper: the CUDA kernel of ``form`` for CUDA tensors (float32 x,
    int32 indices in range; anything else raises, as does a staged form
    that does not fit), :func:`gather_probe_plain` for CPU tensors."""
    if form not in FORMS:
        raise ValueError("unknown gather form %r (forms: %s)" % (form, ", ".join(FORMS)))
    if axis not in (0, 1) or (x.dim() == 1 and axis != 1):
        raise ValueError("gather_probe: axis %r" % (axis,))
    if x.device.type == "cpu":
        return gather_probe_plain(x, idx, axis)
    if form == "staged" and not staged_fits(x, axis):
        raise ValueError("gather_probe: the staged table of x %s does not fit the %d bytes "
                         "of shared memory of one block, nor of a cluster of %d"
                         % (tuple(x.shape), STAGED_BYTES, CLUSTER_BLOCKS))
    if x.dim() == 1:
        return _kernels.launch_gather_probe(form == "staged", 1, x[None], idx[None])[0]
    return _kernels.launch_gather_probe(form == "staged", axis, x, idx)
