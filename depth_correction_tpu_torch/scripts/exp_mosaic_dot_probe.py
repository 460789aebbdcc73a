"""Precision and cost of the moment product on the tensor cores (P2).

Counterpart of scripts/exp_mosaic_dot_probe.py, with its seed and shapes:
T1 = 512 tiles, each summing NS = 5 products a_s @ b_s of a (16, S = 640)
float32 normal block and a (640, R = 128) {0, 1} block of density 0.3.
The question it asks here: what does the product with an exact {0, 1}
right-hand side cost on Hopper's TF32 tensor cores, and at what precision?
Variants (ops/moment_dot.py; the TPU variant each stands for):

  fp32    float32 FMAs, no tensor cores       (highest)
  tf32    one TF32 pass                       (default)
  tf32x2  two TF32 passes, hi + mid           (split2_cast, split2_bits)
  tf32x3  three passes, hi + mid + lo         (split3_bits)

For each: ms per call (the T1 tiles), the error relative to max |oracle| of
the float64 einsum oracle (as the TPU script reports it), and the error
against the variant's own plain version in float32 and float64. With
--library it also times one torch.bmm over the T1 tiles in float32 and
with TF32 allowed (a yardstick; the port never calls it).

    python -m depth_correction_tpu_torch.scripts.exp_mosaic_dot_probe [--library]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.moment_dot import PRECISIONS, moment_dot, moment_dot_plain
from . import device_ms, kernel_ms, rel_max, rel_rows, require_card

T1 = 512  # grid size (tiles)
NS = 5  # dots per tile
S = 640
R = 128
STEPS = 30


def inputs(device):
    """The TPU script's data (default_rng(0), :86-93): a (NS, 16, S), b
    (NS, S, R) on ``device`` and the float64 oracle (16, R) as a tensor."""
    rng = np.random.default_rng(0)
    a_np = rng.normal(size=(NS, 16, S)).astype(np.float32)
    b_np = (rng.random((NS, S, R)) < 0.3).astype(np.float32)
    oracle = np.einsum("sfi,sir->fr", a_np.astype(np.float64), b_np.astype(np.float64))
    return (torch.as_tensor(a_np, device=device), torch.as_tensor(b_np, device=device),
            torch.as_tensor(oracle, device=device))


def library_ms(a, b, t1: int, reps: int) -> dict:
    """One torch.bmm computing the same T1 products (expanded views, no
    copies), in float32 and with TF32 allowed, by CUDA events, and in
    float32 by the profiler's kernel durations (``fp32_device``, the device
    time without the host's issue); allow_tf32 is restored."""
    lhs = a.permute(1, 0, 2).reshape(16, -1).expand(t1, 16, NS * S)
    rhs = b.reshape(NS * S, R).expand(t1, NS * S, R)
    saved = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for name, tf32 in (("fp32", False), ("tf32", True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            out[name] = device_ms(lambda: torch.bmm(lhs, rhs), a.device, reps)
            if not tf32:
                out["fp32_device"] = kernel_ms(lambda: torch.bmm(lhs, rhs), a.device, reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return out


def run(device, variants=PRECISIONS, reps: int = STEPS, library: bool = False) -> dict:
    """Time and check every variant at the TPU script's shapes (:data:`T1`
    tiles).

    :return: {"variants": {v: {"ms", "oracle", "err32", "err64", "abs64",
        "out"}}[, "library": {"fp32", "tf32", "fp32_device"}]} where ``oracle`` is rel_max
        against the float64 einsum over every tile's slot, ``err32`` /
        ``err64`` rel_rows against the plain version in float32 and float64,
        and ``abs64`` the largest absolute difference from the latter.
    """
    a, b, oracle = inputs(device)
    a64, b64, t1 = a.double(), b.double(), T1
    res = {}
    for v in variants:
        def call(v=v):
            return moment_dot(a, b, t1, v)

        ms = device_ms(call, device, reps)
        out = call()
        ref64 = moment_dot_plain(a64, b64, t1, v)
        res[v] = {"ms": ms, "out": out, "oracle": rel_max(out, oracle.repeat(1, t1)),
                  "err32": rel_rows(out, moment_dot_plain(a, b, t1, v)),
                  "err64": rel_rows(out, ref64),
                  "abs64": float((out.double() - ref64).abs().max())}
    result = {"variants": res}
    if library:
        result["library"] = library_ms(a, b, t1, reps)
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = require_card()
    res = run(device, library="--library" in argv)
    for v, e in res["variants"].items():
        print("%-8s %8.4f ms/call (%d tiles x %d dots)  max rel err %.2e vs oracle, "
              "%.2e / %.2e vs plain f32 / f64" % (v, e["ms"], T1, NS, e["oracle"], e["err32"],
                                                  e["err64"]))
    for name, ms in res.get("library", {}).items():
        print("torch.bmm (%s) %8.4f ms/call" % (name, ms))
    print(torch.cuda.get_device_name(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
