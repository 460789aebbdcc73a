"""P7's two stages on the card: the gather-sum probe (P7a) and the fused
gather + moments kernel (P7).

Counterpart of scripts/exp_pallas_gather.py, which asked whether Mosaic
lowers a vector gather from a VMEM-resident table and how fast a fused
gather + moments kernel runs against the XLA gather path. Its stages, with
its shapes and its default_rng(0) draws in its order:

  1  probe    (3, M = 16,384) float32 gathered by (T = 512, K = 32) int32
              indices, each row's K columns summed -> (3, T): kernel P7a
              (ops/gather_sum.py, csrc/gather_sum.cu, the table read from
              L2), bit-equal to its plain version.
  2  moments  (3, M = 390,144) points, (MQ = 223,744, K = 32) indices and
              0/1 weights (rng.random > 0.1) -> mean (3, MQ) and the six
              covariance components: kernel P7 (ops/features.gather_moments,
              csrc/gather_moments.cu) against its plain version
              ``_moments_impl`` in float32 and float64.

For each: ms per call (by CUDA events and by the profiler's kernel
durations) and the errors. :func:`probe_library` times one PyTorch call
computing stage 1 (embedding_bag), a yardstick.

    python -m depth_correction_tpu_torch.scripts.exp_pallas_gather
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.features import gather_moments, gather_moments_plain
from ..ops.gather_sum import gather_sum, gather_sum_plain
from . import device_ms, kernel_ms, require_card

STEPS = 20
PROBE_M, PROBE_K, PROBE_T = 16384, 32, 512
M, MQ, K = 390144, 223744, 32


def inputs(device) -> dict:
    """{"probe": (pts_T (3, M) float32, idx (T, K) int32), "moments":
    (pts_T (3, M) float32, idx (MQ, K) int32, w (MQ, K) float32)} on
    ``device``, drawn as the script draws them (one default_rng(0), stage 1
    first)."""
    rng = np.random.default_rng(0)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    probe = (t(rng.normal(size=(3, PROBE_M)), torch.float32),
             t(rng.integers(0, PROBE_M, (PROBE_T, PROBE_K)), torch.int32))
    moments = (t(rng.normal(size=(3, M)), torch.float32),
               t(rng.integers(0, M, (MQ, K)), torch.int32),
               t(rng.random((MQ, K)) > 0.1, torch.float32))
    return {"probe": probe, "moments": moments}


def _rel(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def run(device, reps: int = STEPS, data: dict = None) -> dict:
    """Time and check both stages.

    :return: {"probe": {"ms", "kernel_ms", "plain_ms", "err" (max |kernel
        - plain|, must be 0), "rel64" (against the float64 sum), "out"},
        "moments": {"ms", "kernel_ms", "plain_ms", "err32", "err64" (largest
        over mean and comps of max |kernel - plain| / max |plain|),
        "abs64"}}: ``ms`` by CUDA events, ``kernel_ms`` by the profiler's
        kernel durations.
    """
    data = data or inputs(device)
    pts, idx = data["probe"]
    out = gather_sum(pts, idx)
    want = gather_sum_plain(pts, idx)
    want64 = gather_sum_plain(pts.double(), idx)
    probe = {"ms": device_ms(lambda: gather_sum(pts, idx), device, reps),
             "kernel_ms": kernel_ms(lambda: gather_sum(pts, idx), device, reps),
             "plain_ms": device_ms(lambda: gather_sum_plain(pts, idx), device, 3, warmup=1),
             "err": float((out - want).abs().max()), "rel64": _rel(out, want64), "out": out}

    pts_T, nn, w = data["moments"]
    got = gather_moments(pts_T, nn, w)
    pts_n3 = pts_T.T.contiguous()
    ref32 = gather_moments_plain(pts_n3, nn, w)
    ref64 = gather_moments_plain(pts_n3.double(), nn, w.double())
    moments = {
        "ms": device_ms(lambda: gather_moments(pts_T, nn, w), device, reps),
        "kernel_ms": kernel_ms(lambda: gather_moments(pts_T, nn, w), device, reps),
        "plain_ms": device_ms(lambda: gather_moments_plain(pts_n3, nn, w), device, 3,
                              warmup=1),
        "err32": max(_rel(g, r) for g, r in zip(got[:2], ref32[:2])),
        "err64": max(_rel(g, r) for g, r in zip(got[:2], ref64[:2])),
        "abs64": max(float((g.double() - r).abs().max()) for g, r in zip(got[:2], ref64[:2])),
    }
    return {"probe": probe, "moments": moments}


def probe_library(device, data: dict = None, reps: int = STEPS) -> dict:
    """One PyTorch call computing P7a's function, as a yardstick (the port
    never calls it): embedding_bag(idx, pts_T.T, mode="sum") gives the (T, 3)
    sums, the probe's (3, T) read transposed.

    :return: {"ms" (CUDA events), "kernel_ms" (the profiler's kernel
        durations), "rel" (max |library - plain| / max |plain|)}.
    """
    data = data or inputs(device)
    pts, idx = data["probe"]

    def call():
        return torch.nn.functional.embedding_bag(idx, pts.T, mode="sum")

    want = gather_sum_plain(pts, idx)
    return {"ms": device_ms(call, device, reps), "kernel_ms": kernel_ms(call, device, reps),
            "rel": _rel(call().T, want)}




def main() -> int:
    device = require_card()
    res = run(device)
    p, m = res["probe"], res["moments"]
    ok = p["err"] == 0 and m["err32"] <= 1e-5 and m["err64"] <= 1e-5
    print("stage 1 probe (P7a): %s  err vs plain %.1e, vs float64 %.3e  %8.4f ms/call "
          "(kernel %.4f, plain %.4f)" % ("OK  " if p["err"] == 0 else "FAIL", p["err"],
                                         p["rel64"], p["ms"], p["kernel_ms"], p["plain_ms"]))
    print("stage 2 moments (P7): rel err vs plain float32 %.3e, float64 %.3e  %8.4f ms/call "
          "(kernel %.4f, plain %.4f)" % (m["err32"], m["err64"], m["ms"], m["kernel_ms"],
                                         m["plain_ms"]))
    print(torch.cuda.get_device_name(device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
