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

For each: ms per call (CUDA events) and the errors. :func:`probe_library`
times one PyTorch call computing stage 1 (embedding_bag), a yardstick.
:func:`probe_ab` and :func:`moments_ab` hold each kernel against its first
version (csrc/gather_sum_v1.cu, csrc/gather_moments_v1.cu) and time both
in turns (``--ab``).

    python -m depth_correction_tpu_torch.scripts.exp_pallas_gather [--ab]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.features import gather_moments, gather_moments_plain, gather_moments_v1
from ..ops.gather_sum import gather_sum, gather_sum_plain, gather_sum_v1
from . import device_ms, first_version_turns, kernel_ms, require_card

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

    :return: {"probe": {"ms", "plain_ms", "err" (max |kernel - plain|, must
        be 0), "rel64" (against the float64 sum), "out"}, "moments": {"ms",
        "plain_ms", "err32", "err64" (largest over mean and comps of
        max |kernel - plain| / max |plain|), "abs64"}}.
    """
    data = data or inputs(device)
    pts, idx = data["probe"]
    out = gather_sum(pts, idx)
    want = gather_sum_plain(pts, idx)
    want64 = gather_sum_plain(pts.double(), idx)
    probe = {"ms": device_ms(lambda: gather_sum(pts, idx), device, reps),
             "plain_ms": device_ms(lambda: gather_sum_plain(pts, idx), device, 3, warmup=1),
             "err": float((out - want).abs().max()), "rel64": _rel(out, want64), "out": out}

    pts_T, nn, w = data["moments"]
    got = gather_moments(pts_T, nn, w)
    pts_n3 = pts_T.T.contiguous()
    ref32 = gather_moments_plain(pts_n3, nn, w)
    ref64 = gather_moments_plain(pts_n3.double(), nn, w.double())
    moments = {
        "ms": device_ms(lambda: gather_moments(pts_T, nn, w), device, reps),
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


def probe_ab(device, data: dict = None, reps: int = STEPS) -> dict:
    """P7a against its first version on stage 1's inputs: whether the two
    are equal bit for bit, and both timed in turns.

    :return: {"equal", "kernel_ms", "v1_kernel_ms", "kernel_turns", "ms",
        "v1_ms", "turns"}.
    """
    pts, idx = (data or inputs(device))["probe"]
    new, old = gather_sum(pts, idx), gather_sum_v1(pts, idx)
    equal = bool(torch.equal(new.view(torch.int32), old.view(torch.int32)))
    return dict(first_version_turns(lambda: gather_sum_v1(pts, idx), lambda: gather_sum(pts, idx), device,
                       reps), equal=equal)


def moments_ab(points, neighbors, weights, device, reps: int = STEPS) -> dict:
    """P7 against its first version on the same inputs (any shape the
    wrapper takes): the largest |new - v1| of each output, and both timed
    in turns.

    :return: {"diff_v1": {"mean", "comps", "w_sum"}, "kernel_ms",
        "v1_kernel_ms", "kernel_turns", "ms", "v1_ms", "turns"}.
    """
    new = gather_moments(points, neighbors, weights)
    old = gather_moments_v1(points, neighbors, weights)
    diff = {name: float((a - b).abs().max()) if a.numel() else 0.0
            for name, a, b in zip(("mean", "comps", "w_sum"), new, old)}
    return dict(first_version_turns(lambda: gather_moments_v1(points, neighbors, weights),
                       lambda: gather_moments(points, neighbors, weights), device, reps),
                diff_v1=diff)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = require_card()
    res = run(device)
    p, m = res["probe"], res["moments"]
    ok = p["err"] == 0 and m["err32"] <= 1e-5 and m["err64"] <= 1e-5
    print("stage 1 probe (P7a): %s  err vs plain %.1e, vs float64 %.3e  %8.4f ms/call "
          "(plain %.4f)" % ("OK  " if p["err"] == 0 else "FAIL", p["err"], p["rel64"],
                            p["ms"], p["plain_ms"]))
    print("stage 2 moments (P7): rel err vs plain float32 %.3e, float64 %.3e  %8.4f ms/call "
          "(plain %.4f)" % (m["err32"], m["err64"], m["ms"], m["plain_ms"]))
    if "--ab" in argv:
        data = inputs(device)
        for name, e in (("P7a", probe_ab(device, data)),
                        ("P7", moments_ab(*data["moments"], device))):
            ok = ok and e.get("equal", True)
            print("%-4s vs its first version: %s; device %8.4f ms, v1 %8.4f ms; events %8.4f / "
                  "%8.4f" % (name, "bit-equal %s" % e["equal"] if "equal" in e else
                             "largest |new - v1| %s" % e["diff_v1"], e["kernel_ms"],
                             e["v1_kernel_ms"], e["ms"], e["v1_ms"]))
    print(torch.cuda.get_device_name(device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
