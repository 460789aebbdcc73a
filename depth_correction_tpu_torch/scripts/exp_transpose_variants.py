"""X4 and X5 (``csrc/transpose_gather.cu``) against variants, on one CUDA
card, each pair timed in turns (first, second, second, first) by the
profiler's kernel durations and by CUDA events. Run alone; chip_smoke.py's
phase 20 times only the kernels themselves and ``index_add_``.

- X4 in cell order without staging: the redesign's cell order and CSR,
  eight lanes a target, each pair's table row read from global memory
  through L1 (``__ldg``), no tiles and no
  shared memory. A copy compiled by ``nvcc`` beside the package's build
  (``_build/variants/``) and called through ctypes; the package's kernels
  are not touched. Its sums are taken in the same order: bit-equal.
- X4 and X5 over tiles of :data:`ALT_TILE_TARGETS` targets beside the
  package's ``features.TILE_TARGETS``; with ``--sweep`` over each size
  given.
- ``index_add_`` (one PyTorch call computing X5's function) beside X5.
- The tiles' pairs a row in point order, in the build's Morton order and
  in lexicographic order over cells of the neighbourhood radius
  (``features.transpose_in_order``).

- With ``--profile-build``, one build of the transpose under the profiler.

It preps the bench's capped row on the card first (~1 min):

    python -m depth_correction_tpu_torch.scripts.exp_transpose_variants \
        [--sweep 64,128,256] [--profile-build]
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from . import bench_config, device_ms, in_turns, kernel_ms, require_card

REPS = 20
# The tile size (targets) timed beside the package's features.TILE_TARGETS.
ALT_TILE_TARGETS = 256
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build",
                      "variants")

X4_UNSTAGED = r"""
#include <cuda_runtime.h>
namespace {
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 8, kThreads = 256, kTargetsPerPass = kThreads / kLanes;
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4, kLanes);
  v += __shfl_xor_sync(kFull, v, 2, kLanes);
  v += __shfl_xor_sync(kFull, v, 1, kLanes);
  return v;
}
__global__ void __launch_bounds__(kThreads)
x4_unstaged(const float* __restrict__ pts, int m, const int* __restrict__ order,
            const int* __restrict__ start, const int* __restrict__ pair,
            const float* __restrict__ w, const float4* __restrict__ table, int k,
            float* __restrict__ grad) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int t = blockIdx.x * kTargetsPerPass + threadIdx.x / kLanes;
  float ax = 0.f, ay = 0.f, az = 0.f;
  int j = 0;
  if (t < m) {
    j = __ldg(order + t);
    const int s = __ldg(start + t), e = __ldg(start + t + 1);
    if (s < e) {
      const size_t j3 = 3 * static_cast<size_t>(j);
      const float x = __ldg(pts + j3), y = __ldg(pts + j3 + 1), z = __ldg(pts + j3 + 2);
      for (int p = s + lane; p < e; p += kLanes) {
        const size_t r = 3 * static_cast<size_t>(__ldg(pair + p) / k);
        const float wp = __ldg(w + p);
        const float4 a = __ldg(table + r), b = __ldg(table + r + 1), c = __ldg(table + r + 2);
        const float dx = x - b.z, dy = y - b.w, dz = z - c.x;
        ax = fmaf(wp, fmaf(a.x, dx, fmaf(a.w, dy, fmaf(b.x, dz, c.y))), ax);
        ay = fmaf(wp, fmaf(a.w, dx, fmaf(a.y, dy, fmaf(b.y, dz, c.z))), ay);
        az = fmaf(wp, fmaf(b.x, dx, fmaf(b.y, dy, fmaf(a.z, dz, c.w))), az);
      }
    }
  }
  ax = group_sum(ax);
  ay = group_sum(ay);
  az = group_sum(az);
  if (t < m && lane == 0) {
    const size_t j3 = 3 * static_cast<size_t>(j);
    grad[j3] = ax;
    grad[j3 + 1] = ay;
    grad[j3 + 2] = az;
  }
}
}  // namespace
extern "C" int dc_x4_unstaged(const void* pts, int m, const void* order, const void* start,
                              const void* pair, const void* w, const void* table, int k,
                              void* grad, void* stream) {
  if (m > 0) {
    x4_unstaged<<<(m + kTargetsPerPass - 1) / kTargetsPerPass, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), m, static_cast<const int*>(order),
        static_cast<const int*>(start), static_cast<const int*>(pair),
        static_cast<const float*>(w), static_cast<const float4*>(table), k,
        static_cast<float*>(grad));
  }
  return static_cast<int>(cudaGetLastError());
}
"""

_lib = None


def variant_lib():
    """The X4 variant :data:`X4_UNSTAGED`, built with the package's flags
    into a library under ``_build/variants/`` (keyed by a hash of the
    source) and loaded."""
    global _lib
    if _lib is None:
        from ..ops import _kernels

        sources = {"x4_unstaged.cu": X4_UNSTAGED}
        key = hashlib.sha256("".join(sources.values()).encode()
                             + " ".join(_kernels.NVCC_FLAGS).encode()).hexdigest()[:16]
        folder = os.path.join(_BUILD, key)
        path = os.path.join(folder, "libx4_variants.so")
        if not os.path.exists(path):
            os.makedirs(folder, exist_ok=True)
            for name, src in sources.items():
                with open(os.path.join(folder, name), "w") as f:
                    f.write(src)
            proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", path,
                                   *(os.path.join(folder, name) for name in sources)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on the X4 variants:\n%s"
                                   % (proc.stdout + proc.stderr))
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dc_x4_unstaged.argtypes = [p, i, p, p, p, p, p, i, p, p]
        lib.dc_x4_unstaged.restype = i
        _lib = lib
    return _lib


def x4_unstaged(points, tg, table):
    """X4 in cell order without staging (:data:`X4_UNSTAGED`) -> (M, 3)."""
    m = tg.num_points
    grad = torch.empty((m, 3), dtype=torch.float32, device=points.device)
    err = variant_lib().dc_x4_unstaged(
        points.data_ptr(), m, tg.order.data_ptr(), tg.start.data_ptr(), tg.pair.data_ptr(),
        tg.w.data_ptr(), table.data_ptr(), int(tg.k), grad.data_ptr(),
        torch.cuda.current_stream(points.device).cuda_stream)
    if err:
        raise RuntimeError("the X4 variant failed to launch: CUDA error %d" % err)
    return grad


def _turns(first, second, device, reps: int) -> dict:
    """``first`` and ``second`` in turns by kernel durations and by events."""
    a_k, b_k, kturns = in_turns(first, second, device, reps, timer=kernel_ms)
    a_e, b_e, eturns = in_turns(first, second, device, reps)
    return {"first_kernel_ms": a_k, "second_kernel_ms": b_k, "kernel_turns": kturns,
            "first_ms": a_e, "second_ms": b_e, "turns": eturns}


def lexicographic_order(positions, cell: float):
    """An ``order_of`` for ``features.transpose_in_order``: the targets with
    pairs by (x, y, z) cell of edge ``cell``, z fastest, ties by index;
    then the others by index."""
    def order(active):
        p = positions.detach().to(dtype=torch.float64)
        lo = torch.where(active[:, None], p, torch.inf).amin(0)
        c = ((p - torch.where(torch.isfinite(lo), lo, 0.0)) / cell).floor().clamp(min=0)
        c = torch.where(active[:, None], c, 0.0).long()
        n = c.amax(0) + 1
        key = torch.where(active, (c[:, 0] * n[1] + c[:, 1]) * n[2] + c[:, 2],
                          torch.iinfo(torch.int64).max)
        return torch.sort(key, stable=True).indices

    return order


def pairs_per_row(nn, w, positions, cell: float) -> dict:
    """The tiles' pairs a row with the targets in point order, in the
    build's cell order (Morton) and in lexicographic order over cells of
    edge ``cell``, and the seconds each build took on the tables' device."""
    import time

    from ..ops import features

    m = positions.shape[0]
    out = {}
    for name, order in (("point", features.index_order),
                        ("cell", lambda active: features.cell_order(positions, active)),
                        ("lexicographic", lexicographic_order(positions, cell))):
        if nn.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        tg = features.transpose_in_order(nn, m, w, order)
        if nn.is_cuda:
            torch.cuda.synchronize()
        out[name] = {"pairs_per_row": tg.pairs_per_row(), "tiles": tg.tiles.num_tiles,
                     "rows_max": tg.tiles.rows_max, "seconds": time.perf_counter() - t0}
    return out


def _graph_with_tiles(nn, w, positions, targets: int):
    """The transpose built with ``features.TILE_TARGETS`` set to ``targets``."""
    from ..ops import features

    saved = features.TILE_TARGETS
    features.TILE_TARGETS = targets
    try:
        return features.build_transpose_graph(nn, positions, w)
    finally:
        features.TILE_TARGETS = saved


def transpose_ab(points, nn, w, tg, table, g, positions, cell: float, sizes,
                 reps: int = REPS) -> dict:
    """X4 and X5 on one graph, in turns (each ``first_*`` the variant,
    ``second_*`` the redesign): the X4 variant without staging against the
    redesign, the redesigns on
    tiles of :data:`ALT_TILE_TARGETS` and each of ``sizes`` targets
    against the package's, ``index_add_``'s time and the pairs a row of
    three orders (:func:`pairs_per_row`, ``cell`` the lexicographic order's
    cell edge). Every variant's output is held against the redesign's
    (``*_equal``: bit for bit)."""
    from ..ops import features

    device = points.device
    m = tg.num_points
    x4 = lambda: features.transpose_moments(points, tg, table)  # noqa: E731
    x5 = lambda: features.transpose_gather(g, tg)  # noqa: E731
    ref4, ref5 = x4(), x5()
    res = {"x4_unstaged_equal": bool(torch.equal(x4_unstaged(points, tg, table), ref4))}
    res["x4_unstaged"] = _turns(lambda: x4_unstaged(points, tg, table), x4, device, reps)
    res["tiles"] = {}
    for size in (ALT_TILE_TARGETS, *sizes):
        tgs = _graph_with_tiles(nn, w, positions, size)
        res["tiles"][size] = {
            "pairs_per_row": tgs.pairs_per_row(), "tiles": tgs.tiles.num_tiles,
            "x4_equal": bool(torch.equal(features.transpose_moments(points, tgs, table), ref4)),
            "x5_equal": bool(torch.equal(features.transpose_gather(g, tgs), ref5)),
            "x4": _turns(lambda: features.transpose_moments(points, tgs, table), x4, device,
                         reps),
            "x5": _turns(lambda: features.transpose_gather(g, tgs), x5, device, reps)}
    flat = nn.reshape(-1)
    real = (flat >= 0) & (flat < m)
    idx, g_real = flat[real], g.reshape(-1, g.shape[-1])[real]

    def library():
        return torch.zeros((m, g.shape[-1]), device=device).index_add_(0, idx, g_real)

    res["library_ms"] = device_ms(library, device, reps)
    res["library_kernel_ms"] = kernel_ms(library, device, reps)
    res["orders"] = pairs_per_row(nn, w, positions, cell)
    return res


def build_profile(nn, w, positions, top: int = 12) -> list:
    """One ``build_transpose_graph`` on the card under torch.profiler: its
    wall ms and the ops that take the most device time."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from ..ops import features

    features.build_transpose_graph(nn, positions, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        features.build_transpose_graph(nn, positions, w)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:top]
    return [("wall", wall, 0)] + [(e.key, e.self_device_time_total / 1e3, e.count) for e in rows]


def main(argv=None) -> None:
    import argparse

    from ..datasets import create_dataset
    from ..models import ScaledPolynomial
    from ..ops import features
    from ..preproc import global_cloud
    from ..train import prepare_sequences

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", default="",
                    help="tile sizes (targets) to time X4 and X5 on, comma-separated")
    ap.add_argument("--profile-build", action="store_true",
                    help="profile one build of the transpose on the card")
    args = ap.parse_args(argv)
    device = require_card()
    cfg = bench_config(uncapped=False)
    data = prepare_sequences([create_dataset(n, cfg) for n in cfg.train_names], cfg)
    nn, w, tg = data.neighbors[0], data.weights[0], data.transposes[0]
    model = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(20)
    name = torch.cuda.get_device_name(0)
    with torch.no_grad():
        pos = global_cloud(data.batches[0]).get_points()
        pts = global_cloud(data.batches[0], model=model).get_points().contiguous()
        mean, comps, w_sum = features.gather_moments(pts, nn, w, centred=True)
        table = features._cotangent_rows(
            mean, w_sum, (torch.randn(mean.shape, generator=gen, device=device),
                          torch.randn(comps.shape, generator=gen, device=device)))
        g = torch.randn(tuple(nn.shape) + (3,), generator=gen, device=device)
        res = transpose_ab(pts, nn, w, tg, table, g, pos, float(cfg.nn_r),
                           [int(v) for v in args.sweep.split(",") if v])
    r = res["x4_unstaged"]
    print("X4 without staging / redesign: %.4f / %.4f ms device, %.4f / %.4f events (%s)"
          % (r["first_kernel_ms"], r["second_kernel_ms"], r["first_ms"], r["second_ms"], name))
    for size, r in res["tiles"].items():
        print("tiles of %d targets (%d tiles, %.3f pairs a row) / the package's %d: X4 %.4f / "
              "%.4f ms device, X5 %.4f / %.4f; bit-equal %s, %s (%s)"
              % (size, r["tiles"], r["pairs_per_row"], features.TILE_TARGETS,
                 r["x4"]["first_kernel_ms"], r["x4"]["second_kernel_ms"],
                 r["x5"]["first_kernel_ms"], r["x5"]["second_kernel_ms"], r["x4_equal"],
                 r["x5_equal"], name))
    print("index_add_ %.4f ms device; bit-equal to the redesign: %s; orders %s (%s)"
          % (res["library_kernel_ms"], {k: v for k, v in res.items() if k.endswith("_equal")},
             res["orders"], name))
    if args.profile_build:
        for key, ms, count in build_profile(nn, w, pos):
            print("build profile: %-60s %.4f ms (%d) (%s)" % (key[:60], ms, count, name))


if __name__ == "__main__":
    main()
