"""Variants of the gather kernels P7 (csrc/gather_moments.cu) and P7a
(csrc/gather_sum.cu) on one CUDA card, each timed in turns against the
kernel it varies (base, variant, variant, base) by the profiler's kernel
durations, to find what holds each design and which lane grouping to take.

Each variant is a copy of a committed source with a few lines replaced,
compiled by ``nvcc`` beside the package's build (``_build/variants/``)
and called through ctypes; the package's kernels are not touched.

- P7, lanes a row: the redesign with its dispatch replaced by one (G, C)
  grouping (G lanes a row, C neighbours a lane a pass), at K 32 (the
  probe's table and the small scan's node table), 48, 88 and 168 (radius
  tables on the small scan) and on the bench slice's global cloud with X2's
  top-k table (K 168).
- P7, knockouts: the kernel without its point gathers, its butterfly or
  its shift search. The outputs are wrong; only the times count.
- P7, the pack: the redesign on every table with its points read in
  place and packed into (N, 4) rows first, whatever the call's size.
- P7a: one thread a row (16-byte index loads, all of a chunk's gathers
  before its adds) at 32 and 4 rows a block, against the redesign's warp
  a row.

    python -m depth_correction_tpu_torch.scripts.exp_gather_variants
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from . import bench_config, in_turns, kernel_ms, require_card

STEPS = 20
SMALL_SCENE = "open_box/n_6_size_20_20_5_height_1_density_100"
GROUPINGS = {32: [(4, 8), (8, 4), (4, 16)], 48: [(8, 8), (4, 16), (16, 4), (32, 2)],
             88: [(16, 8), (32, 4), (8, 16)], 168: [(16, 8), (32, 8), (16, 16), (8, 8)]}
# Radii of the small scan's K 48, 88 and 168 tables (K 32 takes the node's r).
RADII = {48: 0.3, 88: 0.4, 168: 0.55}

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_DISPATCH_END = "  }\n  return static_cast<int>(cudaGetLastError());"
KNOCKOUTS = {
    "no_gathers": ("gather_moments.cu", [
        ("if (ok[q]) load_point<kPacked>(pts, sp, sc, id[q], x[q], y[q], z[q]);",
         "if (ok[q]) { x[q] = id[q] * 1e-6f; y[q] = id[q] * 2e-6f; z[q] = id[q] * 3e-6f; }")]),
    "no_butterfly": ("gather_moments.cu", [
        ("    for (int off = G / 2; off > 0; off >>= 1) {\n#pragma unroll\n      for (int c",
         "    for (int off = G / 2; off > G; off >>= 1) {\n#pragma unroll\n      for (int c")]),
    "no_shift_search": ("gather_moments.cu", [
        ("if (__any_sync(kFull, !found)) {", "if (false) {")]),
}
# P7a with one thread a row, ROWS rows a block (the design the redesign
# was measured against).
GATHER_SUM_THREAD = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int kChunk = 32;
template <bool kFull>
__device__ __forceinline__ void chunk(const float* __restrict__ p, size_t m,
                                      const int* __restrict__ ri, int n, bool vec,
                                      float& sx, float& sy, float& sz) {
  int c[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; j += 4) {
    if (vec && (kFull || j + 4 <= n)) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(ri + j));
      c[j] = v.x; c[j + 1] = v.y; c[j + 2] = v.z; c[j + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j + e] = (kFull || j + e < n) ? __ldg(ri + j + e) : 0;
    }
  }
  float gx[kChunk], gy[kChunk], gz[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (kFull || j < n) { gx[j] = __ldg(p + c[j]); gy[j] = __ldg(p + m + c[j]); gz[j] = __ldg(p + 2 * m + c[j]); }
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
    if (kFull || j < n) { sx = __fadd_rn(sx, gx[j]); sy = __fadd_rn(sy, gy[j]); sz = __fadd_rn(sz, gz[j]); }
}
__global__ void kernel(const float* __restrict__ p, int m, const int* __restrict__ idx, int t, int k,
                       float* __restrict__ out) {
  const int row = blockIdx.x * ROWS + threadIdx.x;
  if (row >= t) return;
  const int* ri = idx + static_cast<size_t>(row) * k;
  const bool vec = (reinterpret_cast<uintptr_t>(ri) & 15) == 0;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  int j0 = 0;
  for (; j0 + kChunk <= k; j0 += kChunk) chunk<true>(p, m, ri + j0, kChunk, vec, sx, sy, sz);
  if (j0 < k) chunk<false>(p, m, ri + j0, k - j0, vec, sx, sy, sz);
  out[row] = sx; out[t + row] = sy; out[2 * t + row] = sz;
}
}
extern "C" int dc_variant(const void* p, int m, const void* idx, int t, int k, void* out, void* s) {
  if (t > 0) kernel<<<(t + ROWS - 1) / ROWS, ROWS, 0, static_cast<cudaStream_t>(s)>>>(
      static_cast<const float*>(p), m, static_cast<const int*>(idx), t, k, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _replace(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError("variant: %r is not in the source" % old)
        src = src.replace(old, new, 1)
    return src


def _sources() -> dict:
    """{variant name: (CUDA source, C entry to rename to dc_variant)}."""
    new = open(os.path.join(_SRC, "gather_moments.cu")).read()
    i0 = new.index("    if (k <= 32)")
    i1 = new.index(_DISPATCH_END, i0)
    out = {}
    for g, c in sorted({gc for gcs in GROUPINGS.values() for gc in gcs}):
        launch = "    launch<%d, %d>(src, sp, sc, n_pts, pk, ix, wt, mq, k, m, c, ws, s);\n" % (g, c)
        out["g%dc%d" % (g, c)] = (new[:i0] + launch + new[i1:], "dc_gather_moments")
    for name, (fname, pairs) in KNOCKOUTS.items():
        entry = "dc_" + fname[:-3]
        out[name] = (_replace(open(os.path.join(_SRC, fname)).read(), pairs), entry)
    for rows in (32, 4):
        out["p7a_thread_rows%d" % rows] = ("#define ROWS %d\n" % rows + GATHER_SUM_THREAD,
                                           "dc_variant")
    return out


def build() -> dict:
    """Compile every variant in parallel; {name: ctypes library}."""
    from ..ops import _kernels

    out_dir = os.path.join(_kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    flags = [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC"]
    procs = {}
    for name, (src, entry) in _sources().items():
        path = os.path.join(out_dir, name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        rename = [] if entry == "dc_variant" else ["-D%s=dc_variant" % entry]
        procs[name] = subprocess.Popen(flags + rename + ["-o", path[:-3] + ".so", path],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on variant %s:\n%s" % (name, log))
        lib = ctypes.CDLL(os.path.join(out_dir, name + ".so"))
        if name.startswith("p7a"):
            lib.dc_variant.argtypes = [_P, _I, _P, _I, _I, _P, _P]
        else:
            lib.dc_variant.argtypes = [_P, _L, _L, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P]
        lib.dc_variant.restype = _I
        libs[name] = lib
    return libs


def _moments_variant(lib, name: str, points, nn, w):
    """One launch of a P7 variant with the wrapper's layout and pack."""
    from ..ops import _kernels

    if points.shape[1] == 3:
        n_pts, sp, sc = points.shape[0], points.stride(0), points.stride(1)
    else:
        n_pts, sp, sc = points.shape[1], points.stride(1), points.stride(0)
    mq, k = nn.shape
    dev = points.device
    mean = torch.empty((3, mq), device=dev)
    comps = torch.empty((6, mq), device=dev)
    wsum = torch.empty(mq, device=dev)
    scratch = (torch.empty((n_pts, 4), device=dev)
               if nn.numel() >= _kernels.GATHER_PACK_MIN_PAIRS else None)
    err = lib.dc_variant(points.data_ptr(), sp, sc, n_pts, nn.data_ptr(), w.data_ptr(), mq, k,
                         mean.data_ptr(), comps.data_ptr(), wsum.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("variant %s: CUDA error %d" % (name, err))
    return mean, comps, wsum


def _pack(on: bool, fn):
    """``fn`` with P7's pack forced on or off (the wrapper's size test
    set past every call or to 0)."""
    from ..ops import _kernels

    def call():
        saved = _kernels.GATHER_PACK_MIN_PAIRS
        _kernels.GATHER_PACK_MIN_PAIRS = 0 if on else 1 << 62
        try:
            return fn()
        finally:
            _kernels.GATHER_PACK_MIN_PAIRS = saved

    return call


def _tables(device) -> dict:
    """{label: (points, neighbours int32, weights)}: the small scan's node
    table (K 32) and radius tables at K 48, 88 and 168, and the bench
    slice's global cloud with X2's top-k table."""
    from ..cloud import Cloud
    from ..datasets.synthetic import OpenBoxDataset
    from ..models import ScaledPolynomial
    from ..node import correct_cloud
    from ..ops.grid_hash import grid_radius_neighbors
    from ..ops.knn import radius_neighbors, suggest_k_max
    from ..preproc import pad_size
    from . import slice_clouds

    cfg = bench_config(str(device))
    cfg.nn_backend = None
    scan = OpenBoxDataset(name=SMALL_SCENE).local_cloud(0)
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=device)
    cloud = cloud.pad(pad_size(cloud.size))
    model = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float32, device=device)
    keep = correct_cloud(model, cloud, cfg)[4]
    points = cloud.to_points()
    out = {}
    for k in GROUPINGS:
        _, nn = radius_neighbors(points, points, r=RADII.get(k, cfg.nn_r), k=k,
                                 valid_points=keep, valid_query=keep)
        out["small scan K %d" % k] = (points, nn, (nn >= 0).float())
    (gp, gv), _, r = slice_clouds(device)
    k = suggest_k_max(gp, r=r, valid_points=gv)
    _, nn = grid_radius_neighbors(gp, None, r=r, k=k, valid_points=gv, valid_query=gv)
    out["global cloud K %d" % k] = (gp, nn, (nn >= 0).float())
    return out


def run(device, reps: int = STEPS) -> dict:
    """Every variant against its base in turns.

    :return: {"p7a": {name: (base ms, variant ms)}, "groupings": {table:
        {name: (base ms, variant ms)}}, "knockouts": {table: {name: (base ms,
        variant ms)}}, "pack": {table: (in place ms, packed ms)}}, device
        times by the profiler.
    """
    from ..ops import features
    from ..ops.gather_sum import gather_sum
    from . import exp_pallas_gather as p7

    libs = build()
    res = {"p7a": {}, "groupings": {}, "knockouts": {}, "pack": {}}
    data = p7.inputs(device)
    pts, idx = data["probe"]
    for name, lib in libs.items():
        if name.startswith("p7a"):
            def variant(lib=lib):
                out = torch.empty((3, idx.shape[0]), device=device)
                lib.dc_variant(pts.data_ptr(), pts.shape[1], idx.data_ptr(), idx.shape[0],
                               idx.shape[1], out.data_ptr(),
                               torch.cuda.current_stream(device).cuda_stream)
                return out

            if not torch.equal(variant(), gather_sum(pts, idx)):
                raise RuntimeError("P7a variant %s differs from the kernel" % name)
            res["p7a"][name] = in_turns(lambda: gather_sum(pts, idx), variant, device, reps,
                                        timer=kernel_ms)[:2]
    tables = {"probe (3, N) K 32": data["moments"],
              "probe (N, 3) K 32": (data["moments"][0].T.contiguous(),) + data["moments"][1:]}
    tables.update(_tables(device))
    for label, (points, nn, w) in tables.items():
        nn = nn.to(torch.int32).contiguous()
        k = nn.shape[1]
        def base(points=points, nn=nn, w=w):
            return features.gather_moments(points, nn, w)

        res["pack"][label] = in_turns(_pack(False, base), _pack(True, base), device, reps,
                                      timer=kernel_ms)[:2]
        if "(N, 3)" not in label:  # the groupings once per table
            groups = res["groupings"].setdefault(label, {})
            for g, c in GROUPINGS[min((kk for kk in GROUPINGS if kk >= k),
                                      default=max(GROUPINGS))]:
                name = "g%dc%d" % (g, c)
                groups[name] = in_turns(base, lambda name=name: _moments_variant(
                    libs[name], name, points, nn, w), device, reps, timer=kernel_ms)[:2]
        if "K 32" in label or "global" in label:
            kos = res["knockouts"].setdefault(label, {})
            for name in KNOCKOUTS:
                kos[name] = in_turns(base, lambda name=name: _moments_variant(
                    libs[name], name, points, nn, w), device, reps, timer=kernel_ms)[:2]
    return res


def main() -> int:
    device = require_card()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    res = run(device)
    for name, (base, ms) in res["p7a"].items():
        print("P7a %-20s %.4f ms device (warp a row %.4f)" % (name, ms, base))
    for label, rows in res["groupings"].items():
        for name, (base, ms) in rows.items():
            print("P7 %-22s lanes %-7s %.4f ms device (base %.4f)" % (label, name, ms, base))
    for label, (in_place, packed) in res["pack"].items():
        print("P7 %-22s read in place %.4f ms device, packed first %.4f" % (label, in_place,
                                                                           packed))
    for label, rows in res["knockouts"].items():
        for name, (base, ms) in rows.items():
            print("P7 %-22s %-20s %.4f ms device (base %.4f)" % (label, name, ms, base))
    return 0


if __name__ == "__main__":
    sys.exit(main())
