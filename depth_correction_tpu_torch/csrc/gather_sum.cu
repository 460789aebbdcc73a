// P7's stage-1 probe (P7a) for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas probe scripts/exp_pallas_gather.py:main.probe_kernel
// (:45, pallas_call :56), which asked whether Mosaic lowers a vector gather
// from a table held in VMEM: a (3, M) float32 table gathered by (T, K)
// int32 indices, each row's K columns summed into (3, T). The plain torch
// version is gather_sum_plain in depth_correction_tpu_torch/ops/gather_sum.py.
//
// Each row's three sums add the gathered values in index order k = 0..K-1,
// each addition rounded on its own, the plain version's order, so the two
// are equal bit for bit. Indices must lie in [0, M): one outside is
// undefined input, which neither the kernel nor its launcher checks (the
// plain version wraps a negative index and raises on one past M).
//
// What bounds it on this card: latency. At the probe's shapes (M 16,384,
// T 512, K 32) the work is 49,152 gathers from a 196 KB table, which sits
// in the 50 MB L2 after its first touch: L2 is this card's counterpart of
// the VMEM the TPU probe asked about, and needs no staging. So nothing is
// staged, and the rows are spread over the card: a warp a row, four rows a
// block (T = 512 is 128 blocks). The lanes take 32 of the row's indices at
// a time, one each (one coalesced load), gather their three values through
// the read-only path, and every lane then adds the 32 values in lane order
// from shuffles; lane 0 writes. A row of K <= 32 is three dependent memory
// round trips: indices, gathers, store. (One thread a row, with 16-byte
// index loads and all 96 gathers in flight before the adds, took 0.0028 ms
// on an H100 at 32 rows a block, its 16 blocks' warps each issuing 96
// gathers of 32 scattered sectors, and 0.0019 at 4 rows a block; this
// design took 0.0020 and needs no vector loads or alignment path.)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;  // warps per block

__global__ void __launch_bounds__(32 * kRowsPerBlock)
gather_sum_kernel(const float* __restrict__ pts_T, int m, const int* __restrict__ idx, int t,
                  int k, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= t) return;  // uniform across the warp
  const int* ri = idx + static_cast<size_t>(row) * k;
  const size_t ms = static_cast<size_t>(m);
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int n = min(32, k - j0);
    float x = 0.f, y = 0.f, z = 0.f;
    if (lane < n) {
      const int c = __ldg(ri + j0 + lane);
      x = __ldg(pts_T + c);
      y = __ldg(pts_T + ms + c);
      z = __ldg(pts_T + 2 * ms + c);
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float vx = __shfl_sync(kFull, x, j);
      const float vy = __shfl_sync(kFull, y, j);
      const float vz = __shfl_sync(kFull, z, j);
      if (j < n) {
        sx = __fadd_rn(sx, vx);
        sy = __fadd_rn(sy, vy);
        sz = __fadd_rn(sz, vz);
      }
    }
  }
  if (lane == 0) {
    out[row] = sx;
    out[t + row] = sy;
    out[2 * t + row] = sz;
  }
}

}  // namespace

extern "C" {

// pts_T (3, m) float32, idx (t, k) int32 -> out (3, t) float32. Launches on
// the caller's stream, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for bad arguments). Any table size the indices
// can address is taken: nothing is staged.
int dc_gather_sum(const void* pts_T, int m, const void* idx, int t, int k, void* out,
                  void* stream) {
  if (m <= 0 || t < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t > 0) {
    gather_sum_kernel<<<(t + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts_T), m, static_cast<const int*>(idx), t, k,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
