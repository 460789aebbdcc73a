// The first version of the grid-hash radius search (X2), kept unchanged
// beside its redesign (csrc/grid_query.cu) so that the two compare inside
// one call on one card; the redesign must equal it (index tables, distances
// bit for bit, counts). No path of the package launches it: chip_smoke.py's
// A/B and the card tests do, through ops/grid_hash.grid_query_v1. Plain C
// interface, loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces depth_correction_tpu/ops/grid_hash.py:_grid_query_chunk_impl
// (:108-225, plain XLA, reached through grid_radius_neighbors :468 and the
// node's gather-window program), as the redesign does; its plain torch
// version is _grid_query_chunk_plain in depth_correction_tpu_torch/ops/grid_hash.py.
//
// The search: the query's cell cq = floor((q - mins) / cell); its 9 (dx, dy)
// columns in the order dx, dy in (-1, 0, 1), each the z-run of cells
// [cz - 1, cz + 1] clamped into the grid; a column's points are one run of
// sorted slots [lower_bound(ids, lo), lower_bound(ids, hi + 1)), cut at
// `cap` slots when the caller gives a cap. Members: d2 <= r2 with d2 =
// dx*dx + dy*dy + dz*dz rounded step by step (no fused multiply-add).
// The top-k keeps lax.top_k's order: one 64-bit key per candidate, the
// float32 bits of d2 above (column << 28 | slot); keys are distinct.
//
// Design (one warp per query, queries in their own order): 18 lanes run the
// 9 columns' two binary searches at once; lanes then stride each run, 32
// candidates a step. Counts add up ballots. For k > 0 the warp keeps its k
// smallest keys, sorted, in shared memory: at every step with a member, the
// step's members are sorted across the warp (bitonic, by shuffles) and
// merged into the list by rank (each element's new place is its own index
// plus the number of smaller keys on the other side, by binary search),
// into a second buffer; once the list is full, candidates not below its
// last key are dropped before the sort. So every step rewrites the whole
// list: O(k) shared-memory work per step, for lists that in prep never
// fill (PERF.md §6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kSlotBits = 28;  // slot < 2^28 (checked by the launcher)
constexpr int kMaxWarps = 4;

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(a[mid]) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int lower_bound_keys(const unsigned long long* a, int n,
                                                unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Ascending bitonic sort of one 64-bit key per lane.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, key, stride);
      const bool up = (lane & size) == 0 || size == 32;
      const bool lower = (lane & stride) == 0;
      key = (lower == up) ? min(key, other) : max(key, other);
    }
  }
  return key;
}

__device__ __forceinline__ float f32_floor_coord(float v) {
  return fminf(fmaxf(floorf(v), -1073741824.f), 1073741824.f);  // +-2^30
}

template <bool COUNTS>
__global__ void grid_query_kernel(
    const float* __restrict__ q_pts,    // (Q, 3)
    const unsigned char* __restrict__ q_valid,  // (Q,) bool
    int nq,
    const float* __restrict__ pts_T,    // (3, N) sorted positions
    const int* __restrict__ ids,        // (N,) sorted linear cell ids
    const int* __restrict__ order,      // (N,) sorted slot -> original index
    int n,
    const float* __restrict__ mins,     // (3,)
    const int* __restrict__ dims,       // (3,)
    const float* __restrict__ cell,     // (1,)
    float r2, int k, long long cap,
    int* __restrict__ out_idx,          // (Q, k), or (Q,) counts
    float* __restrict__ out_d) {        // (Q, k)
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int q = blockIdx.x * (blockDim.x >> 5) + wib;
  if (q >= nq) return;  // uniform across the warp

  const bool valid = q_valid[q] != 0;
  int count = 0;
  int m = 0;  // keys held
  unsigned long long* buf0 = nullptr;
  unsigned long long* buf1 = nullptr;
  unsigned long long* sb = nullptr;
  if constexpr (!COUNTS) {
    unsigned long long* base = smem + static_cast<size_t>(wib) * (2 * k + 32);
    buf0 = base;
    buf1 = base + k;
    sb = base + 2 * k;
  }

  if (valid) {
    const float qx = q_pts[3 * q], qy = q_pts[3 * q + 1], qz = q_pts[3 * q + 2];
    const float c = cell[0];
    const long long nx = dims[0], ny = dims[1], nz = dims[2];
    const long long cx = static_cast<long long>(f32_floor_coord(__fdiv_rn(__fsub_rn(qx, mins[0]), c)));
    const long long cy = static_cast<long long>(f32_floor_coord(__fdiv_rn(__fsub_rn(qy, mins[1]), c)));
    const long long cz = static_cast<long long>(f32_floor_coord(__fdiv_rn(__fsub_rn(qz, mins[2]), c)));
    const long long zlo = min(max(cz - 1, 0ll), nz - 1);
    const long long zhi = min(max(cz + 1, 0ll), nz - 1);

    // Lanes 0-8: the start of column `lane`; lanes 9-17: its end.
    int bound = 0;
    if (lane < 18) {
      const int col = lane % 9;
      const long long gx = cx + (col / 3) - 1, gy = cy + (col % 3) - 1;
      if (gx >= 0 && gx < nx && gy >= 0 && gy < ny) {
        const long long colbase = (gx * ny + gy) * nz;
        bound = lower_bound(ids, n, lane < 9 ? colbase + zlo : colbase + zhi + 1);
      }
    }

    for (int col = 0; col < 9; ++col) {
      const int s = __shfl_sync(kFull, bound, col);
      long long e = __shfl_sync(kFull, bound, col + 9);
      if (cap >= 0) e = min(e, static_cast<long long>(s) + cap);
      for (long long b0 = s; b0 < e; b0 += 32) {
        const long long slot = b0 + lane;
        bool member = false;
        float d2 = 0.f;
        if (slot < e) {
          const float dx = __fsub_rn(pts_T[slot], qx);
          const float dy = __fsub_rn(pts_T[n + slot], qy);
          const float dz = __fsub_rn(pts_T[2ll * n + slot], qz);
          d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          member = d2 <= r2;
        }
        if constexpr (COUNTS) {
          count += __popc(__ballot_sync(kFull, member));
        } else {
          unsigned long long key = member
              ? (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
                    (static_cast<unsigned long long>(col) << kSlotBits) |
                    static_cast<unsigned long long>(slot)
              : kNone;
          // The list (buf0) is full: only keys below its last can enter.
          if (m == k && key != kNone && key > buf0[k - 1]) key = kNone;
          const int nb = __popc(__ballot_sync(kFull, key != kNone));
          if (nb == 0) continue;
          key = warp_sort(key, lane);  // members first, ascending
          sb[lane] = key;
          __syncwarp();
          // New places in buf1: batch element i at i + #(list < key_i),
          // list element j at j + #(batch < list_j); keys are distinct.
          if (lane < nb) {
            const int pos = lane + lower_bound_keys(buf0, m, key);
            if (pos < k) buf1[pos] = key;
          }
          for (int j = lane; j < m; j += 32) {
            const unsigned long long x = buf0[j];
            const int pos = j + lower_bound_keys(sb, nb, x);
            if (pos < k) buf1[pos] = x;
          }
          __syncwarp();
          m = min(k, m + nb);
          unsigned long long* t = buf0;
          buf0 = buf1;
          buf1 = t;
        }
      }
    }
  }

  if constexpr (COUNTS) {
    if (lane == 0) out_idx[q] = count;
  } else {
    int* oi = out_idx + static_cast<size_t>(q) * k;
    float* od = out_d + static_cast<size_t>(q) * k;
    for (int j = lane; j < k; j += 32) {
      if (j < m) {
        const unsigned long long key = buf0[j];
        const int slot = static_cast<int>(key & ((1ull << kSlotBits) - 1));
        oi[j] = order[slot];
        od[j] = __fsqrt_rn(__uint_as_float(static_cast<unsigned>(key >> 32)));
      } else {
        oi[j] = -1;
        od[j] = __int_as_float(0x7f800000);  // inf
      }
    }
  }
}

}  // namespace

extern "C" {

// k = 0: counts into out_idx (Q,) int32; k > 0: the k nearest into out_idx
// (Q, k) int32 and out_d (Q, k) float32. cap < 0 reads every run whole.
// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for bad arguments).
int dc_grid_query_v1(const void* q_pts, const void* q_valid, int nq, const void* pts_T,
                  const void* ids, const void* order, int n, const void* mins,
                  const void* dims, const void* cell, float r2, int k, long long cap,
                  void* out_idx, void* out_d, void* stream) {
  if (nq < 0 || n < 0 || k < 0 || n >= (1 << kSlotBits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q_pts);
  const unsigned char* qv = static_cast<const unsigned char*>(q_valid);
  const float* pt = static_cast<const float*>(pts_T);
  const int* pi = static_cast<const int*>(ids);
  const int* po = static_cast<const int*>(order);
  const float* pm = static_cast<const float*>(mins);
  const int* pd = static_cast<const int*>(dims);
  const float* pc = static_cast<const float*>(cell);
  int* oi = static_cast<int*>(out_idx);
  if (k == 0) {
    const int warps = 8;
    const int blocks = (nq + warps - 1) / warps;
    grid_query_kernel<true><<<blocks, 32 * warps, 0, st>>>(
        qp, qv, nq, pt, pi, po, n, pm, pd, pc, r2, 0, cap, oi, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  // Shared memory per warp: two lists of k keys and the step's 32 keys.
  const size_t per_warp = (2 * static_cast<size_t>(k) + 32) * sizeof(unsigned long long);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int warps = kMaxWarps;
  while (warps > 1 && warps * per_warp > static_cast<size_t>(max_smem)) warps >>= 1;
  const size_t smem = warps * per_warp;
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(grid_query_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (nq + warps - 1) / warps;
  grid_query_kernel<false><<<blocks, 32 * warps, smem, st>>>(
      qp, qv, nq, pt, pi, po, n, pm, pd, pc, r2, k, cap, oi, static_cast<float*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
