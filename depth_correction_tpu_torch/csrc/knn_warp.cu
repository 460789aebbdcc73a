// The warp-per-query body of the brute-force neighbour search (X3): X3's
// body for a top-k past the tiled body's shared memory in knn_brute.cu
// (about k = 839 on an H100; up to about 13,680 here, dc_knn_warp_max_k).
// The launcher ops/_kernels.py:launch_knn_brute routes such a k here; the
// results equal the tiled body's (index tables, d2 bit for bit). Plain C
// interface, loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces depth_correction_tpu/ops/knn.py:_knn_tiled (:51-97) and
// _counts_tiled (:269), plain XLA loops reached through nearest_neighbors,
// radius_neighbors and neighbor_counts: the online corrector's brute
// engine, the sizing of K in prep (suggest_k_max below 65,536 points) and
// the shadow filter's search over view directions. Their plain torch
// versions are _knn_plain and _counts_plain in
// depth_correction_tpu_torch/ops/knn.py.
//
// What it computes, per query q:
//   top-k (k > 0): the k smallest keys (d2, point index) over the valid
//     points with d2 <= r2 (r2 = inf when the caller gives no radius), in
//     ascending order; among equal d2 the lower index first, as lax.top_k
//     keeps it. Missing slots, and every slot of an invalid query, are
//     index -1 at d2 = inf. The JAX package's 8192-query chunks and
//     2048-point tiles bound its memory; the top-k by (d2, index) is exact,
//     so one launch over every query and point gives the same sets.
//   counts (k = 0): the number of valid points with d2 <= r2.
// d2 = dx*dx + dy*dy + dz*dz with d = q - p, each operation rounded on its
// own (no fused multiply-add), the plain version's order.
//
// Design (one warp per query, as X2's csrc/grid_query.cu): a block of W
// warps stages a tile of points (x, y, z and validity, SoA) in shared
// memory, and each warp strides the tile 32 candidates a step. Counts add
// up ballots. For k > 0 each candidate is one 64-bit key, the float32 bits
// of d2 (non-negative, so they order as integers) above the index; keys are
// distinct. The warp keeps its k smallest keys sorted in shared memory: a
// step's survivors are sorted across the warp (bitonic, by shuffles) and
// merged into the list by rank into a second buffer. Once the list is full,
// a candidate survives only below its last key, which each lane holds in a
// register.
//
// What bounds it on this card: the pair tests, ~8 float operations on 16
// bytes of shared memory each, Q x N of them; the bound counts those
// operations and each input and output byte once. The merges add work per
// survivor: few with a radius (a query's within-r count), about k log(N / k)
// without one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kTile = 1024;  // points staged per block step
constexpr int kMaxWarps = 8;

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

template <bool COUNTS>
__global__ void knn_warp_kernel(
    const float* __restrict__ q_pts,            // (Q, 3)
    const unsigned char* __restrict__ q_valid,  // (Q,) bool, or null: all valid
    int nq,
    const float* __restrict__ pts,              // (N, 3)
    const unsigned char* __restrict__ p_valid,  // (N,) bool
    int n, float r2, int k,
    int* __restrict__ out_idx,                  // (Q, k), or (Q,) counts
    float* __restrict__ out_d2) {               // (Q, k)
  extern __shared__ unsigned long long smem[];
  float* tx = reinterpret_cast<float*>(smem);
  float* ty = tx + kTile;
  float* tz = ty + kTile;
  unsigned char* tv = reinterpret_cast<unsigned char*>(tz + kTile);
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int q = blockIdx.x * (blockDim.x >> 5) + wib;
  // Every warp joins the block's barriers; only active ones search.
  const bool active = q < nq && (q_valid == nullptr || q_valid[q] != 0);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < nq) {
    qx = q_pts[3ll * q];
    qy = q_pts[3ll * q + 1];
    qz = q_pts[3ll * q + 2];
  }
  int count = 0;
  int m = 0;  // keys held
  unsigned long long thr = kNone;  // the list's last key once it is full
  unsigned long long* buf0 = nullptr;
  unsigned long long* buf1 = nullptr;
  unsigned long long* sb = nullptr;
  if constexpr (!COUNTS) {
    // Lists after the staged tile (kTile * 13 bytes, a multiple of 8).
    unsigned long long* base = smem + (kTile * 13) / 8 + static_cast<size_t>(wib) * (2 * k + 32);
    buf0 = base;
    buf1 = base + k;
    sb = base + 2 * k;
  }

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int tn = min(kTile, n - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < tn; i += blockDim.x) {
      const long long p = t0 + i;
      tx[i] = pts[3 * p];
      ty[i] = pts[3 * p + 1];
      tz[i] = pts[3 * p + 2];
      tv[i] = p_valid[p];
    }
    __syncthreads();
    if (!active) continue;
    for (int b0 = 0; b0 < tn; b0 += 32) {
      const int i = b0 + lane;
      bool member = false;
      float d2 = 0.f;
      if (i < tn && tv[i]) {
        const float dx = __fsub_rn(qx, tx[i]);
        const float dy = __fsub_rn(qy, ty[i]);
        const float dz = __fsub_rn(qz, tz[i]);
        d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        member = d2 <= r2;
      }
      if constexpr (COUNTS) {
        count += __popc(__ballot_sync(kFull, member));
      } else {
        unsigned long long key = member
            ? (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
                  static_cast<unsigned long long>(static_cast<unsigned>(t0 + i))
            : kNone;
        if (key >= thr) key = kNone;  // the list is full and holds k smaller keys
        const int nb = __popc(__ballot_sync(kFull, key != kNone));
        if (nb == 0) continue;
        key = warp_sort(key, lane);  // survivors first, ascending
        sb[lane] = key;
        __syncwarp();
        // New places in buf1: survivor i at i + #(list < key_i), list
        // element j at j + #(survivors < list_j); keys are distinct.
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
        if (m == k) thr = buf0[k - 1];
        __syncwarp();  // every lane has read buf0 before the next merge writes buf1
      }
    }
  }

  if (q >= nq) return;
  if constexpr (COUNTS) {
    if (lane == 0) out_idx[q] = count;
  } else {
    int* oi = out_idx + static_cast<size_t>(q) * k;
    float* od = out_d2 + static_cast<size_t>(q) * k;
    for (int j = lane; j < k; j += 32) {
      if (j < m) {
        const unsigned long long key = buf0[j];
        oi[j] = static_cast<int>(static_cast<unsigned>(key & 0xffffffffull));
        od[j] = __uint_as_float(static_cast<unsigned>(key >> 32));
      } else {
        oi[j] = -1;
        od[j] = __int_as_float(0x7f800000);  // inf
      }
    }
  }
}

}  // namespace

extern "C" {

// The largest k whose lists (one warp: two lists of k keys and the step's
// 32) fit beside the staged tile in the card's shared memory per block
// (into *out); returns a CUDA error code.
int dc_knn_warp_max_k(int* out) {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long keys = (static_cast<long long>(max_smem) - static_cast<long long>(kTile) * 13) /
                             static_cast<long long>(sizeof(unsigned long long)) - 32;
  *out = keys <= 0 ? 0 : static_cast<int>(keys / 2);
  return 0;
}

// k = 0: counts into out_idx (Q,) int32 (q_valid is ignored: every query
// counts); k > 0: the k nearest within r2 into out_idx (Q, k) int32 and
// out_d2 (Q, k) float32 (q_valid may be null: every query is valid).
// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for bad arguments).
int dc_knn_warp(const void* q_pts, const void* q_valid, int nq, const void* pts,
                const void* p_valid, int n, float r2, int k, void* out_idx, void* out_d2,
                void* stream) {
  if (nq < 0 || n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q_pts);
  const unsigned char* qv = static_cast<const unsigned char*>(q_valid);
  const float* pp = static_cast<const float*>(pts);
  const unsigned char* pv = static_cast<const unsigned char*>(p_valid);
  int* oi = static_cast<int*>(out_idx);
  const size_t tile_bytes = static_cast<size_t>(kTile) * 13;
  if (k == 0) {
    const int warps = kMaxWarps;
    const int blocks = (nq + warps - 1) / warps;
    knn_warp_kernel<true><<<blocks, 32 * warps, tile_bytes, st>>>(
        qp, nullptr, nq, pp, pv, n, r2, 0, oi, nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  // Shared memory: the staged tile, then per warp two lists of k keys and
  // the step's 32 keys.
  const size_t per_warp = (2 * static_cast<size_t>(k) + 32) * sizeof(unsigned long long);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int warps = kMaxWarps;
  while (warps > 1 && tile_bytes + warps * per_warp > static_cast<size_t>(max_smem)) warps >>= 1;
  const size_t smem = tile_bytes + warps * per_warp;
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(knn_warp_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (nq + warps - 1) / warps;
  knn_warp_kernel<false><<<blocks, 32 * warps, smem, st>>>(
      qp, qv, nq, pp, pv, n, r2, k, oi, static_cast<float*>(out_d2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
