// Grid-hash radius search (X2) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces depth_correction_tpu/ops/grid_hash.py:_grid_query_chunk_impl
// (:108-225, plain XLA, reached through grid_radius_neighbors :468 and the
// node's gather-window program): for each query, the up-to-k nearest
// points within r, or the number of them (k = 0), from a grid of cells of
// side >= r whose points are sorted by linear cell id. Its plain torch
// version is _grid_query_chunk_plain in depth_correction_tpu_torch/ops/grid_hash.py.
//
// The search, as the JAX query does it: the query's cell cq = floor((q -
// mins) / cell); its 9 (dx, dy) columns in the order dx, dy in (-1, 0, 1),
// each the z-run of cells [cz - 1, cz + 1] clamped into the grid (a
// column off the grid's x or y range is empty). The cells of a column have
// consecutive linear ids, so its points are one run of sorted slots:
// [lower_bound(ids, lo), lower_bound(ids, hi + 1)). A run is cut at `cap`
// slots when the caller gives a cap (the JAX query's window, which cuts
// only when the caller's bucket_cap undersized the grid). Invalid points
// carry an id past every cell and fall in no run. Members: d2 <= r2 with
// d2 = dx*dx + dy*dy + dz*dz rounded step by step (no fused multiply-add),
// as the float32 twin computes it, so both decide membership alike.
//
// The top-k keeps lax.top_k's order: ascending d2, and among equal d2 the
// lower candidate position, which is (column, slot). Each candidate is one
// 64-bit key: the float32 bits of d2 (non-negative, so they order as
// integers) above (column << 28 | slot); keys are distinct.
//
// Design (one warp per query): 18 lanes run the 9 columns' two binary
// searches at once; lanes then stride each run, 32 candidates a step. Counts
// add up ballots. For k > 0 the warp gathers its members' keys into a list
// and sorts it once:
// - While the list has room (m + nb <= k), a step's nb members are appended
//   at m + their rank in the step's ballot: one store a member, no sort.
// - The list is sorted once, when the query ends or at the first step that
//   would overflow it: 32-key runs by shuffles, then pairwise merges by rank
//   (sort_list). Only from an overflow on does a step sort its members,
//   drop those not below the list's last key, and merge. In prep k is sized
//   by the counts, so no list overflows there.
// - k <= 32 (the grid node's k = 32 and below) keeps the list in registers,
//   one key a lane; a full list takes a step's sorted members by a bitonic
//   merge over shuffles (the batch reversed, the lane-wise minimum, then
//   five half-cleaners). k > 32 keeps it in shared memory and merges by
//   rank.
// - When the queries are the grid's own points (prep, the grid node), warp
//   w answers query order[w]: neighbouring warps then read the same column
//   runs and ids. Each result lands in its query's own row.
// The keys are distinct, so the k smallest in ascending order are one list
// however they are gathered: the result equals the plain version's bit for
// bit (held by chip_smoke.py phase 7 and the card tests).
//
// What bounds it on this card: per query, ~9 x 2 binary searches over the
// sorted ids (dependent loads, L2-resident at these sizes) and ~8 float
// ops per candidate on 12 bytes of positions; the bound counts the pair
// tests' operations and the bytes once, the (Q, k) outputs included. The
// top-k adds the sort of each list, which a bitonic sort of the list padded
// to a power of two, in registers or in shared memory, did not beat
// (PERF.md §6). No dense start table and no static width: nothing to
// retry.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kSlotBits = 28;  // slot < 2^28 (checked by the launcher)
constexpr int kMaxWarps = 4;   // warps per block with the list in shared memory
constexpr int kRegWarps = 8;   // warps per block with the list in registers
// Lists of up to this many keys live in registers, one key a lane.
constexpr int kRegListMaxK = 32;

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

// The compare-exchange of one bitonic stage across lanes: the lower lane of
// each pair (lane, lane ^ stride) keeps the minimum when `up`.
__device__ __forceinline__ unsigned long long half_clean(unsigned long long key, int lane,
                                                         int stride, bool up) {
  const unsigned long long other = __shfl_xor_sync(kFull, key, stride);
  const bool lower = (lane & stride) == 0;
  return (lower == up) ? min(key, other) : max(key, other);
}

// Ascending bitonic sort of one 64-bit key per lane.
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long key, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      key = half_clean(key, lane, stride, (lane & size) == 0 || size == 32);
  }
  return key;
}

// Ascending sort of a[0, m) by one warp, with b[0, m) as scratch; returns
// the buffer that holds the result. Each 32-key run is sorted by shuffles,
// then runs are merged pairwise by rank: a key's place in the merged run is
// its place in its own run plus the number of smaller keys in the other (a
// binary search; the keys are distinct). Nothing is padded to a power of
// two, and no key moves more than once a level.
__device__ unsigned long long* sort_list(unsigned long long* a, unsigned long long* b, int m,
                                         int lane) {
  for (int c = 0; c < m; c += 32) {
    unsigned long long key = c + lane < m ? a[c + lane] : kNone;
    key = warp_sort(key, lane);
    if (c + lane < m) a[c + lane] = key;
  }
  __syncwarp();
  for (int len = 32; len < m; len <<= 1) {
    for (int i = lane; i < m; i += 32) {
      const int run = i & ~(len - 1);
      const int other = run ^ len;
      const unsigned long long x = a[i];
      int pos = (run & ~(2 * len - 1)) + (i - run);
      if (other < m) pos += lower_bound_keys(a + other, min(other + len, m) - other, x);
      b[pos] = x;
    }
    __syncwarp();
    unsigned long long* t = a;
    a = b;
    b = t;
  }
  return a;
}

// The bit position of the r-th (from 0) set bit of mask (mask has more
// than r set bits).
__device__ __forceinline__ int nth_set_bit(unsigned mask, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    if (__popc(mask & ((1u << (pos + w)) - 1u)) <= r) pos += w;
  return pos;
}

__device__ __forceinline__ float f32_floor_coord(float v) {
  return fminf(fmaxf(floorf(v), -1073741824.f), 1073741824.f);  // +-2^30
}

__device__ __forceinline__ void write_key(unsigned long long key, const int* __restrict__ order,
                                          int* oi, float* od) {
  if (key != kNone) {
    const int slot = static_cast<int>(key & ((1ull << kSlotBits) - 1));
    *oi = order[slot];
    *od = __fsqrt_rn(__uint_as_float(static_cast<unsigned>(key >> 32)));
  } else {
    *oi = -1;
    *od = __int_as_float(0x7f800000);  // inf
  }
}

// MODE 0: counts; 1: top-k, list in shared memory; 2: top-k (k <= 32),
// list in registers.
template <int MODE>
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
    float* __restrict__ out_d,          // (Q, k)
    const int* __restrict__ q_order) {  // (Q,) the warps' queries, or null
  constexpr bool COUNTS = MODE == 0;
  constexpr bool REG = MODE == 2;
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + wib;
  if (w >= nq) return;  // uniform across the warp
  const int q = q_order != nullptr ? q_order[w] : w;
  const unsigned below = (1u << lane) - 1u;

  const bool valid = q_valid[q] != 0;
  int count = 0;
  int m = 0;             // keys held
  bool sorted = false;   // the list is sorted (from its first overflow on)
  unsigned long long lst = kNone;  // REG: lane j holds key j of the list
  unsigned long long* buf0 = nullptr;
  unsigned long long* buf1 = nullptr;
  unsigned long long* sb = nullptr;
  if constexpr (MODE == 1) {
    unsigned long long* base = smem + static_cast<size_t>(wib) * (2 * k + 32);
    buf0 = base;
    buf1 = base + k;
    sb = base + 2 * k;
  }
  // Sorts the list buf0[0, m), which then lies in buf0 (the two lists swap).
  auto sort_into_buf0 = [&]() {
    unsigned long long* res = sort_list(buf0, buf1, m, lane);
    if (res != buf0) {
      buf1 = buf0;
      buf0 = res;
    }
  };

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
          // A sorted list is full: only keys below its last can enter.
          if (sorted) {
            const unsigned long long last = REG ? __shfl_sync(kFull, lst, k - 1) : buf0[k - 1];
            if (key > last) key = kNone;
          }
          const unsigned ball = __ballot_sync(kFull, key != kNone);
          const int nb = __popc(ball);
          if (nb == 0) continue;
          if (!sorted && m + nb <= k) {
            // Room for every member: append at m + rank, unsorted.
            if constexpr (REG) {
              const bool dst = lane >= m && lane < m + nb;
              const unsigned long long v =
                  __shfl_sync(kFull, key, dst ? nth_set_bit(ball, lane - m) : lane);
              if (dst) lst = v;
            } else {
              if (key != kNone) buf0[m + __popc(ball & below)] = key;
            }
            m += nb;
            continue;
          }
          // The first overflow sorts the list; every later step merges.
          if (!sorted) {
            if constexpr (REG) {
              lst = warp_sort(lst, lane);
            } else {
              __syncwarp();
              sort_into_buf0();
            }
            sorted = true;
          }
          key = warp_sort(key, lane);  // members first, ascending
          if constexpr (REG) {
            // Bitonic merge: the batch descending against the list
            // ascending; the lane-wise minimum holds the 32 smallest of
            // both as a bitonic sequence, which five half-cleaners sort.
            key = __shfl_sync(kFull, key, 31 - lane);
            lst = min(lst, key);
#pragma unroll
            for (int stride = 16; stride > 0; stride >>= 1)
              lst = half_clean(lst, lane, stride, true);
            if (lane >= k) lst = kNone;
          } else {
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
            unsigned long long* t = buf0;
            buf0 = buf1;
            buf1 = t;
          }
          m = min(k, m + nb);
        }
      }
    }
  }

  if constexpr (COUNTS) {
    if (lane == 0) out_idx[q] = count;
  } else {
    int* oi = out_idx + static_cast<size_t>(q) * k;
    float* od = out_d + static_cast<size_t>(q) * k;
    if constexpr (REG) {
      if (!sorted) lst = warp_sort(lst, lane);
      if (lane < k) write_key(lst, order, oi + lane, od + lane);
    } else {
      __syncwarp();
      if (!sorted) sort_into_buf0();
      for (int j = lane; j < k; j += 32) write_key(j < m ? buf0[j] : kNone, order, oi + j, od + j);
    }
  }
}

}  // namespace

extern "C" {

// k = 0: counts into out_idx (Q,) int32; k > 0: the k nearest into out_idx
// (Q, k) int32 and out_d (Q, k) float32. cap < 0 reads every run whole.
// q_order, when not null, is a permutation of [0, Q): warp w answers query
// q_order[w] (the queries in the grid's slot order when they are its own
// points, so that neighbouring warps read the same runs). Launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for bad arguments).
int dc_grid_query(const void* q_pts, const void* q_valid, int nq, const void* pts_T,
                  const void* ids, const void* order, int n, const void* mins,
                  const void* dims, const void* cell, float r2, int k, long long cap,
                  void* out_idx, void* out_d, const void* q_order, void* stream) {
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
  float* od = static_cast<float*>(out_d);
  const int* qo = static_cast<const int*>(q_order);
  if (k == 0 || k <= kRegListMaxK) {
    const int blocks = (nq + kRegWarps - 1) / kRegWarps;
    if (k == 0)
      grid_query_kernel<0><<<blocks, 32 * kRegWarps, 0, st>>>(
          qp, qv, nq, pt, pi, po, n, pm, pd, pc, r2, 0, cap, oi, nullptr, qo);
    else
      grid_query_kernel<2><<<blocks, 32 * kRegWarps, 0, st>>>(
          qp, qv, nq, pt, pi, po, n, pm, pd, pc, r2, k, cap, oi, od, qo);
    return static_cast<int>(cudaGetLastError());
  }
  // Shared memory per warp: two lists of k keys (the sort uses both, up to
  // the least power of two >= k) and the step's 32 keys.
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
    err = cudaFuncSetAttribute(grid_query_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (nq + warps - 1) / warps;
  grid_query_kernel<1><<<blocks, 32 * warps, smem, st>>>(
      qp, qv, nq, pt, pi, po, n, pm, pd, pc, r2, k, cap, oi, od, qo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
