// X4 and X5: the gather engine's analytic backward over a transpose graph,
// for Hopper (sm_90a), with a plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the JAX package's scatter-free backward passes, which gather
// through a padded transpose of the frozen neighbourhoods
// (depth_correction_tpu/ops/features.py):
//   X4  _moments_bwd (:604-638), the VJP of neighborhood_moments: for each
//       point j, grad_j = sum over the pairs (i, k) of its run of
//       w_ik (S_i (x_j - mu_i) + gmu_i / W_i), with S_i the symmetric
//       cotangent matrix over the row's Bessel normaliser, mu_i the row's
//       mean and gmu_i / W_i the mean's cotangent over the weight sum;
//   X5  _gather_t_bwd / _gather_T_bwd (:423-443, :460-469), the VJP of
//       the pair-level neighbour gather under nn_scale:
//       grad_values[j] = sum over (i, k) of the run of g[i, k, :], D = 1
//       or 3.
// The plain torch versions are transpose_moments_plain and
// transpose_gather_plain in depth_correction_tpu_torch/ops/features.py.
//
// Why the targets are not walked in point order: there no two pairs of 32
// consecutive targets share a row, so X4 would read every pair's 48-byte
// table row anew from L2 (two sectors a pair, ~0.5 GB of L2 traffic a
// launch on the capped bench graph) and X5 every pair's cotangent at a
// scattered address of an (Mq * K, D) array larger than L2, one sector a
// pair from device memory.
//
// Layout (ops/features.TransposeGraph, built once in prep): the targets
// sorted by the Morton key of their positions (order), and the CSR (start,
// pair, w, local) laid out in that order, so that each block's runs
// stream coalesced and a tile of consecutive targets reuses each row it
// references several times (6-11 on the bench graphs). Reading a
// point-order CSR through order instead would scatter every run's loads.
// The graph holds this one CSR; the point-order one is derived from it
// where it is needed (features.point_csr). The runs keep their
// point-order sequence, so each target's sum is taken in that order
// whichever CSR is walked. Tiles: at most 128 consecutive
// targets (TILE_TARGETS) referencing at most `budget` distinct rows (the
// builder halves a block until it fits; a lone target past the budget is
// a hub tile), rows[row_start[b]:row_start[b + 1]] ascending, and each
// pair's index into its tile's rows in local (uint16).
//
// X4: a 256-thread block a tile. It copies the tile's rows of the table
// (12 floats: S00 S11 S22 S01 | S02 S12 mu_x mu_y | mu_z h_x h_y h_z, h =
// gmu / W) into shared memory with 16-byte cp.async copies and waits at a
// barrier; then eight lanes a target stride its run (lane l takes pairs
// l, l + 8, ...), read each pair's local index and weight (6 bytes,
// coalesced) and its row from shared memory, and a butterfly of shuffles
// within the eight lanes adds the partial sums in a fixed order; lane 0
// writes grad[order[t]]. A hub tile's 256 threads stride its one run,
// read the rows through pair / k from global memory, and add their sums
// by a fixed tree. No atomics: every launch
// gives the same bits. X4 keeps the centred form S_i (x_j - mu_i): the
// JAX form (sum w S) x_j + sum w (h - S mu) subtracts two terms of size
// |S| |x| in global coordinates, which in float32 costs |x| / |x_j - mu_i|
// ulps of the gradient on a drive kilometres from its origin. A row with
// one neighbour has x_j - mu_i = 0 exactly, so its huge S (the normaliser
// clamps at 1e-6) contributes exactly 0, as autograd's gradient does. A
// target with no pairs gets exactly 0.
//
// X5: eight lanes a target as X4, 32 targets a block, in the cell order:
// neighbouring blocks read the same rows of g at about the same time, so
// each sector comes from device memory once and from L2 after that. No
// staging: a tile touches about 9 of a row's 32 slots, so staging row
// segments would move more bytes than it saves.
//
// What bounds them on this card: bytes. X4 streams 6 bytes a pair and
// reads each staged row once a tile (48 bytes over ~9 pairs), X5 16 bytes
// a pair. The bounds count what each design reads once (chip_smoke.py
// transpose_bounds): X4 the order, run starts, tile tables and row lists,
// 6 bytes a pair, a hub tile's pair indices, the table, the points and
// the gradient; X5 the order, run starts, 16 bytes a pair and its output.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 8;  // lanes a target
constexpr int kThreads = 256;
constexpr int kTargetsPerPass = kThreads / kLanes;
constexpr int kWarps = kThreads / 32;

// The sum of v over the target's eight lanes, in a fixed order; every lane
// of the warp must call it.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4, kLanes);
  v += __shfl_xor_sync(kFull, v, 2, kLanes);
  v += __shfl_xor_sync(kFull, v, 1, kLanes);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// One pair's term w (S (x - mu) + h) added to (ax, ay, az): the first
// design's fma chain.
__device__ __forceinline__ void add_pair(float wp, const float4& a, const float4& b,
                                         const float4& c, float x, float y, float z, float& ax,
                                         float& ay, float& az) {
  const float dx = x - b.z, dy = y - b.w, dz = z - c.x;
  ax = fmaf(wp, fmaf(a.x, dx, fmaf(a.w, dy, fmaf(b.x, dz, c.y))), ax);
  ay = fmaf(wp, fmaf(a.w, dx, fmaf(a.y, dy, fmaf(b.y, dz, c.z))), ay);
  az = fmaf(wp, fmaf(b.x, dx, fmaf(b.y, dy, fmaf(a.z, dz, c.w))), az);
}

// A hub tile: the block's 256 threads stride each target's run, reading
// the rows from global memory, and add their sums by a fixed tree through
// part (3 * kWarps floats of shared memory).
__device__ void hub_tile(const float* __restrict__ pts, const int* __restrict__ order,
                         const int* __restrict__ start, const int* __restrict__ pair,
                         const float* __restrict__ w, const float4* __restrict__ table, int k,
                         int t0, int t1, float (*part)[kWarps], float* __restrict__ grad) {
  for (int t = t0; t < t1; ++t) {
    const int j = __ldg(order + t);
    const size_t j3 = 3 * static_cast<size_t>(j);
    const float x = __ldg(pts + j3), y = __ldg(pts + j3 + 1), z = __ldg(pts + j3 + 2);
    float ax = 0.f, ay = 0.f, az = 0.f;
    const int e = __ldg(start + t + 1);
    for (int p = __ldg(start + t) + threadIdx.x; p < e; p += kThreads) {
      const size_t r = 3 * static_cast<size_t>(__ldg(pair + p) / k);
      add_pair(__ldg(w + p), __ldg(table + r), __ldg(table + r + 1), __ldg(table + r + 2), x, y,
               z, ax, ay, az);
    }
    for (int off = 16; off > 0; off >>= 1) {
      ax += __shfl_xor_sync(kFull, ax, off);
      ay += __shfl_xor_sync(kFull, ay, off);
      az += __shfl_xor_sync(kFull, az, off);
    }
    if ((threadIdx.x & 31) == 0) {
      part[0][threadIdx.x / 32] = ax;
      part[1][threadIdx.x / 32] = ay;
      part[2][threadIdx.x / 32] = az;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += part[threadIdx.x][i];
      grad[j3 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
transpose_moments_kernel(const float* __restrict__ pts, const int* __restrict__ order,
                         const int* __restrict__ start, const int* __restrict__ pair,
                         const float* __restrict__ w, const unsigned short* __restrict__ local,
                         const int* __restrict__ tile_start, const int* __restrict__ row_start,
                         const int* __restrict__ rows, const float4* __restrict__ table, int k,
                         int budget, float* __restrict__ grad) {
  // The kernel's only shared memory: a tile's rows, or a hub tile's part
  // sums (the launcher sizes it for both).
  extern __shared__ float4 staged[];
  const int t0 = __ldg(tile_start + blockIdx.x), t1 = __ldg(tile_start + blockIdx.x + 1);
  const int r0 = __ldg(row_start + blockIdx.x);
  const int nr = __ldg(row_start + blockIdx.x + 1) - r0;
  if (nr > budget) {
    hub_tile(pts, order, start, pair, w, table, k, t0, t1,
             reinterpret_cast<float(*)[kWarps]>(staged), grad);
    return;
  }
  for (int e = threadIdx.x; e < 3 * nr; e += kThreads) {
    const int r = e / 3;
    cp_async16(staged + e, table + 3 * static_cast<size_t>(__ldg(rows + r0 + r)) + (e - 3 * r));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int lane = threadIdx.x & (kLanes - 1);
  // The bound of this loop is the block's, so every lane reaches group_sum.
  for (int base = t0; base < t1; base += kTargetsPerPass) {
    const int t = base + threadIdx.x / kLanes;
    float ax = 0.f, ay = 0.f, az = 0.f;
    int j = 0;
    if (t < t1) {
      j = __ldg(order + t);
      const int s = __ldg(start + t), e = __ldg(start + t + 1);
      if (s < e) {
        const size_t j3 = 3 * static_cast<size_t>(j);
        const float x = __ldg(pts + j3), y = __ldg(pts + j3 + 1), z = __ldg(pts + j3 + 2);
        for (int p = s + lane; p < e; p += kLanes) {
          const int l = 3 * static_cast<int>(__ldg(local + p));
          add_pair(__ldg(w + p), staged[l], staged[l + 1], staged[l + 2], x, y, z, ax, ay, az);
        }
      }
    }
    ax = group_sum(ax);
    ay = group_sum(ay);
    az = group_sum(az);
    if (t < t1 && lane == 0) {
      const size_t j3 = 3 * static_cast<size_t>(j);
      grad[j3] = ax;
      grad[j3 + 1] = ay;
      grad[j3 + 2] = az;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
transpose_gather_kernel(const float* __restrict__ g, int m, const int* __restrict__ order,
                        const int* __restrict__ start, const int* __restrict__ pair,
                        float* __restrict__ out) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int t = blockIdx.x * kTargetsPerPass + threadIdx.x / kLanes;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (t < m) {
    const int e = __ldg(start + t + 1);
    for (int p = __ldg(start + t) + lane; p < e; p += kLanes) {
      const size_t base = static_cast<size_t>(__ldg(pair + p)) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += __ldg(g + base + d);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = group_sum(acc[d]);
  if (t < m && lane == 0) {
    const size_t j = static_cast<size_t>(__ldg(order + t));
#pragma unroll
    for (int d = 0; d < D; ++d) out[j * D + d] = acc[d];
  }
}

}  // namespace

extern "C" {

// X4. pts (m, 3) float32; the transpose of ops/features.TransposeGraph:
// order (m) int32, start (m + 1) int32, pair / w / local (P) int32 /
// float32 / uint16, tile_start / row_start (tiles + 1) int32, rows int32;
// table (rows of the graph, 12) float32 on a 16-byte boundary; k the
// neighbour table's width (row i = pair / k); budget the rows a tile may
// stage and rows_max the most a tile within it holds (the shared memory:
// 48 bytes a row, and at least a hub tile's part sums; past 48 KB the
// kernel opts in) -> grad (m, 3) float32, every row written (the tiles
// cover every target). Launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue for
// bad arguments).
int dc_transpose_moments(const void* pts, int m, int tiles, const void* order, const void* start,
                         const void* pair, const void* w, const void* local,
                         const void* tile_start, const void* row_start, const void* rows,
                         const void* table, int k, int budget, int rows_max, void* grad,
                         void* stream) {
  if (m < 0 || tiles < 0 || k <= 0 || budget <= 0 || rows_max < 0 || rows_max > budget)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 0) {
    size_t smem = static_cast<size_t>(rows_max) * 3 * sizeof(float4);
    if (smem < sizeof(float[3][kWarps])) smem = sizeof(float[3][kWarps]);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          transpose_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    transpose_moments_kernel<<<tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const int*>(order),
        static_cast<const int*>(start), static_cast<const int*>(pair),
        static_cast<const float*>(w), static_cast<const unsigned short*>(local),
        static_cast<const int*>(tile_start), static_cast<const int*>(row_start),
        static_cast<const int*>(rows), static_cast<const float4*>(table), k, budget,
        static_cast<float*>(grad));
  }
  return static_cast<int>(cudaGetLastError());
}

// X5. g (slots, d) float32 with d = 1 or 3 (the cotangent of an (Mq, K[, d])
// gather, slot = i * K + k); order (m) int32, start (m + 1) int32, pair (P)
// int32 of the transpose -> out (m, d) float32, every row written. Same stream
// and error contract as dc_transpose_moments.
int dc_transpose_gather(const void* g, int d, int m, const void* order, const void* start,
                        const void* pair, void* out, void* stream) {
  if (m < 0 || (d != 1 && d != 3)) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = (m + kTargetsPerPass - 1) / kTargetsPerPass;
    if (d == 1) {
      transpose_gather_kernel<1><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(g), m, static_cast<const int*>(order),
          static_cast<const int*>(start), static_cast<const int*>(pair), static_cast<float*>(out));
    } else {
      transpose_gather_kernel<3><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(g), m, static_cast<const int*>(order),
          static_cast<const int*>(start), static_cast<const int*>(pair), static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
