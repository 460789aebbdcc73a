// X4 and X5, first versions, kept for the A/B against
// their redesigns in transpose_gather.cu; reached only through
// ops/features.transpose_moments_v1 / transpose_gather_v1 (counters
// _kernels.TRANSPOSE_MOMENTS_V1_LAUNCHES / TRANSPOSE_GATHER_V1_LAUNCHES).
// They walk the targets in point order over the point-order CSR; each
// target's sum is taken in the same order as the redesigns take it.
//
// The gather engine's analytic backward over a transpose graph, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the JAX package's scatter-free backward passes, which gather
// through a padded transpose of the frozen neighbourhoods
// (depth_correction_tpu/ops/features.py):
//   X4  _moments_bwd (:604-638), the VJP of neighborhood_moments: for each
//       point j, grad_j = sum over the pairs (i, k) of its CSR run of
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
// The transpose is a CSR over the target points (build_transpose_graph):
// start (M + 1) int32, pair (P) int32 = i * K + k, ascending within a
// point's run; X4 also reads w (P) float32, the pair's frozen weight, and
// a per-row table of 12 floats (S00 S11 S22 S01 | S02 S12 mu_x mu_y |
// mu_z h_x h_y h_z, h = gmu / W): three 16-byte loads a pair. X4 keeps the
// centred form S_i (x_j - mu_i): the JAX form (sum w S) x_j + sum w
// (h - S mu) subtracts two terms of size |S| |x| in global coordinates,
// which in float32 costs |x| / |x_j - mu_i| ulps of the gradient on a
// drive kilometres from its origin. A row with one neighbour has
// x_j - mu_i = 0 exactly, so its huge S (the normaliser clamps at 1e-6)
// contributes exactly 0, as autograd's gradient does.
//
// Design: eight lanes a point, 32 points a 256-thread block. The lanes
// stride the point's run (lane l takes pairs l, l + 8, ...), each summing
// its pairs in order, and a butterfly of shuffles within the eight lanes
// adds the partial sums in a fixed order; lane 0 writes. No atomics: the
// sum order depends on the graph alone, so every run gives the same bits
// (autograd's index_add backward makes no such promise). A hub of
// hundreds of pairs is spread over its eight lanes, not one thread. A
// point with no pairs gets exactly 0 (the padding points' rule).
//
// What bounds it on this card: bytes. Each pair reads its index and
// weight (8 bytes, coalesced within a run) and one 48-byte table row; the
// table (12 floats a row, 10.7 MB on the capped bench graph) stays in the
// 50 MB L2, so the device-memory bytes are the CSR, the points and the
// gradient: on the capped graph (7.2 M pairs, 390,144 points) ~78 MB,
// 0.023 ms at 3.35 TB/s. Eight lanes a point match the mean in-degree
// (~18 capped, ~32 at scale): a warp a point would idle half its lanes.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 8;  // lanes a point
constexpr int kThreads = 256;
constexpr int kPointsPerBlock = kThreads / kLanes;

// The sum of v over the point's eight lanes, in a fixed order; every lane
// of the warp must call it.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4, kLanes);
  v += __shfl_xor_sync(kFull, v, 2, kLanes);
  v += __shfl_xor_sync(kFull, v, 1, kLanes);
  return v;
}

__global__ void __launch_bounds__(kThreads)
transpose_moments_v1_kernel(const float* __restrict__ pts, int m, const int* __restrict__ start,
                         const int* __restrict__ pair, const float* __restrict__ w,
                         const float4* __restrict__ table, int k, float* __restrict__ grad) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int j = blockIdx.x * kPointsPerBlock + threadIdx.x / kLanes;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (j < m) {
    const int s = __ldg(start + j);
    const int e = __ldg(start + j + 1);
    if (s < e) {
      const size_t j3 = 3 * static_cast<size_t>(j);
      const float x = __ldg(pts + j3), y = __ldg(pts + j3 + 1), z = __ldg(pts + j3 + 2);
      for (int p = s + lane; p < e; p += kLanes) {
        const size_t r = 3 * static_cast<size_t>(__ldg(pair + p) / k);
        const float wp = __ldg(w + p);
        const float4 a = __ldg(table + r);      // S00 S11 S22 S01
        const float4 b = __ldg(table + r + 1);  // S02 S12 mu_x mu_y
        const float4 c = __ldg(table + r + 2);  // mu_z h_x h_y h_z
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
  if (j < m && lane == 0) {
    const size_t j3 = 3 * static_cast<size_t>(j);
    grad[j3] = ax;
    grad[j3 + 1] = ay;
    grad[j3 + 2] = az;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
transpose_gather_v1_kernel(const float* __restrict__ g, int m, const int* __restrict__ start,
                        const int* __restrict__ pair, float* __restrict__ out) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int j = blockIdx.x * kPointsPerBlock + threadIdx.x / kLanes;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (j < m) {
    const int e = __ldg(start + j + 1);
    for (int p = __ldg(start + j) + lane; p < e; p += kLanes) {
      const size_t base = static_cast<size_t>(__ldg(pair + p)) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += __ldg(g + base + d);
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = group_sum(acc[d]);
  if (j < m && lane == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[static_cast<size_t>(j) * D + d] = acc[d];
  }
}

int blocks_for(int m) { return (m + kPointsPerBlock - 1) / kPointsPerBlock; }

}  // namespace

extern "C" {

// X4. pts (m, 3) float32, start (m + 1) int32, pair / w (P) int32 / float32
// (P = start[m]), table (rows, 12) float32 on a 16-byte boundary, k the
// neighbour table's width (row i = pair / k) -> grad (m, 3) float32, every
// row written. Launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() (cudaErrorInvalidValue for bad arguments).
int dc_transpose_moments_v1(const void* pts, int m, const void* start, const void* pair,
                         const void* w, const void* table, int k, void* grad, void* stream) {
  if (m < 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    transpose_moments_v1_kernel<<<blocks_for(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), m, static_cast<const int*>(start),
        static_cast<const int*>(pair), static_cast<const float*>(w),
        static_cast<const float4*>(table), k, static_cast<float*>(grad));
  }
  return static_cast<int>(cudaGetLastError());
}

// X5. g (slots, d) float32 with d = 1 or 3 (the cotangent of an (Mq, K[, d])
// gather, slot = i * K + k), start (m + 1) int32, pair (P) int32 -> out
// (m, d) float32, every row written. Same stream and error contract as
// dc_transpose_moments_v1.
int dc_transpose_gather_v1(const void* g, int d, int m, const void* start, const void* pair,
                        void* out, void* stream) {
  if (m < 0 || (d != 1 && d != 3)) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d == 1) {
      transpose_gather_v1_kernel<1><<<blocks_for(m), kThreads, 0, s>>>(
          static_cast<const float*>(g), m, static_cast<const int*>(start),
          static_cast<const int*>(pair), static_cast<float*>(out));
    } else {
      transpose_gather_v1_kernel<3><<<blocks_for(m), kThreads, 0, s>>>(
          static_cast<const float*>(g), m, static_cast<const int*>(start),
          static_cast<const int*>(pair), static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
