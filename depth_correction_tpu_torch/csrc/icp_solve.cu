// The ICP step's gate and normal equations (X6) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces no Pallas kernel. It replaces the XLA code of one point-to-plane
// Gauss-Newton step after its 1-NN search, depth_correction_tpu/slam_eval.py:48-71
// (_icp_step: the quantile gate, J, the normal equations, the 6x6 solve, the
// twist's matrix), and `delta @ T` of its scan (:78-81). Its plain torch
// version is icp_update_plain in depth_correction_tpu_torch/ops/icp.py; in
// torch the step was ~120 small launches and one host read (the quantile's
// two positions) an iteration, so each ICP iteration drained the queue.
//
// What it computes, from the search's (d2, idx) (kernel X3 at k = 1, no
// radius) of the source points p (placed by T) in the target points, with the
// target's normals, the source's validity and the inlier ratio q:
//   ok_i  = idx_i >= 0 and src_valid_i; k = the number of ok rows;
//   thr   = ops/reduce.py:masked_quantile of d_i = sqrt(d2_i) over the ok
//           rows: the order statistics at floor and ceil of pos = q (k - 1)
//           (float32, clamped to the rows), the masked rows sorted to +inf,
//           interpolated as v_lo (1 - frac) + v_hi frac. sqrt is monotone and
//           correctly rounded, so the square roots of the sorted d2 at those
//           positions are the sorted d's values; each operation is rounded
//           on its own as torch's separate launches round it, so thr is
//           torch's bit for bit. k = 0 gives NaN (inf * 0), and no inlier;
//   w_i   = ok_i and d_i <= thr;
//   r_i   = n_i . (q_i - p_i), J_i = [p_i x n_i, n_i], float32 as torch
//           computes them, each operation rounded on its own;
//   H = sum w J^T J, g = sum w J r, and sum w |r|: each product exact in
//           float64 (two float32 factors), summed in float64;
//   dx    = (H + 1e-9 I)^-1 g, LU with partial pivoting in float64, as
//           torch.linalg.solve_ex factors;
//   T'    = xyz_axis_angle_to_matrix([dx[3:], dx[:3]]) @ T in float64 (the
//           small-angle series below t^2 = 1e-8, as ops/se3.py), stored float32;
//   err   = mean |r| over the inliers, 0 without one.
// Nothing is read back to the host: T' and err are tensors the next step
// consumes on the stream.
//
// What bounds it on this card: launches and latency, not bytes or operations.
// An iteration of box_r25.slam needs ~2.6 MB (each of 65,024 rows' d2, idx,
// validity and placed source point, each of ~51,600 inliers' target point
// and normal), ~0.8 us at 3.35 TB/s, and ~1.6 MFLOP. So the design spends
// few launches and keeps the host out:
// 1. icp_gate_kernel writes each row's sort key (d2 where ok, +inf else),
//    each block's count of ok rows, and zeroes the ticket of launch 2.
// 2. The caller sorts the keys (torch.sort, the library's radix sort, on the
//    same stream); no position is read on the host.
// 3. icp_solve_kernel: every block sums the gate's counts (integers, exact
//    in any order) to k, picks thr from the sorted keys, and accumulates its
//    rows' 28 sums in float64, reduced in a fixed order (shuffles, then warp
//    by warp) into its partial in scratch. The last block to finish, found by
//    an integer ticket, adds the partials in block order (no float atomics:
//    a run is bit-equal to the next), solves and writes T' and err.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 2;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kH = 21;             // J^T W J's upper triangle, row by row
constexpr int kSums = kH + 6 + 1;  // then J^T W r (6) and sum |r|
// stats (float64, written only where the caller passes it): [0, 21) H's
// upper triangle (without the 1e-9), [21, 27) g, 27 sum |r|, 28 the
// inliers, 29 k (the ok rows), 30 thr, [31, 37) dx.
constexpr int kStats = 40;

struct Layout {
  size_t ticket, counts, partials, inliers, total;
};

size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

int blocks_for(int n) { return n > 0 ? (n + kRowsPerBlock - 1) / kRowsPerBlock : 1; }

Layout layout(int blocks) {
  Layout l;
  l.ticket = 0;
  l.counts = 16;
  l.partials = align16(l.counts + sizeof(int) * static_cast<size_t>(blocks));
  l.inliers = l.partials + sizeof(double) * kSums * static_cast<size_t>(blocks);
  l.total = align16(l.inliers + sizeof(int) * static_cast<size_t>(blocks));
  return l;
}

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ int warp_sum(int c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(kFull, c, o);
  return c;
}

// The block's total of one int a thread, for every thread (integers: exact
// in any order). red holds kWarps ints of shared memory.
__device__ int block_count(int c, int* red) {
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The block's sums of v[0, kSums) and of c, in a fixed order: shuffles
// within each warp, then warp 0, 1, ... in turn. The results land in
// out[0, kSums) and *out_c (shared memory), readable by every thread on
// return.
__device__ void block_sums(double (&v)[kSums], int c, double* red, int* red_c, double* out,
                           int* out_c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_down_sync(kFull, v[j], o);
  }
  c = warp_sum(c);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) red[warp * kSums + j] = v[j];
    red_c[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w * kSums + threadIdx.x];
    out[threadIdx.x] = s;
  } else if (threadIdx.x == kSums) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += red_c[w];
    *out_c = s;
  }
  __syncthreads();
}

// thr from the n sorted keys (d2, +inf where masked) and k ok rows, as
// masked_quantile computes it over d = sqrt(d2).
__device__ float inlier_threshold(const float* __restrict__ sorted, int n, int k, float q) {
  const float pos = __fmul_rn(q, static_cast<float>(k > 1 ? k - 1 : 0));
  const float lo_f = floorf(pos), hi_f = ceilf(pos);
  const float frac = __fsub_rn(pos, lo_f);
  const long long last = static_cast<long long>(n) - 1;
  const long long lo = min(max(static_cast<long long>(lo_f), 0LL), last);
  const long long hi = min(max(static_cast<long long>(hi_f), 0LL), last);
  const float v_lo = n > 0 ? __fsqrt_rn(sorted[lo]) : f_inf();
  const float v_hi = n > 0 ? __fsqrt_rn(sorted[hi]) : f_inf();
  return __fadd_rn(__fmul_rn(v_lo, __fsub_rn(1.f, frac)), __fmul_rn(v_hi, frac));
}

__global__ void __launch_bounds__(kThreads)
icp_gate_kernel(const float* __restrict__ d2, const int* __restrict__ idx,
                const unsigned char* __restrict__ valid, int n, float* __restrict__ key,
                int* __restrict__ counts, unsigned* __restrict__ ticket) {
  __shared__ int red[kWarps];
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0u;  // icp_solve_kernel's
  const int base = blockIdx.x * kRowsPerBlock + threadIdx.x;
  int c = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int i = base + j * kThreads;
    if (i < n) {
      const bool ok = idx[i] >= 0 && valid[i] != 0;
      key[i] = ok ? d2[i] : f_inf();
      c += ok ? 1 : 0;
    }
  }
  c = block_count(c, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// The solve and the update, by one thread of the last block: s the sums,
// count the inliers, k the ok rows.
__device__ void finish(const double* s, int count, int k, float thr, const float* __restrict__ T,
                       float* __restrict__ T_out, float* __restrict__ err_out,
                       double* __restrict__ stats) {
  double A[6][6], b[6], x[6];
  int h = 0;
  for (int a = 0; a < 6; ++a) {
    for (int c = a; c < 6; ++c) {
      A[a][c] = s[h];
      A[c][a] = s[h];
      ++h;
    }
  }
  for (int a = 0; a < 6; ++a) {
    A[a][a] += 1e-9;
    b[a] = s[kH + a];
  }
  // LU with partial pivoting (the first largest pivot), then the two
  // triangular solves.
  for (int c = 0; c < 6; ++c) {
    int p = c;
    double best = fabs(A[c][c]);
    for (int r = c + 1; r < 6; ++r) {
      if (fabs(A[r][c]) > best) {
        best = fabs(A[r][c]);
        p = r;
      }
    }
    if (p != c) {
      for (int j = 0; j < 6; ++j) {
        const double t = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = t;
      }
      const double t = b[c];
      b[c] = b[p];
      b[p] = t;
    }
    for (int r = c + 1; r < 6; ++r) {
      const double f = A[r][c] / A[c][c];
      for (int j = c + 1; j < 6; ++j) A[r][j] -= f * A[c][j];
      b[r] -= f * b[c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double acc = b[r];
    for (int j = r + 1; j < 6; ++j) acc -= A[r][j] * x[j];
    x[r] = acc / A[r][r];
  }
  // J's columns are [rotation, translation]: the axis-angle is x[0, 3).
  const double ax = x[0], ay = x[1], az = x[2];
  const double t2 = ax * ax + ay * ay + az * az;
  const bool small = t2 < 1e-8;
  const double t = sqrt(small ? 1.0 : t2);
  const double sc = small ? 1.0 - t2 / 6.0 : sin(t) / t;
  const double cc = small ? 0.5 - t2 / 24.0 : (1.0 - cos(t)) / t2;
  const double K[3][3] = {{0.0, -az, ay}, {az, 0.0, -ax}, {-ay, ax, 0.0}};
  double D[4][4];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      double kk = 0.0;
      for (int m = 0; m < 3; ++m) kk += K[i][m] * K[m][j];
      D[i][j] = (i == j ? 1.0 : 0.0) + sc * K[i][j] + cc * kk;
    }
    D[i][3] = x[3 + i];
  }
  D[3][0] = D[3][1] = D[3][2] = 0.0;
  D[3][3] = 1.0;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      double acc = 0.0;
      for (int m = 0; m < 4; ++m) acc += D[i][m] * static_cast<double>(T[m * 4 + j]);
      T_out[i * 4 + j] = static_cast<float>(acc);
    }
  }
  *err_out = count > 0 ? static_cast<float>(s[kH + 6] / count) : 0.f;
  if (stats == nullptr) return;
  for (int j = 0; j < kSums; ++j) stats[j] = s[j];
  stats[28] = count;
  stats[29] = k;
  stats[30] = thr;
  for (int j = 0; j < 6; ++j) stats[31 + j] = x[j];
  for (int j = 37; j < kStats; ++j) stats[j] = 0.0;
}

__global__ void __launch_bounds__(kThreads)
icp_solve_kernel(const float* __restrict__ sorted, const int* __restrict__ counts, float q,
                 const float* __restrict__ d2, const int* __restrict__ idx,
                 const unsigned char* __restrict__ valid, const float* __restrict__ src, int n,
                 const float* __restrict__ tgt, const float* __restrict__ nrm,
                 const float* __restrict__ T, double* __restrict__ partials,
                 int* __restrict__ inliers, unsigned* __restrict__ ticket,
                 float* __restrict__ T_out, float* __restrict__ err_out,
                 double* __restrict__ stats) {
  __shared__ double red[kWarps * kSums];
  __shared__ int red_c[kWarps];
  __shared__ double sums[kSums];
  __shared__ int count;
  __shared__ float thr_s;
  __shared__ bool last;

  int c = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) c += counts[b];
  const int k = block_count(c, red_c);
  if (threadIdx.x == 0) thr_s = inlier_threshold(sorted, n, k, q);
  __syncthreads();
  const float thr = thr_s;

  double v[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) v[j] = 0.0;
  int mine = 0;
  const int base = blockIdx.x * kRowsPerBlock + threadIdx.x;
#pragma unroll
  for (int rj = 0; rj < kRowsPerThread; ++rj) {
    const int i = base + rj * kThreads;
    if (i >= n) continue;
    const int t = idx[i];
    if (t < 0 || valid[i] == 0) continue;
    if (!(__fsqrt_rn(d2[i]) <= thr)) continue;
    const float px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
    const size_t o = 3 * static_cast<size_t>(t);
    const float qx = __ldg(tgt + o), qy = __ldg(tgt + o + 1), qz = __ldg(tgt + o + 2);
    const float nx = __ldg(nrm + o), ny = __ldg(nrm + o + 1), nz = __ldg(nrm + o + 2);
    const float r = __fadd_rn(__fadd_rn(__fmul_rn(nx, __fsub_rn(qx, px)),
                                        __fmul_rn(ny, __fsub_rn(qy, py))),
                              __fmul_rn(nz, __fsub_rn(qz, pz)));
    const float J[6] = {__fsub_rn(__fmul_rn(py, nz), __fmul_rn(pz, ny)),
                        __fsub_rn(__fmul_rn(pz, nx), __fmul_rn(px, nz)),
                        __fsub_rn(__fmul_rn(px, ny), __fmul_rn(py, nx)), nx, ny, nz};
    int h = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int bb = a; bb < 6; ++bb) v[h++] += static_cast<double>(J[a]) * J[bb];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) v[kH + a] += static_cast<double>(J[a]) * r;
    v[kH + 6] += fabs(static_cast<double>(r));
    ++mine;
  }
  block_sums(v, mine, red, red_c, sums, &count);
  if (threadIdx.x < kSums) {
    partials[static_cast<size_t>(blockIdx.x) * kSums + threadIdx.x] = sums[threadIdx.x];
    __threadfence();
  } else if (threadIdx.x == kSums) {
    inliers[blockIdx.x] = count;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // The last block: every partial is written. Add them in block order.
  __threadfence();
#pragma unroll
  for (int j = 0; j < kSums; ++j) v[j] = 0.0;
  mine = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) v[j] += __ldcg(partials + static_cast<size_t>(b) * kSums + j);
    mine += __ldcg(inliers + b);
  }
  block_sums(v, mine, red, red_c, sums, &count);
  if (threadIdx.x == 0) finish(sums, count, k, thr, T, T_out, err_out, stats);
}

}  // namespace

extern "C" {

// Bytes of scratch dc_icp_gate and dc_icp_solve take for n source rows.
long long dc_icp_scratch(int n) {
  return static_cast<long long>(layout(blocks_for(n)).total);
}

// X6's first launch: key (n,) float32 <- d2 where idx >= 0 and valid, +inf
// else, from d2 (n,) float32, idx (n,) int32 and valid (n,) bool; each
// block's count of ok rows into scratch, and the second launch's ticket
// zeroed. Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for bad arguments).
int dc_icp_gate(const void* d2, const void* idx, const void* valid, int n, void* key,
                void* scratch, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = blocks_for(n);
  const Layout l = layout(blocks);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  icp_gate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2), static_cast<const int*>(idx),
      static_cast<const unsigned char*>(valid), n, static_cast<float*>(key),
      reinterpret_cast<int*>(base + l.counts), reinterpret_cast<unsigned*>(base + l.ticket));
  return static_cast<int>(cudaGetLastError());
}

// X6's second launch, after dc_icp_gate on the same scratch and the sort of
// its keys into sorted (n,) float32: the inlier threshold at ratio q, the
// normal equations of the inliers from the placed source points src (n, 3),
// the target points tgt and normals nrm (m, 3) at idx, the solve, and
// T_out (4, 4) float32 <- the step's delta @ T, err_out () float32, and,
// unless stats is null, stats (40,) float64 (H, g, sum |r|, the inliers, k,
// thr, dx: what the tests compare). idx must lie in
// [0, m) where it is not negative; one past m is undefined input, which
// neither the kernel nor its launcher checks. Launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError().
int dc_icp_solve(const void* sorted, const void* d2, const void* idx, const void* valid,
                 const void* src, int n, const void* tgt, const void* nrm, float q,
                 const void* T, void* scratch, void* T_out, void* err_out, void* stats,
                 void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = blocks_for(n);
  const Layout l = layout(blocks);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  icp_solve_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sorted), reinterpret_cast<const int*>(base + l.counts), q,
      static_cast<const float*>(d2), static_cast<const int*>(idx),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(src), n,
      static_cast<const float*>(tgt), static_cast<const float*>(nrm),
      static_cast<const float*>(T), reinterpret_cast<double*>(base + l.partials),
      reinterpret_cast<int*>(base + l.inliers), reinterpret_cast<unsigned*>(base + l.ticket),
      static_cast<float*>(T_out), static_cast<float*>(err_out), static_cast<double*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
