// Cell-window neighborhood moments: forward (K1) and backward (K2) kernels
// for Hopper (sm_90a), with a plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// K1 replaces the Pallas kernel depth_correction_tpu/ops/cellwin.py:
// _fwd_kernel; K2 replaces depth_correction_tpu/ops/cellwin.py:_bwd_kernel.
// Their plain torch versions are cellwin_fwd_plain / cellwin_bwd_plain in
// depth_correction_tpu_torch/ops/cellwin.py.
//
// What bounds them on this card: per tile the work is (tile rows) x (window
// entries) membership tests, ~10 float ops each plus 10 (K1) or 9 (K2)
// accumulations for members, while the bytes read are only the window's
// 24 (K1) or 48 (K2) bytes per entry. So both kernels are bound by
// instruction issue and shared-memory reads, not by device memory. The
// design therefore gives each row (K1) or point (K2) its own thread with
// its sums in registers, stages each span of the window once per block in
// shared memory, and lets all threads of the block read the same staged
// entry at once (a broadcast: no bank conflicts). There are no atomics: each
// output element is written by exactly one thread, so the result is
// deterministic, like the TPU kernels'.
//
// Numerics (kept from the TPU kernels):
// - Membership is tested in the difference form d = (x_est - ctr) -
//   (q_est - ctr) on tile-centred coordinates. The host builder's exactness
//   audit (build_cellwin_graph, eps_rel 2e-5 of r^2) covers the rounding of
//   this form, FMA contraction included; it does not cover the expansion
//   |q|^2 + |x|^2 - 2 q.x, which must not be used here.
// - Non-members are SELECTED out (a branch), never multiplied by a zero
//   weight: padding entries carry far sentinels (+-1e15) and 0 * inf = NaN.
// - Every read is bounded by the span's length: starts are raw (no 128-lane
//   alignment), so no window over-read and no sentinel columns are needed.
// No kernel allocates memory; the Python wrapper allocates the outputs.

#include <cuda_runtime.h>

// K1's body is the kFull instance of the template in cellwin_fwd.cuh, which
// the knockout probe (cellwin_knockout.cu) shares.
#include "cellwin_fwd.cuh"

namespace {

// K2: one block per point tile, one thread per point. Accumulates the
// referencing rows' cotangent rows (S00, S11, S22, S01, S02, S12, u0, u1,
// u2) and writes grad = S x + u on the UNCENTRED current coordinates.
__global__ void cellwin_bwd_kernel(
    const float* __restrict__ pts,    // (m_pad, 3) current positions
    const float* __restrict__ est,    // rows x, y, z of a (., m_pad) table
    int m_pad,
    const float* __restrict__ q_est,  // rows x, y, z of a (., mq_pad) table
    const float* __restrict__ table,  // (9, mq_pad) cotangent rows
    int mq_pad,
    const int* __restrict__ b_start,  // (t2, ns) span starts (row axis)
    const int* __restrict__ b_len,    // (t2, ns) span lengths
    const float* __restrict__ b_ctr,  // (t2, 3) tile centres
    int ns, float r2,
    float* __restrict__ out) {        // (m_pad, 3)
  extern __shared__ float smem[];
  const int cap = blockDim.x;
  float* s_qx = smem;            // centred row est x of the staged rows
  float* s_qy = smem + cap;
  float* s_qz = smem + 2 * cap;
  float* s_tab = smem + 3 * cap;  // 9 rows of cap cotangents

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int p = t * cap + tid;
  const float cx = b_ctr[3 * t + 0];
  const float cy = b_ctr[3 * t + 1];
  const float cz = b_ctr[3 * t + 2];
  const float ex = est[p] - cx;
  const float ey = est[m_pad + p] - cy;
  const float ez = est[2 * m_pad + p] - cz;

  float acc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = 0.f;
  for (int s = 0; s < ns; ++s) {
    const int start = b_start[t * ns + s];
    const int len = b_len[t * ns + s];
    for (int off = 0; off < len; off += cap) {
      const int n = min(cap, len - off);
      __syncthreads();
      if (tid < n) {
        const int i = start + off + tid;
        s_qx[tid] = q_est[i] - cx;
        s_qy[tid] = q_est[mq_pad + i] - cy;
        s_qz[tid] = q_est[2 * mq_pad + i] - cz;
#pragma unroll
        for (int c = 0; c < 9; ++c) s_tab[c * cap + tid] = table[c * mq_pad + i];
      }
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const float dx = s_qx[k] - ex;
        const float dy = s_qy[k] - ey;
        const float dz = s_qz[k] - ez;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 <= r2) {
#pragma unroll
          for (int c = 0; c < 9; ++c) acc[c] += s_tab[c * cap + k];
        }
      }
    }
  }
  const float x0 = pts[3 * p + 0];
  const float x1 = pts[3 * p + 1];
  const float x2 = pts[3 * p + 2];
  out[3 * p + 0] = acc[0] * x0 + acc[3] * x1 + acc[4] * x2 + acc[6];
  out[3 * p + 1] = acc[3] * x0 + acc[1] * x1 + acc[5] * x2 + acc[7];
  out[3 * p + 2] = acc[4] * x0 + acc[5] * x1 + acc[2] * x2 + acc[8];
}

}  // namespace

extern "C" {

// Each entry launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() (0 = the launch was accepted).

int dc_cellwin_fwd(const void* pts, const void* est, int m_pad,
                   const void* q_est, int mq_pad, const void* f_start,
                   const void* f_len, const void* f_ctr, int t1, int ns,
                   int row_cap, float r2, void* out, void* stream) {
  return launch_cellwin_fwd_mode<kFull>(pts, est, m_pad, q_est, mq_pad, f_start, f_len,
                                        f_ctr, t1, ns, row_cap, r2, out, stream);
}

int dc_cellwin_bwd(const void* pts, const void* est, int m_pad,
                   const void* q_est, const void* table, int mq_pad,
                   const void* b_start, const void* b_len, const void* b_ctr,
                   int t2, int ns, int pt_cap, float r2, void* out,
                   void* stream) {
  if (t2 > 0) {
    const size_t smem = 12 * static_cast<size_t>(pt_cap) * sizeof(float);
    cellwin_bwd_kernel<<<t2, pt_cap, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(est), m_pad,
        static_cast<const float*>(q_est), static_cast<const float*>(table),
        mq_pad, static_cast<const int*>(b_start),
        static_cast<const int*>(b_len), static_cast<const float*>(b_ctr), ns,
        r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
