// The first Hopper versions of the cell-window kernels K1 and K2, kept
// unchanged beside their redesign (csrc/cellwin.cu, csrc/cellwin_fwd.cuh)
// so that the two compare inside one call on one card. No path of the
// package launches them: chip_smoke.py's A/B and the card tests do, through
// ops/cellwin.cellwin_fwd_v1 / cellwin_bwd_v1. Plain C interface, loaded
// through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// They replace the same Pallas kernels as the redesign
// (depth_correction_tpu/ops/cellwin.py:_fwd_kernel and :_bwd_kernel) and
// compute the same function; their plain torch versions are
// cellwin_fwd_plain / cellwin_bwd_plain in ops/cellwin.py.
//
// Design: one thread per row (K1) or point (K2) with its sums in
// registers; each span of the window staged once per block in shared
// memory, in chunks of blockDim entries, and read by all threads as a
// broadcast; every thread tests every staged entry. Membership in the
// difference form on tile-centred coordinates, non-members selected out by
// a branch, every read bounded by the raw span length, no atomics. What
// bounds them on this card: instruction issue, about 30 issued
// warp-instructions per (warp, staged entry) step (PERF.md, the knockout P1).

#include <cuda_runtime.h>

namespace {

__global__ void cellwin_fwd_v1_kernel(
    const float* __restrict__ pts,    // (m_pad, 3) current positions
    const float* __restrict__ est,    // rows x, y, z of a (., m_pad) table
    int m_pad,
    const float* __restrict__ q_est,  // rows x, y, z of a (., mq_pad) table
    int mq_pad,
    const int* __restrict__ f_start,  // (t1, ns) span starts (point axis)
    const int* __restrict__ f_len,    // (t1, ns) span lengths
    const float* __restrict__ f_ctr,  // (t1, 3) tile centres
    int ns, float r2,
    float* __restrict__ out) {        // (10, mq_pad)
  extern __shared__ float smem[];
  const int cap = blockDim.x;
  float* s_ex = smem;            // tile-centred est x of the staged entries
  float* s_ey = smem + cap;
  float* s_ez = smem + 2 * cap;
  float* s_x0 = smem + 3 * cap;  // tile-centred current x
  float* s_x1 = smem + 4 * cap;
  float* s_x2 = smem + 5 * cap;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = t * cap + tid;
  const float cx = f_ctr[3 * t + 0];
  const float cy = f_ctr[3 * t + 1];
  const float cz = f_ctr[3 * t + 2];
  const float qx = q_est[row] - cx;
  const float qy = q_est[mq_pad + row] - cy;
  const float qz = q_est[2 * mq_pad + row] - cz;

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
  float a5 = 0.f, a6 = 0.f, a7 = 0.f, a8 = 0.f, a9 = 0.f;
  for (int s = 0; s < ns; ++s) {
    const int start = f_start[t * ns + s];
    const int len = f_len[t * ns + s];
    for (int off = 0; off < len; off += cap) {
      const int n = min(cap, len - off);
      __syncthreads();  // the previous chunk has been read by every thread
      if (tid < n) {
        const int j = start + off + tid;
        s_ex[tid] = est[j] - cx;
        s_ey[tid] = est[m_pad + j] - cy;
        s_ez[tid] = est[2 * m_pad + j] - cz;
        s_x0[tid] = pts[3 * j + 0] - cx;
        s_x1[tid] = pts[3 * j + 1] - cy;
        s_x2[tid] = pts[3 * j + 2] - cz;
      }
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const float dx = s_ex[k] - qx;
        const float dy = s_ey[k] - qy;
        const float dz = s_ez[k] - qz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 <= r2) {
          // Row-centred current coordinates: every member lies within r
          // of the row, so |x| <= ~r and the f32 sums of squares stay
          // small.
          const float x0 = s_x0[k] - qx;
          const float x1 = s_x1[k] - qy;
          const float x2 = s_x2[k] - qz;
          a0 += 1.f;
          a1 += x0;
          a2 += x1;
          a3 += x2;
          a4 += x0 * x0;
          a5 += x1 * x1;
          a6 += x2 * x2;
          a7 += x0 * x1;
          a8 += x0 * x2;
          a9 += x1 * x2;
        }
      }
    }
  }
  const float s0c = fmaxf(a0, 1e-12f);
  const float m0 = a1 / s0c;
  const float m1 = a2 / s0c;
  const float m2 = a3 / s0c;
  const float denom = fmaxf(a0 - 1.f, 1e-6f);
  out[0 * mq_pad + row] = (m0 + qx) + cx;
  out[1 * mq_pad + row] = (m1 + qy) + cy;
  out[2 * mq_pad + row] = (m2 + qz) + cz;
  out[3 * mq_pad + row] = (a4 - a0 * m0 * m0) / denom;
  out[4 * mq_pad + row] = (a5 - a0 * m1 * m1) / denom;
  out[5 * mq_pad + row] = (a6 - a0 * m2 * m2) / denom;
  out[6 * mq_pad + row] = (a7 - a0 * m0 * m1) / denom;
  out[7 * mq_pad + row] = (a8 - a0 * m0 * m2) / denom;
  out[8 * mq_pad + row] = (a9 - a0 * m1 * m2) / denom;
  out[9 * mq_pad + row] = s0c;
}

__global__ void cellwin_bwd_v1_kernel(
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

int dc_cellwin_fwd_v1(const void* pts, const void* est, int m_pad, const void* q_est,
                      int mq_pad, const void* f_start, const void* f_len, const void* f_ctr,
                      int t1, int ns, int row_cap, float r2, void* out, void* stream) {
  if (t1 > 0) {
    const size_t smem = 6 * static_cast<size_t>(row_cap) * sizeof(float);
    cellwin_fwd_v1_kernel<<<t1, row_cap, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(est), m_pad,
        static_cast<const float*>(q_est), mq_pad, static_cast<const int*>(f_start),
        static_cast<const int*>(f_len), static_cast<const float*>(f_ctr), ns, r2,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

int dc_cellwin_bwd_v1(const void* pts, const void* est, int m_pad, const void* q_est,
                      const void* table, int mq_pad, const void* b_start, const void* b_len,
                      const void* b_ctr, int t2, int ns, int pt_cap, float r2, void* out,
                      void* stream) {
  if (t2 > 0) {
    const size_t smem = 12 * static_cast<size_t>(pt_cap) * sizeof(float);
    cellwin_bwd_v1_kernel<<<t2, pt_cap, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(est), m_pad,
        static_cast<const float*>(q_est), static_cast<const float*>(table), mq_pad,
        static_cast<const int*>(b_start), static_cast<const int*>(b_len),
        static_cast<const float*>(b_ctr), ns, r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
