// The cell-window forward body (K1), as a template over compile-time
// knockouts. csrc/cellwin.cu instantiates kFull as K1; csrc/cellwin_knockout.cu
// instantiates every mode for the knockout probe (P1). kFull is K1's code
// itself, so P1's `full` is bit-equal to K1 on the same inputs.
//
// The modes, each the Hopper meaning of a knockout of
// scripts/exp_cellwin_knockout.py (the TPU probe's docstring :9-16):
//   kFull     K1: membership test, row-centred moment sums, the epilogue.
//   kNoD2     no membership test: every staged entry of a span is a member.
//   kNoFeats  constant features: every sum is the member count.
//   kNoDot    the member count alone, without the nine multiply-adds.
//   kNoMask   no per-slot select: the ten sums take a {0, 1} weight times
//             each term, so the d2 test against the +-1e15 padding alone
//             keeps padding out (the weight is 0 there, the terms finite).
//   kEmpty    stage every span into shared memory and write q, nothing
//             else: the floor set by the grid, the staging and the loads.
// Every mode but kFull writes the raw sums a0..a9 (kEmpty: q_est's x, y, z
// and zeros) and skips the epilogue: ten divisions per row, once.
// The TPU probe's dot1, kcat1 and kcat3 are arrangements of the matrix
// unit's dot; K1 on this card has no dot, so their question is asked of
// the tensor-core moment product instead (csrc/moment_dot.cu,
// csrc/moment_window.cu).

#pragma once
#include <cuda_runtime.h>

namespace {

enum CellwinMode { kFull = 0, kNoD2 = 1, kNoFeats = 2, kNoDot = 3, kNoMask = 4, kEmpty = 5 };

// One block per row tile, one thread per query row.
// out rows (kFull): mean x, y, z (shifted back), cov 00, 11, 22, 01, 02, 12,
// and w_sum = max(s0, 1e-12) — the epilogue of the TPU kernel. Unlike the
// TPU kernel, the sums are taken about each row's own establishment
// position instead of the tile centre: a tile's z-run can span metres,
// and sums of squares of metre-scale coordinates lose ~1e-5 m^2 of a
// two-neighbour covariance in f32, where row-centred ones stay below 1e-7.
template <int MODE>
__global__ void cellwin_fwd_kernel(
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
      if constexpr (MODE == kEmpty) {
        asm volatile("" ::: "memory");  // the staged stores stay
        continue;
      }
      for (int k = 0; k < n; ++k) {
        if constexpr (MODE == kNoD2) {
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
          continue;
        }
        const float dx = s_ex[k] - qx;
        const float dy = s_ey[k] - qy;
        const float dz = s_ez[k] - qz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if constexpr (MODE == kNoMask) {
          const float w = d2 <= r2 ? 1.f : 0.f;
          const float x0 = s_x0[k] - qx;
          const float x1 = s_x1[k] - qy;
          const float x2 = s_x2[k] - qz;
          const float w0 = w * x0;
          const float w1 = w * x1;
          const float w2 = w * x2;
          a0 += w;
          a1 += w0;
          a2 += w1;
          a3 += w2;
          a4 += w0 * x0;
          a5 += w1 * x1;
          a6 += w2 * x2;
          a7 += w0 * x1;
          a8 += w0 * x2;
          a9 += w1 * x2;
        } else if (d2 <= r2) {
          if constexpr (MODE == kNoFeats) {
            a0 += 1.f; a1 += 1.f; a2 += 1.f; a3 += 1.f; a4 += 1.f;
            a5 += 1.f; a6 += 1.f; a7 += 1.f; a8 += 1.f; a9 += 1.f;
          } else if constexpr (MODE == kNoDot) {
            a0 += 1.f;
          } else {
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
  }
  if constexpr (MODE == kFull) {
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
  } else if constexpr (MODE == kEmpty) {
    out[0 * mq_pad + row] = q_est[row];
    out[1 * mq_pad + row] = q_est[mq_pad + row];
    out[2 * mq_pad + row] = q_est[2 * mq_pad + row];
    for (int c = 3; c < 10; ++c) out[c * mq_pad + row] = 0.f;
  } else {
    out[0 * mq_pad + row] = a0;
    out[1 * mq_pad + row] = a1;
    out[2 * mq_pad + row] = a2;
    out[3 * mq_pad + row] = a3;
    out[4 * mq_pad + row] = a4;
    out[5 * mq_pad + row] = a5;
    out[6 * mq_pad + row] = a6;
    out[7 * mq_pad + row] = a7;
    out[8 * mq_pad + row] = a8;
    out[9 * mq_pad + row] = a9;
  }
}

// Launches mode MODE on the caller's stream; returns cudaGetLastError().
template <int MODE>
int launch_cellwin_fwd_mode(const void* pts, const void* est, int m_pad,
                            const void* q_est, int mq_pad, const void* f_start,
                            const void* f_len, const void* f_ctr, int t1, int ns,
                            int row_cap, float r2, void* out, void* stream) {
  if (t1 > 0) {
    const size_t smem = 6 * static_cast<size_t>(row_cap) * sizeof(float);
    cellwin_fwd_kernel<MODE><<<t1, row_cap, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(est), m_pad,
        static_cast<const float*>(q_est), mq_pad,
        static_cast<const int*>(f_start), static_cast<const int*>(f_len),
        static_cast<const float*>(f_ctr), ns, r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
