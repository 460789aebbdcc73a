// Cell-window neighborhood moments: forward (K1) and backward (K2) kernels
// for Hopper (sm_90a), with a plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// K1 replaces the Pallas kernel depth_correction_tpu/ops/cellwin.py:
// _fwd_kernel; K2 replaces depth_correction_tpu/ops/cellwin.py:_bwd_kernel.
// Their plain torch versions are cellwin_fwd_plain / cellwin_bwd_plain in
// depth_correction_tpu_torch/ops/cellwin.py, which the card tests hold
// them to.
//
// What bounds them on this card: per tile the work is (tile rows) x
// (window entries) membership tests, ~10 float ops each plus 10 (K1) or 9
// (K2) accumulations for members, while the bytes read are only the
// window's 24 (K1) or 48 (K2) bytes per entry. So both kernels are bound
// by instruction issue, not by device memory. The design gives each row
// (K1) or point (K2) its own lane with its sums in registers; each warp
// reads its tile's window, buffers in shared memory, packed, the entries
// that survive a conservative test against the box of its real rows or
// points, and walks only those (csrc/cellwin_fwd.cuh states the design,
// why the test loses no member, and the numerics it keeps). There are no
// atomics: each output element is written by exactly one thread, so the
// result is deterministic, like the TPU kernels'.
// No kernel allocates memory; the Python wrapper allocates the outputs.

#include <cuda_runtime.h>

// K1's body is the kFull instance of the template in cellwin_fwd.cuh, which
// the knockout probe (cellwin_knockout.cu) shares; K2 shares its staging,
// distance and box test.
#include "cellwin_fwd.cuh"

namespace {

// K2: one warp per 32 points of a point tile (a tile of pt_cap points
// takes ceil(pt_cap / 32) warps), one lane per point; the warp reads its
// tile's window of rows as K1 reads its window. Accumulates
// the referencing rows' cotangent rows (S00, S11, S22, S01, S02, S12, u0,
// u1, u2) and writes grad = S x + u on the UNCENTRED current coordinates.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock) cellwin_bwd_kernel(
    const float* __restrict__ pts,    // (m_pad, 3) current positions
    const float* __restrict__ est,    // rows x, y, z of a (., m_pad) table
    int m_pad,
    const float* __restrict__ q_est,  // rows x, y, z of a (., mq_pad) table
    const float* __restrict__ table,  // (9, mq_pad) cotangent rows
    int mq_pad,
    const int* __restrict__ b_start,  // (t2, ns) span starts (row axis)
    const int* __restrict__ b_len,    // (t2, ns) span lengths
    const float* __restrict__ b_ctr,  // (t2, 3) tile centres
    int t2, int ns, int pt_cap, float r2,
    float* __restrict__ out) {        // (m_pad, 3)
  extern __shared__ float4 smem4[];
  const WarpTask task = warp_task(t2, pt_cap);
  if (task.t < 0) return;  // past the last tile: no barrier follows
  // The warp's shared memory: the kept rows (centred est x, y, z and S00;
  // S11, S22, S01, S02; S12, u0, u1, u2), then the span table.
  float4* s_a = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem4) +
      threadIdx.x / kWarp * warp_smem(kBwdBuf, 3 * sizeof(float4), ns));
  float4* s_b = s_a + kBwdBuf;
  float4* s_c = s_a + 2 * kBwdBuf;
  int* s_start = reinterpret_cast<int*>(s_a + 3 * kBwdBuf);
  int* s_pre = s_start + ns;

  const int lane = threadIdx.x % kWarp;
  const int t = task.t;
  const int slot = task.slot;
  const bool has_point = slot < pt_cap;  // the tile's last warp may be partial
  const int p = t * pt_cap + slot;
  const float cx = b_ctr[3 * t + 0];
  const float cy = b_ctr[3 * t + 1];
  const float cz = b_ctr[3 * t + 2];
  // A lane without a point sits at the padding sentinel: it has no member.
  const float e0 = has_point ? est[p] : kPointPad;
  const float ex = e0 - cx;
  const float ey = (has_point ? est[m_pad + p] : kPointPad) - cy;
  const float ez = (has_point ? est[2 * m_pad + p] : kPointPad) - cz;
  warp_spans(b_start + t * ns, b_len + t * ns, ns, s_start, s_pre);
  const float e[3] = {ex, ey, ez};
  const bool real = e0 != kPointPad;
  const WarpBox box = warp_box(e, real);

  float acc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = 0.f;
  // A warp with no real point reads nothing.
  const int total = __any_sync(kAll, real) ? s_pre[ns] : 0;
  const unsigned below = (1u << lane) - 1u;
  int s = 0;  // the span of the next round's first row
  for (int b = 0; b < total;) {
    // Fill the buffer while a round of 32 still fits, then walk it.
    int cnt = 0;
    for (; b < total && cnt <= kBwdBuf - kWarp; b += kWarp) {
      const int idx = b + lane;
      bool keep = false;
      float4 qa, qb, qc;
      int sl = s;
      if (idx < total) {
        sl = span_of(s_pre, s, idx);
        const int i = s_start[sl] + (idx - s_pre[sl]);
        qa.x = q_est[i] - cx;
        qa.y = q_est[mq_pad + i] - cy;
        qa.z = q_est[2 * mq_pad + i] - cz;
        keep = box_keeps(box, qa.x, qa.y, qa.z, r2);
        if (keep) {
          qa.w = table[i];
          qb = make_float4(table[mq_pad + i], table[2 * mq_pad + i], table[3 * mq_pad + i],
                           table[4 * mq_pad + i]);
          qc = make_float4(table[5 * mq_pad + i], table[6 * mq_pad + i],
                           table[7 * mq_pad + i], table[8 * mq_pad + i]);
        }
      }
      s = __shfl_sync(kAll, sl, kWarp - 1);
      const unsigned m = __ballot_sync(kAll, keep);
      if (keep) {
        const int pos = cnt + __popc(m & below);
        s_a[pos] = qa;
        s_b[pos] = qb;
        s_c[pos] = qc;
      }
      cnt += __popc(m);
    }
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {  // the buffered rows, ascending
      const float4 q = s_a[k];
      const float d2 = d2_form(__fsub_rn(q.x, ex), __fsub_rn(q.y, ey), __fsub_rn(q.z, ez));
      if (d2 <= r2) {
        const float4 tb = s_b[k];
        const float4 tc = s_c[k];
        acc[0] += q.w;
        acc[1] += tb.x;
        acc[2] += tb.y;
        acc[3] += tb.z;
        acc[4] += tb.w;
        acc[5] += tc.x;
        acc[6] += tc.y;
        acc[7] += tc.z;
        acc[8] += tc.w;
      }
    }
    __syncwarp();  // the buffer is read before the next fill
  }

  if (!has_point) return;
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
    const size_t smem = kWarpsPerBlock * warp_smem(kBwdBuf, 3 * sizeof(float4), ns);
    const cudaError_t err = allow_smem(cellwin_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cellwin_bwd_kernel<<<warp_blocks(t2, pt_cap), kWarp * kWarpsPerBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(est), m_pad,
        static_cast<const float*>(q_est), static_cast<const float*>(table),
        mq_pad, static_cast<const int*>(b_start),
        static_cast<const int*>(b_len), static_cast<const float*>(b_ctr), t2, ns,
        pt_cap, r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
