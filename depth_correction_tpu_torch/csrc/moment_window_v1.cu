// The first version of the moment product with in-kernel operands (P3, P4,
// P5) for Hopper (sm_90a), kept for the A/B against the redesign in
// csrc/moment_window.cu; reached only through
// ops/moment_window.moment_window_v1 (CUDA tensors only), which no path
// calls. Plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas probes scripts/exp_mosaic_dot_probe2.py:main.kernel
// (P3), the five calls of scripts/exp_mosaic_dot_probe3.py:133-219 (P4,
// A-E) and scripts/exp_mosaic_dot_probe4.py:make_variant (P5, E-J). Each
// builds, per span of a tile, the cell-window forward kernel's operands
// from an (8, S) window (rows: current x, y, z, establishment x, y, z):
// features (16, S) = [1, x, y, z, xx, yy, zz, xy, xz, yz, 0 x 6] and the
// membership wm (S, 128) = [d2(est_k, q_n) <= r2] inside the span's
// columns, and accumulates feats @ wm over NS spans. Its plain torch
// version is moment_window_plain in ops/moment_window.py.
//
// Precision variants as in csrc/moment_dot.cu (fp32, tf32, tf32x2,
// tf32x3; the TPU probes' highest, default, split2_bits, split3_bits).
// P3's fifth variant, wm_bits_split3 (one pass of hi + mid + lo), is the
// one-pass `tf32`: hi + mid + lo recombines to the features exactly.
// Compile-time switches (FLAGS), each a structural piece of K1 that the TPU
// probes added one at a time:
//   kLenTable   span lengths from a (T1, NS) device table (P4-B; the TPU's
//               scalar-prefetch table) instead of one value for all spans
//   kStaged     spans read from a big (8, ncols) table at per-span starts
//               (P4-C; the TPU's ANY-space table and span DMAs)
//   kEpilogue   the division epilogue (P4-D, exp_mosaic_dot_probe3.py:86-98)
//   kPerTileQ   per-tile q columns (P5-F; the TPU's moving blocks)
//   kShift      tile-centre shifts of q and of the window (P5-G)
//   kLead       two-sided lead masks, lead <= col < lead + len (P5-H)
// NS is a runtime value (5, or 15 for P5-I and J). Only the combinations the
// probes run are instantiated (dc_moment_window_v1 lists them).
//
// What bounds it on this card: per tile and span, 128 x S membership tests
// of ~8 float32 operations (in FMA-free form) and a 16 x S x 128 product
// of 1-3 TF32 passes; the inputs are a few MB in L2. So the instructions
// of the d2 arithmetic bound it, not the tensor cores. The design: one block of 4
// warps per tile; each span's features and shifted establishment
// coordinates are staged once in shared memory (out-of-span columns as
// zero features and an infinite coordinate, so they are never members);
// each warp owns 32 of the 128 query columns and builds its mma B fragments
// (the {0, 1} membership) in registers from the staged coordinates, so wm
// never exists in memory; the A fragments are the staged features, split
// into TF32 components on the fly (tf32_mma.cuh). Accumulators restart
// every 64 k as in moment_dot.cu. Every read of the big table is bounded by
// the span's columns, clamped to the table's (a span column outside the
// table is not a member), so the launcher checks no starts on the host.
//
// Numerics: d2 = (dx dx + dy dy) + dz dz with no fused multiply-add
// (__fmul_rn / __fadd_rn), so membership is the plain version's float32
// membership exactly. The TPU probes revisit one output block; here block
// t writes its own columns [128 t, 128 t + 128) of a (16, 128 T1) output.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kCols = 128;
constexpr int kFeats = 10;  // the non-zero feature rows
constexpr int kChunk = 64;

enum WindowFlags {
  kLenTable = 1,
  kStaged = 2,
  kEpilogue = 4,
  kPerTileQ = 8,
  kShift = 16,
  kLead = 32,
};

__device__ __forceinline__ float d2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <int PREC, int FLAGS>
__global__ void moment_window_kernel(
    const float* __restrict__ win,   // kStaged: (8, ncols); else (ns, 8, S)
    int ncols,
    const float* __restrict__ q,     // (8, q_cols): 128 columns, or 128 T1 with kPerTileQ
    int q_cols,
    const int* __restrict__ starts,  // (T1, ns), kStaged
    const int* __restrict__ leads,   // (T1, ns), kLead
    const int* __restrict__ lens,    // (T1, ns), kLenTable
    int len_const,                   // every span's length without kLenTable
    const float* __restrict__ ctr,   // (T1, 3), kShift
    int ns, int s_len, float r2,
    float* __restrict__ out) {       // (16, 128 T1)
  extern __shared__ float smem[];
  const int sp = s_len + 4;  // feature row stride: conflict-free A fragments
  float* s_f = smem;                  // (10, sp) features of the staged span
  float* s_e = s_f + kFeats * sp;     // (3, S) shifted establishment coords
  float* s_q = s_e + 3 * s_len;       // (3, 128) shifted query coords
  float* s_o = s_q + 3 * kCols;       // (16, 128) the tile's sums
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int out_cols = kCols * gridDim.x;
  const float inf = __int_as_float(0x7f800000);

  float cx = 0.f, cy = 0.f, cz = 0.f;
  if constexpr ((FLAGS & kShift) != 0) {
    cx = ctr[3 * t + 0];
    cy = ctr[3 * t + 1];
    cz = ctr[3 * t + 2];
  }
  {
    const int qc = ((FLAGS & kPerTileQ) != 0 ? t * kCols : 0) + tid;
    s_q[tid] = q[qc] - cx;
    s_q[kCols + tid] = q[q_cols + qc] - cy;
    s_q[2 * kCols + tid] = q[2 * q_cols + qc] - cz;
  }

  // The sums: thread-per-column float32 (fp32) or mma accumulators.
  float acc[4][4];
  float facc[kFeats];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int f = 0; f < kFeats; ++f) facc[f] = 0.f;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int tq = tid & 3;
  float qr[4][3];  // the query coordinates of this lane's B-fragment columns
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) qr[j][c] = s_q[c * kCols + warp * 32 + 8 * j + g];

  for (int s = 0; s < ns; ++s) {
    const int ln = (FLAGS & kLenTable) != 0 ? lens[t * ns + s] : len_const;
    int lo = (FLAGS & kLead) != 0 ? leads[t * ns + s] : 0;
    int hi = min(lo + ln, s_len);
    const float* src;
    int off = 0;  // the window's first column in its source
    int rs;       // row stride of the window's source
    if constexpr ((FLAGS & kStaged) != 0) {
      // Columns outside the table are outside the span, so every read
      // stays in the table whatever the starts.
      off = starts[t * ns + s];
      lo = max(lo, -off);
      hi = min(hi, ncols - off);
      src = win;
      rs = ncols;
    } else {
      src = win + static_cast<size_t>(s) * 8 * s_len;
      rs = s_len;
    }
    __syncthreads();  // the previous span has been read by every thread
    for (int c = tid; c < s_len; c += kCols) {
      if (c >= lo && c < hi) {
        const int k = off + c;
        const float x0 = src[k] - cx;
        const float x1 = src[rs + k] - cy;
        const float x2 = src[2 * rs + k] - cz;
        s_e[c] = src[3 * rs + k] - cx;
        s_e[s_len + c] = src[4 * rs + k] - cy;
        s_e[2 * s_len + c] = src[5 * rs + k] - cz;
        s_f[0 * sp + c] = 1.f;
        s_f[1 * sp + c] = x0;
        s_f[2 * sp + c] = x1;
        s_f[3 * sp + c] = x2;
        s_f[4 * sp + c] = __fmul_rn(x0, x0);
        s_f[5 * sp + c] = __fmul_rn(x1, x1);
        s_f[6 * sp + c] = __fmul_rn(x2, x2);
        s_f[7 * sp + c] = __fmul_rn(x0, x1);
        s_f[8 * sp + c] = __fmul_rn(x0, x2);
        s_f[9 * sp + c] = __fmul_rn(x1, x2);
      } else {
        s_e[c] = inf;  // d2 = inf: never a member
        s_e[s_len + c] = inf;
        s_e[2 * s_len + c] = inf;
#pragma unroll
        for (int f = 0; f < kFeats; ++f) s_f[f * sp + c] = 0.f;
      }
    }
    __syncthreads();

    if constexpr (PREC == kFp32) {
      const float qx = s_q[tid], qy = s_q[kCols + tid], qz = s_q[2 * kCols + tid];
      for (int k = 0; k < s_len; ++k) {
        const float w = d2_rn(s_e[k] - qx, s_e[s_len + k] - qy, s_e[2 * s_len + k] - qz) <= r2
                            ? 1.f : 0.f;
#pragma unroll
        for (int f = 0; f < kFeats; ++f) facc[f] = fmaf(s_f[f * sp + k], w, facc[f]);
      }
    } else {
      constexpr int N = PREC;
      const uint32_t one = __float_as_uint(1.f);
      for (int kc = 0; kc < s_len; kc += kChunk) {
        float c_hi[4][4], c_lo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) c_hi[j][i] = c_lo[j][i] = 0.f;
        const int k_end = min(kc + kChunk, s_len);
        for (int k0 = kc; k0 < k_end; k0 += 8) {
          const int ka = k0 + tq, kb = k0 + tq + 4;
          uint32_t a0[3], a1[3] = {0u, 0u, 0u}, a2[3], a3[3] = {0u, 0u, 0u};
          tf32_split<N>(s_f[g * sp + ka], a0);
          tf32_split<N>(s_f[g * sp + kb], a2);
          if (g + 8 < kFeats) {  // rows 8, 9; rows 10..15 are zero
            tf32_split<N>(s_f[(g + 8) * sp + ka], a1);
            tf32_split<N>(s_f[(g + 8) * sp + kb], a3);
          }
          const float eax = s_e[ka], eay = s_e[s_len + ka], eaz = s_e[2 * s_len + ka];
          const float ebx = s_e[kb], eby = s_e[s_len + kb], ebz = s_e[2 * s_len + kb];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 =
                d2_rn(eax - qr[j][0], eay - qr[j][1], eaz - qr[j][2]) <= r2 ? one : 0u;
            const uint32_t b1 =
                d2_rn(ebx - qr[j][0], eby - qr[j][1], ebz - qr[j][2]) <= r2 ? one : 0u;
            mma_tf32_m16n8k8(c_hi[j], a0[0], a1[0], a2[0], a3[0], b0, b1);
            if constexpr (N >= 2) mma_tf32_m16n8k8(c_lo[j], a0[1], a1[1], a2[1], a3[1], b0, b1);
            if constexpr (N >= 3) mma_tf32_m16n8k8(c_lo[j], a0[2], a1[2], a2[2], a3[2], b0, b1);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += c_lo[j][i] + c_hi[j][i];
      }
    }
  }

  // The tile's (16, 128) sums into shared memory, then one column a thread.
  if constexpr (PREC == kFp32) {
#pragma unroll
    for (int f = 0; f < 16; ++f) s_o[f * kCols + tid] = f < kFeats ? facc[f] : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = warp * 32 + 8 * j + 2 * tq;
      s_o[g * kCols + col] = acc[j][0];
      s_o[g * kCols + col + 1] = acc[j][1];
      s_o[(g + 8) * kCols + col] = acc[j][2];
      s_o[(g + 8) * kCols + col + 1] = acc[j][3];
    }
  }
  __syncthreads();
  float v[16];
#pragma unroll
  for (int f = 0; f < 16; ++f) v[f] = s_o[f * kCols + tid];
  if constexpr ((FLAGS & kEpilogue) != 0) {
    // exp_mosaic_dot_probe3.py:86-98 (shared by exp_mosaic_dot_probe4.py),
    // with no fused multiply-add: on a one-member column den = 1e-6 scales
    // v[4] - s0 m0 m0 by 1e6, and only the plain version's rounding of
    // s0 m0 m0 makes that difference the same (zero).
    const float s0 = fmaxf(v[0], 1e-12f);
    const float m0 = v[1] / s0;
    const float m1 = v[2] / s0;
    const float m2 = v[3] / s0;
    const float den = fmaxf(v[0] - 1.f, 1e-6f);
    const float c00 = __fsub_rn(v[4], __fmul_rn(__fmul_rn(s0, m0), m0)) / den;
    const float c11 = __fsub_rn(v[5], __fmul_rn(__fmul_rn(s0, m1), m1)) / den;
    const float c22 = __fsub_rn(v[6], __fmul_rn(__fmul_rn(s0, m2), m2)) / den;
    v[0] = m0; v[1] = m1; v[2] = m2;
    v[3] = c00; v[4] = c11; v[5] = c22;
    v[6] = v[7]; v[7] = v[8]; v[8] = v[9];
    v[9] = s0;
#pragma unroll
    for (int f = 10; f < 16; ++f) v[f] = 0.f;
  }
#pragma unroll
  for (int f = 0; f < 16; ++f) out[f * out_cols + t * kCols + tid] = v[f];
}

template <int PREC, int FLAGS>
int launch(const float* win, int ncols, const float* q, int q_cols, const int* starts,
           const int* leads, const int* lens, int len_const, const float* ctr, int ns,
           int s_len, float r2, int n_tiles, float* out, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kFeats) * (s_len + 4) + 3 * s_len + 3 * kCols + 16 * kCols) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moment_window_kernel<PREC, FLAGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moment_window_kernel<PREC, FLAGS><<<n_tiles, kCols, smem, stream>>>(
      win, ncols, q, q_cols, starts, leads, lens, len_const, ctr, ns, s_len, r2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// prec: 0 fp32, 1 tf32, 2 tf32x2, 3 tf32x3; flags: the WindowFlags bits.
// Instantiated: every precision without flags (P3, P4-A); tf32x3 with the
// flag sets of P4-B..E and P5-F..J. Anything else returns
// cudaErrorInvalidValue. Launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().
int dc_moment_window_v1(int prec, int flags, const void* win, int ncols, const void* q,
                     int q_cols, const void* starts, const void* leads, const void* lens,
                     int len_const, const void* ctr, int ns, int s_len, float r2,
                     int n_tiles, void* out, void* stream) {
  if (n_tiles <= 0 || ns <= 0 || s_len <= 0 || s_len % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w = static_cast<const float*>(win);
  const float* pq = static_cast<const float*>(q);
  const int* st = static_cast<const int*>(starts);
  const int* ld = static_cast<const int*>(leads);
  const int* ln = static_cast<const int*>(lens);
  const float* pc = static_cast<const float*>(ctr);
  float* po = static_cast<float*>(out);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
#define DC_WINDOW_CASE(P, F)                                                                  \
  if (prec == (P) && flags == (F))                                                            \
    return launch<(P), (F)>(w, ncols, pq, q_cols, st, ld, ln, len_const, pc, ns, s_len, r2, \
                            n_tiles, po, sm);
  constexpr int kE = kLenTable | kStaged | kEpilogue;  // P4-E, P5-E
  DC_WINDOW_CASE(kFp32, 0)
  DC_WINDOW_CASE(kTf32, 0)
  DC_WINDOW_CASE(kTf32x2, 0)
  DC_WINDOW_CASE(kTf32x3, 0)
  DC_WINDOW_CASE(kTf32x3, kLenTable)
  DC_WINDOW_CASE(kTf32x3, kLenTable | kStaged)
  DC_WINDOW_CASE(kTf32x3, kEpilogue)
  DC_WINDOW_CASE(kTf32x3, kE)
  DC_WINDOW_CASE(kTf32x3, kE | kPerTileQ)
  DC_WINDOW_CASE(kTf32x3, kE | kShift)
  DC_WINDOW_CASE(kTf32x3, kE | kLead)
  DC_WINDOW_CASE(kTf32x3, kE | kPerTileQ | kShift | kLead)
#undef DC_WINDOW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
