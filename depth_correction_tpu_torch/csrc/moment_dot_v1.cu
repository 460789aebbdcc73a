// The first Hopper version of P2's moment product, kept unchanged beside its
// redesign (csrc/moment_dot.cu) so that the two compare inside one call on one
// card; only its C entry is renamed (dc_moment_dot_v1). No path launches it:
// chip_smoke.py's A/B and the card tests do, through
// ops/_kernels.launch_moment_dot_v1.
//
// The moment product's precision probe (P2) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas probe scripts/exp_mosaic_dot_probe.py:main.kernel: on
// every one of T1 grid steps, sum over NS spans the product a_s @ b_s of a
// (16, S) float32 feature block and an (S, 128) right-hand side that is
// exactly {0, 1} (the membership matrix of the cell-window kernels). Its
// plain torch version is moment_dot_plain in
// depth_correction_tpu_torch/ops/moment_dot.py.
//
// Precision variants (tf32_mma.cuh) and the TPU variants they stand for:
//   fp32    float32 FMAs, no tensor cores          (TPU `highest`)
//   tf32    one TF32 pass of hi = trunc(a)          (TPU `default`, one bf16 pass)
//   tf32x2  hi + mid, two TF32 passes               (TPU `split2_cast` / `split2_bits`)
//   tf32x3  hi + mid + lo, three passes, f32-exact  (TPU `split3_bits`)
// b is truncated to TF32 as well (a no-op for {0, 1}), so every operand
// of an mma is exactly TF32 and the products are exact.
//
// What bounds it on this card: the work is T1 x 2 x 16 x (NS S) x 128
// FLOPs (6.7 GFLOP at the probe's shapes) against ~2 MB of inputs that
// stay in L2, so the bound is the math: 14 us a pass at the 495 TFLOP/s
// TF32 peak, 0.1 ms in float32 FMAs. The design: one block of 4 warps per
// grid step; each span's a_s is staged once in shared memory (rows padded
// by 4 floats, so the A-fragment reads of a warp hit 32 distinct banks);
// each warp owns 32 of the 128 columns (four n8 tiles) and runs
// mma.sync m16n8k8 over k, reading b's fragments from global memory (L2).
// The tensor core's f32 accumulation is not IEEE round-to-nearest, so the
// mma accumulators restart every 64 k and are added into float32 sums with
// ordinary adds; the hi pass and the small passes keep separate
// accumulators. No wgmma, no TMA: a simple kernel first.
//
// The TPU probe revisits one (16, 128) output block on every grid step;
// here blocks run in parallel, so block t writes its own columns
// [128 t, 128 t + 128) of a (16, 128 T1) output, and every slot is checked.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kCols = 128;  // R: the product's width, four warps of 32 columns
constexpr int kRows = 16;   // M: the feature rows
constexpr int kChunk = 64;  // k per restarted mma accumulator

template <int PREC>
__global__ void moment_dot_kernel(const float* __restrict__ a,  // (ns, 16, S)
                                  const float* __restrict__ b,  // (ns, S, 128)
                                  int ns, int s_len,
                                  float* __restrict__ out) {    // (16, 128 * gridDim.x)
  extern __shared__ float s_a[];  // (16, S + 4)
  const int sp = s_len + 4;
  const int tid = threadIdx.x;
  const int out_cols = kCols * gridDim.x;
  const int col0 = kCols * blockIdx.x;

  if constexpr (PREC == kFp32) {
    float acc[kRows];
#pragma unroll
    for (int f = 0; f < kRows; ++f) acc[f] = 0.f;
    for (int s = 0; s < ns; ++s) {
      __syncthreads();
      for (int i = tid; i < kRows * s_len; i += blockDim.x)
        s_a[(i / s_len) * sp + i % s_len] = a[static_cast<size_t>(s) * kRows * s_len + i];
      __syncthreads();
      const float* bs = b + static_cast<size_t>(s) * s_len * kCols;
      for (int k = 0; k < s_len; ++k) {
        const float bv = bs[k * kCols + tid];
#pragma unroll
        for (int f = 0; f < kRows; ++f) acc[f] = fmaf(s_a[f * sp + k], bv, acc[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kRows; ++f) out[f * out_cols + col0 + tid] = acc[f];
  } else {
    constexpr int N = PREC;  // TF32 passes: 1, 2 or 3
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int tq = tid & 3;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int s = 0; s < ns; ++s) {
      __syncthreads();
      for (int i = tid; i < kRows * s_len; i += blockDim.x)
        s_a[(i / s_len) * sp + i % s_len] = a[static_cast<size_t>(s) * kRows * s_len + i];
      __syncthreads();
      const float* bs = b + static_cast<size_t>(s) * s_len * kCols + warp * 32 + g;
      for (int kc = 0; kc < s_len; kc += kChunk) {
        float c_hi[4][4], c_lo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) c_hi[j][i] = c_lo[j][i] = 0.f;
        const int k_end = min(kc + kChunk, s_len);
        for (int k0 = kc; k0 < k_end; k0 += 8) {
          uint32_t a0[3], a1[3], a2[3], a3[3];
          tf32_split<N>(s_a[g * sp + k0 + tq], a0);
          tf32_split<N>(s_a[(g + 8) * sp + k0 + tq], a1);
          tf32_split<N>(s_a[g * sp + k0 + tq + 4], a2);
          tf32_split<N>(s_a[(g + 8) * sp + k0 + tq + 4], a3);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = __float_as_uint(tf32_trunc(bs[(k0 + tq) * kCols + 8 * j]));
            const uint32_t b1 = __float_as_uint(tf32_trunc(bs[(k0 + tq + 4) * kCols + 8 * j]));
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + warp * 32 + 8 * j + 2 * tq;
      out[g * out_cols + col] = acc[j][0];
      out[g * out_cols + col + 1] = acc[j][1];
      out[(g + 8) * out_cols + col] = acc[j][2];
      out[(g + 8) * out_cols + col + 1] = acc[j][3];
    }
  }
}

template <int PREC>
int launch(const float* a, const float* b, int ns, int s_len, int n_tiles, float* out,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRows) * (s_len + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moment_dot_kernel<PREC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moment_dot_kernel<PREC><<<n_tiles, kCols, smem, stream>>>(a, b, ns, s_len, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// prec: 0 fp32, 1 tf32, 2 tf32x2, 3 tf32x3; s_len a multiple of 8. Launches
// on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for bad arguments).
int dc_moment_dot_v1(int prec, const void* a, const void* b, int ns, int s_len, int n_tiles,
                  void* out, void* stream) {
  if (n_tiles <= 0 || ns <= 0 || s_len <= 0 || s_len % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (prec) {
    case kFp32: return launch<kFp32>(pa, pb, ns, s_len, n_tiles, po, st);
    case kTf32: return launch<kTf32>(pa, pb, ns, s_len, n_tiles, po, st);
    case kTf32x2: return launch<kTf32x2>(pa, pb, ns, s_len, n_tiles, po, st);
    case kTf32x3: return launch<kTf32x3>(pa, pb, ns, s_len, n_tiles, po, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
