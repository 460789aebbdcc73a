// The layout probes (P6) for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replace the Pallas probes scripts/exp_mosaic_probe.py:k_* (:37-78, each
// one pallas_call at :23): seven tiny kernels that asked which vector
// layouts Mosaic lowers on a TPU. On Hopper each becomes the CUDA kernel
// writing what its Pallas body writes, from the script's input x (8, 512)
// float32, and the question becomes what each layout move costs here:
//
//   0 reshape_f32           out (512, 128): out[s, r] = x[0, s]; the block's
//                           rows of x[0] staged in shared memory and read
//                           back as a column
//   1 iota_col              out (512, 128): out[s, r] = s < x[0, 0]; the mask
//                           computed once per row (a column iota) and broadcast
//   2 iota_col_full         the same mask from a full (512, 128) iota, one
//                           comparison per element
//   3 bool_reshape          the same mask built as a row of bytes in shared
//                           memory and read back as a column
//   4 dot_tlhs              out (512, 128) = x^T ones(8, 128): mma.sync TF32
//                           m16n8k8 with A = x^T read transposed from global
//                           memory, in the three-pass split of tf32_mma.cuh,
//                           so the integer sums are exact
//   5 transpose_f32         out (512, 8) = x^T
//   6 broadcast_row_to_col  out (512, 128): out[s, r] = x[0, s]; the row
//                           broadcast to a (128, rows) tile in shared memory
//                           and written transposed
//
// The plain torch versions are in depth_correction_tpu_torch/ops/layout_probe.py.
// What bounds them: the output bytes (256 KB, 16 KB for the transpose) at
// the memory rate, 0.0001 ms; each is far smaller than a launch's fixed
// cost, so the design is the launch's shape and its latency. Every probe
// runs at least 64 blocks (the card has 132 SMs), no block reads more of x
// than its own rows, and every output row is written with 16-byte stores
// (dot_tlhs: 8-byte stores of adjacent accumulator pairs). dot_tlhs gives
// each warp one 16 x 32 tile (32 row tiles x 4 column groups = 128
// one-warp blocks): its A fragments come straight from global memory, with
// no shared copy of x and no barrier, and its four n8 tiles are four
// independent three-pass chains.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kS = 512;
constexpr int kR = 128;
constexpr int kThreads = 128;
// Each of the 128-column probes: 4 output rows per block of 128 threads,
// one float4 (4 columns of one row) per thread: 128 blocks.
constexpr int kRowsPerBlock = 4;
constexpr int kQuads = kR / 4;  // float4s per output row

__device__ __forceinline__ void store_row4(float* out, int s, int q, float v) {
  reinterpret_cast<float4*>(out + s * kR)[q] = make_float4(v, v, v, v);
}

__global__ void __launch_bounds__(kThreads) reshape_f32(const float* __restrict__ x,
                                                        float* __restrict__ out) {
  __shared__ float col[kRowsPerBlock];
  const int s0 = blockIdx.x * kRowsPerBlock;
  if (threadIdx.x < kRowsPerBlock) col[threadIdx.x] = x[s0 + threadIdx.x];
  __syncthreads();
  const int i = threadIdx.x / kQuads;
  store_row4(out, s0 + i, threadIdx.x % kQuads, col[i]);
}

__global__ void __launch_bounds__(kThreads) iota_col(const float* __restrict__ x,
                                                     float* __restrict__ out) {
  const int ln = static_cast<int>(x[0]);
  const int s = blockIdx.x * kRowsPerBlock + threadIdx.x / kQuads;
  store_row4(out, s, threadIdx.x % kQuads, s < ln ? 1.f : 0.f);  // one value per row
}

__global__ void __launch_bounds__(kThreads) iota_col_full(const float* __restrict__ x,
                                                          float* __restrict__ out) {
  const int ln = static_cast<int>(x[0]);
  const int e = 4 * (blockIdx.x * blockDim.x + threadIdx.x);  // flat (s, r) of the first
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = ((e + j) / kR) < ln ? 1.f : 0.f;
  reinterpret_cast<float4*>(out)[e / 4] = make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kThreads) bool_reshape(const float* __restrict__ x,
                                                         float* __restrict__ out) {
  __shared__ unsigned char row[kRowsPerBlock];
  const int ln = static_cast<int>(x[0]);
  const int s0 = blockIdx.x * kRowsPerBlock;
  if (threadIdx.x < kRowsPerBlock) row[threadIdx.x] = (s0 + threadIdx.x) < ln;
  __syncthreads();
  const int i = threadIdx.x / kQuads;
  store_row4(out, s0 + i, threadIdx.x % kQuads, row[i] ? 1.f : 0.f);
}

// One warp per block, one 16-row x 32-column tile of out per warp: block b
// takes rows 16 (b / 4) .. + 16 and columns 32 (b % 4) .. + 32.
__global__ void __launch_bounds__(32) dot_tlhs(const float* __restrict__ x,
                                               float* __restrict__ out) {
  const int g = threadIdx.x >> 2;
  const int t = threadIdx.x & 3;
  const int s0 = (blockIdx.x >> 2) * 16;
  const int c0 = (blockIdx.x & 3) * 32;
  // A = x^T (16 x 8 of it): A[m][kk] = x[kk][s0 + m]; the lanes of one t
  // read 8 consecutive floats of x's row t (or t + 4).
  uint32_t a0[3], a1[3], a2[3], a3[3];
  tf32_split<kTf32x3>(x[t * kS + s0 + g], a0);
  tf32_split<kTf32x3>(x[t * kS + s0 + g + 8], a1);
  tf32_split<kTf32x3>(x[(t + 4) * kS + s0 + g], a2);
  tf32_split<kTf32x3>(x[(t + 4) * kS + s0 + g + 8], a3);
  const uint32_t one = __float_as_uint(1.f);
  float c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
  // The three passes in v1's order (hi, mid, lo) into one accumulator per
  // n8 tile; the four tiles' chains are independent.
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32_m16n8k8(c[j], a0[p], a1[p], a2[p], a3[p], one, one);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(out + (s0 + g) * kR + col) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(out + (s0 + g + 8) * kR + col) = make_float2(c[j][2], c[j][3]);
  }
}

// 64 blocks of 32 threads, 8 output rows each: thread (row i, half h)
// reads x[4h .. 4h + 3][s] (the lanes of one h read consecutive s) and
// writes them as one float4, so a warp writes 1 KB of out contiguously.
__global__ void __launch_bounds__(32) transpose_f32(const float* __restrict__ x,
                                                    float* __restrict__ out) {
  const int s = blockIdx.x * 8 + (threadIdx.x >> 1);
  const int h = threadIdx.x & 1;
  const float4 v = make_float4(x[(4 * h) * kS + s], x[(4 * h + 1) * kS + s],
                               x[(4 * h + 2) * kS + s], x[(4 * h + 3) * kS + s]);
  reinterpret_cast<float4*>(out + s * 8)[h] = v;
}

__global__ void __launch_bounds__(kThreads) broadcast_row_to_col(const float* __restrict__ x,
                                                                 float* __restrict__ out) {
  __shared__ float tile[kR][kRowsPerBlock + 1];  // (R, rows) slice of the broadcast
  const int s0 = blockIdx.x * kRowsPerBlock;
  for (int i = threadIdx.x; i < kR * kRowsPerBlock; i += blockDim.x)
    tile[i / kRowsPerBlock][i % kRowsPerBlock] = x[s0 + i % kRowsPerBlock];
  __syncthreads();
  const int i = threadIdx.x / kQuads;
  const int q = threadIdx.x % kQuads;
  reinterpret_cast<float4*>(out + (s0 + i) * kR)[q] =
      make_float4(tile[4 * q][i], tile[4 * q + 1][i], tile[4 * q + 2][i], tile[4 * q + 3][i]);
}

}  // namespace

extern "C" {

// probe: the index above. x (8, 512) and out ((512, 128), or (512, 8) for
// the transpose) float32 on the card. Launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().
int dc_layout_probe(int probe, const void* x, void* out, void* stream) {
  const float* px = static_cast<const float*>(x);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = kS / kRowsPerBlock;  // 128
  switch (probe) {
    case 0: reshape_f32<<<blocks, kThreads, 0, st>>>(px, po); break;
    case 1: iota_col<<<blocks, kThreads, 0, st>>>(px, po); break;
    case 2: iota_col_full<<<kS * kR / 4 / kThreads, kThreads, 0, st>>>(px, po); break;
    case 3: bool_reshape<<<blocks, kThreads, 0, st>>>(px, po); break;
    case 4: dot_tlhs<<<(kS / 16) * (kR / 32), 32, 0, st>>>(px, po); break;
    case 5: transpose_f32<<<kS / 8, 32, 0, st>>>(px, po); break;
    case 6: broadcast_row_to_col<<<blocks, kThreads, 0, st>>>(px, po); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
