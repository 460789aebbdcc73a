// The first Hopper version of P6's layout probes, kept unchanged beside its
// redesign (csrc/layout_probe.cu) so that the two compare inside one call on one
// card; only its C entry is renamed (dc_layout_probe_v1). No path launches it:
// chip_smoke.py's A/B and the card tests do, through
// ops/_kernels.launch_layout_probe_v1.
//
// The layout probes (P6) for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replace the Pallas probes scripts/exp_mosaic_probe.py:k_* (:37-78, each
// one pallas_call at :23): seven tiny kernels that asked which vector
// layouts Mosaic lowers on a TPU. On Hopper each becomes the CUDA kernel
// writing what its Pallas body writes, from the script's input x (8, 512)
// float32, and the question becomes what each layout move costs here:
//
//   0 reshape_f32           out (512, 128): out[s, r] = x[0, s]; row 0 staged
//                           in shared memory and read back as a column
//   1 iota_col              out (512, 128): out[s, r] = s < x[0, 0]; the mask
//                           computed once per row (a column iota) and broadcast
//   2 iota_col_full         the same mask from a full (512, 128) iota
//   3 bool_reshape          the same mask built as a (1, 512) row of bytes in
//                           shared memory and read back as a column
//   4 dot_tlhs              out (512, 128) = x^T ones(8, 128): mma.sync TF32
//                           m16n8k8 with A = x^T read transposed from shared
//                           memory, in the three-pass split of tf32_mma.cuh,
//                           so the integer sums are exact
//   5 transpose_f32         out (512, 8) = x^T through shared memory
//   6 broadcast_row_to_col  out (512, 128): out[s, r] = x[0, s]; the row
//                           broadcast to (128, 32) tiles in shared memory and
//                           written transposed
//
// The plain torch versions are in depth_correction_tpu_torch/ops/layout_probe.py.
// What bounds them: the output bytes (256 KB, 16 KB for the transpose) at
// the memory rate; each is far smaller than a launch's fixed cost.

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kS = 512;
constexpr int kR = 128;
constexpr int kRowsPerBlock = 32;  // output rows per block of 128 threads

__global__ void reshape_f32(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float col[kRowsPerBlock];
  const int s0 = blockIdx.x * kRowsPerBlock;
  if (threadIdx.x < kRowsPerBlock) col[threadIdx.x] = x[s0 + threadIdx.x];
  __syncthreads();
  for (int i = 0; i < kRowsPerBlock; ++i) out[(s0 + i) * kR + threadIdx.x] = col[i];
}

__global__ void iota_col(const float* __restrict__ x, float* __restrict__ out) {
  const int ln = static_cast<int>(x[0]);
  const int s0 = blockIdx.x * kRowsPerBlock;
  for (int i = 0; i < kRowsPerBlock; ++i) {
    const float m = (s0 + i) < ln ? 1.f : 0.f;  // one value per row
    out[(s0 + i) * kR + threadIdx.x] = m;
  }
}

__global__ void iota_col_full(const float* __restrict__ x, float* __restrict__ out) {
  const int ln = static_cast<int>(x[0]);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;  // flat (s, r)
  if (e < kS * kR) out[e] = (e / kR) < ln ? 1.f : 0.f;
}

__global__ void bool_reshape(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ unsigned char row[kS];
  const int ln = static_cast<int>(x[0]);
  for (int s = threadIdx.x; s < kS; s += blockDim.x) row[s] = s < ln;
  __syncthreads();
  const int s0 = blockIdx.x * kRowsPerBlock;
  for (int i = 0; i < kRowsPerBlock; ++i)
    out[(s0 + i) * kR + threadIdx.x] = row[s0 + i] ? 1.f : 0.f;
}

// Four warps, each one 16-row tile of out (all 16 n8 tiles of 128 columns).
__global__ void dot_tlhs(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float sx[8][kS + 4];
  for (int i = threadIdx.x; i < 8 * kS; i += blockDim.x) sx[i / kS][i % kS] = x[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int s0 = (blockIdx.x * 4 + warp) * 16;
  // A = x^T (16 x 8 of it): A[m][kk] = x[kk][s0 + m], read transposed.
  uint32_t a0[3], a1[3], a2[3], a3[3];
  tf32_split<kTf32x3>(sx[t][s0 + g], a0);
  tf32_split<kTf32x3>(sx[t][s0 + g + 8], a1);
  tf32_split<kTf32x3>(sx[t + 4][s0 + g], a2);
  tf32_split<kTf32x3>(sx[t + 4][s0 + g + 8], a3);
  const uint32_t one = __float_as_uint(1.f);
  for (int j = 0; j < kR / 8; ++j) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < 3; ++p) mma_tf32_m16n8k8(c, a0[p], a1[p], a2[p], a3[p], one, one);
    const int col = 8 * j + 2 * t;
    out[(s0 + g) * kR + col] = c[0];
    out[(s0 + g) * kR + col + 1] = c[1];
    out[(s0 + g + 8) * kR + col] = c[2];
    out[(s0 + g + 8) * kR + col + 1] = c[3];
  }
}

__global__ void transpose_f32(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float tile[8][kRowsPerBlock + 1];
  const int s0 = blockIdx.x * kRowsPerBlock;
  for (int i = threadIdx.x; i < 8 * kRowsPerBlock; i += blockDim.x)
    tile[i / kRowsPerBlock][i % kRowsPerBlock] = x[(i / kRowsPerBlock) * kS + s0 + i % kRowsPerBlock];
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * kRowsPerBlock; i += blockDim.x)
    out[(s0 + i / 8) * 8 + i % 8] = tile[i % 8][i / 8];
}

__global__ void broadcast_row_to_col(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float tile[kR][kRowsPerBlock + 1];  // (R, 32) slice of the broadcast
  const int s0 = blockIdx.x * kRowsPerBlock;
  for (int i = threadIdx.x; i < kR * kRowsPerBlock; i += blockDim.x)
    tile[i / kRowsPerBlock][i % kRowsPerBlock] = x[s0 + i % kRowsPerBlock];
  __syncthreads();
  for (int i = 0; i < kRowsPerBlock; ++i) out[(s0 + i) * kR + threadIdx.x] = tile[threadIdx.x][i];
}

}  // namespace

extern "C" {

// probe: the index above. x (8, 512) and out ((512, 128), or (512, 8) for
// the transpose) float32 on the card. Launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().
int dc_layout_probe_v1(int probe, const void* x, void* out, void* stream) {
  const float* px = static_cast<const float*>(x);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = kS / kRowsPerBlock;
  switch (probe) {
    case 0: reshape_f32<<<blocks, kR, 0, st>>>(px, po); break;
    case 1: iota_col<<<blocks, kR, 0, st>>>(px, po); break;
    case 2: iota_col_full<<<kS * kR / 256, 256, 0, st>>>(px, po); break;
    case 3: bool_reshape<<<blocks, kR, 0, st>>>(px, po); break;
    case 4: dot_tlhs<<<kS / 64, 128, 0, st>>>(px, po); break;
    case 5: transpose_f32<<<blocks, kR, 0, st>>>(px, po); break;
    case 6: broadcast_row_to_col<<<blocks, kR, 0, st>>>(px, po); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
