// The first Hopper version of P7's stage-1 probe (P7a), kept unchanged beside
// its redesign (csrc/gather_sum.cu) so that the two compare inside one call
// on one card; only its C entry is renamed (dc_gather_sum_v1). No path
// launches it: chip_smoke.py's A/B and the card tests do, through
// ops/_kernels.launch_gather_sum_v1.
//
// P7's stage-1 probe (P7a) for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas probe scripts/exp_pallas_gather.py:main.probe_kernel
// (:45, pallas_call :56), which asked whether Mosaic lowers a vector gather
// from a table held in VMEM: a (3, M) float32 table gathered by (T, K)
// int32 indices, each row's K columns summed into (3, T). The Hopper
// counterpart of "held in VMEM" is a block's shared memory: each block
// stages the whole table there (M = 16,384 is 196,608 bytes, past the
// default 48 KB, so the launcher opts in; a table past the card's opt-in
// limit is refused) and gathers from it. The plain torch version is
// gather_sum_plain in depth_correction_tpu_torch/ops/gather_sum.py.
//
// One thread per output row t: it reads the row's K indices and adds the
// three gathered values in index order k = 0..K-1, each addition rounded
// on its own, the plain version's order, so the two are equal bit for bit.
// Indices must lie in [0, M): one outside is undefined input, which
// neither the kernel nor its launcher checks (the plain version wraps a
// negative index and raises on one past M).
//
// What bounds it on this card: staging. Each block reads the 12 M-byte
// table from device memory (L2 after the first block) to serve 256 rows;
// the bound counts the table, the indices and the output once and one add
// per gathered value.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;  // rows (threads) per block

__global__ void gather_sum_kernel(const float* __restrict__ pts_T, int m,
                                  const int* __restrict__ idx, int t, int k,
                                  float* __restrict__ out) {
  extern __shared__ float tab[];  // (3, m)
  for (int e = threadIdx.x; e < 3 * m; e += blockDim.x) tab[e] = pts_T[e];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= t) return;
  const int* ri = idx + static_cast<size_t>(row) * k;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = 0; j < k; ++j) {
    const int c = ri[j];
    sx = __fadd_rn(sx, tab[c]);
    sy = __fadd_rn(sy, tab[m + c]);
    sz = __fadd_rn(sz, tab[2 * m + c]);
  }
  out[row] = sx;
  out[t + row] = sy;
  out[2 * t + row] = sz;
}

}  // namespace

extern "C" {

// pts_T (3, m) float32, idx (t, k) int32 -> out (3, t) float32. Launches on
// the caller's stream, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for bad arguments or a table past the opt-in
// shared-memory limit).
int dc_gather_sum_v1(const void* pts_T, int m, const void* idx, int t, int k, void* out,
                     void* stream) {
  if (m <= 0 || t < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = 3 * static_cast<size_t>(m) * sizeof(float);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gather_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (t + kRows - 1) / kRows;
  gather_sum_kernel<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts_T), m, static_cast<const int*>(idx), t, k,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
