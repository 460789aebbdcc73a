// The first Hopper version of the dynamic-gather probes (P8), kept unchanged
// beside their redesign (csrc/gather_probe.cu) so that the two compare inside
// one call on one card; only its C entry is renamed (dc_gather_probe_v1). No
// path launches it: chip_smoke.py's A/B and the card tests do, through
// ops/_kernels.launch_gather_probe_v1.
//
// The dynamic-gather probes (P8) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replace the Pallas probe scripts/exp_pallas_gather2.py:main (cases A-E,
// each one pallas_call at :19), which asked which dynamic-gather forms
// Mosaic lowers and whether a gather's index space is the whole array or
// one tile. The cases: take_along_axis along a row (axis 1: A (8, 256), B
// (8, 131072), D (8, 1024) -> (8, 256); E, a 1-D take of (2048,), is one
// row) or along a column (axis 0: C (8, 256)). On Hopper the question is
// the same one the grid search's candidate loads ask: a gather from device
// memory against one from a block's shared memory. So each case has two
// forms:
//
//   global  each thread loads x[idx] from device memory (the index space is
//           the whole array);
//   staged  the block stages its row (axis 1), or all of x (axis 0), in
//           shared memory and gathers there (the index space is what one
//           block holds: at most 227 KB, so B's 512 KB row has no staged
//           form; the launcher refuses it).
//
// Indices must lie in range. The plain torch versions are in
// depth_correction_tpu_torch/ops/gather_probe.py. What bounds them: the
// bytes (indices read, outputs written, x read once); each case is small
// against a launch's fixed cost except B (4 MB each way).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Axis 1: out[r, j] = x[r, idx[r, j]]. Grid (ceil(i_cols / 256), i_rows).
template <bool STAGED>
__global__ void gather_rows(const float* __restrict__ x, const int* __restrict__ idx,
                            int x_cols, int i_cols, float* __restrict__ out) {
  extern __shared__ float row[];
  const int r = blockIdx.y;
  const float* xr = x + static_cast<size_t>(r) * x_cols;
  if constexpr (STAGED) {
    for (int c = threadIdx.x; c < x_cols; c += blockDim.x) row[c] = xr[c];
    __syncthreads();
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= i_cols) return;
  const int src = idx[static_cast<size_t>(r) * i_cols + j];
  out[static_cast<size_t>(r) * i_cols + j] = STAGED ? row[src] : xr[src];
}

// Axis 0: out[i, j] = x[idx[i, j], j]. Grid (ceil(i_cols / 256), i_rows).
template <bool STAGED>
__global__ void gather_cols(const float* __restrict__ x, const int* __restrict__ idx,
                            int x_rows, int x_cols, int i_cols, float* __restrict__ out) {
  extern __shared__ float tab[];
  if constexpr (STAGED) {
    for (int e = threadIdx.x; e < x_rows * x_cols; e += blockDim.x) tab[e] = x[e];
    __syncthreads();
  }
  const int i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= i_cols) return;
  const int src = idx[static_cast<size_t>(i) * i_cols + j] * x_cols + j;
  out[static_cast<size_t>(i) * i_cols + j] = STAGED ? tab[src] : x[src];
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace

extern "C" {

// staged: 0 global, 1 staged; axis 0 or 1. x (x_rows, x_cols), idx and out
// (i_rows, i_cols); axis 0 needs i_cols == x_cols. Launches on the caller's
// stream, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for bad arguments, a staged form too big for
// shared memory included).
int dc_gather_probe_v1(int staged, int axis, const void* x, const void* idx, int x_rows,
                    int x_cols, int i_rows, int i_cols, void* out, void* stream) {
  if (x_rows <= 0 || x_cols <= 0 || i_rows <= 0 || i_cols <= 0 || (axis != 0 && axis != 1) ||
      (axis == 0 && i_cols != x_cols) || (axis == 1 && i_rows != x_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* px = static_cast<const float*>(x);
  const int* pi = static_cast<const int*>(idx);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((i_cols + kThreads - 1) / kThreads, i_rows);
  size_t smem = 0;
  if (staged) {
    smem = sizeof(float) * static_cast<size_t>(x_cols) * (axis == 0 ? x_rows : 1);
    int device = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = 0;
  if (axis == 1) {
    if (staged) {
      err = set_smem(gather_rows<true>, smem);
      if (!err) gather_rows<true><<<grid, kThreads, smem, st>>>(px, pi, x_cols, i_cols, po);
    } else {
      gather_rows<false><<<grid, kThreads, 0, st>>>(px, pi, x_cols, i_cols, po);
    }
  } else {
    if (staged) {
      err = set_smem(gather_cols<true>, smem);
      if (!err)
        gather_cols<true><<<grid, kThreads, smem, st>>>(px, pi, x_rows, x_cols, i_cols, po);
    } else {
      gather_cols<false><<<grid, kThreads, 0, st>>>(px, pi, x_rows, x_cols, i_cols, po);
    }
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
