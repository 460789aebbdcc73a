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
// memory against one from shared memory. So each case has two forms:
//
//   global  x[idx] loaded from device memory (the index space is the whole
//           array). Each lane takes 4 groups of 4 consecutive outputs: four
//           16-byte index loads, 16 independent read-only gathers in
//           flight, four 16-byte stores, each load and store of a warp 512
//           contiguous bytes; a grid-stride loop over a grid of at most 8
//           blocks an SM. A span's tail, i_cols not a multiple of 4, or
//           pointers not 16-byte aligned take the same loop with scalar
//           loads.
//   staged  the index space is what shared memory holds. Where x's row
//           (axis 1), or all of x (axis 0), fits one block (227 KB), each
//           block stages it and gathers there.
//           Where a row does not fit one block but fits a cluster of 8
//           (B's 512 KB row), the row is spread over the distributed shared
//           memory of a thread-block cluster: block k of the cluster holds
//           the k-th eighth, and every block gathers its outputs from the
//           owning block's shared memory (cluster.map_shared_rank). About
//           two blocks an SM: the clusters of a row each stage it again.
//
// Indices must lie in range. A gather moves values unchanged, so every form
// equals the plain torch version (ops/gather_probe.py) bit for bit. What
// bounds it: the bytes (indices read, outputs written, x read once); each
// case is small against a launch's fixed cost except B (4 MB each way),
// whose random gathers also read one 32-byte L2 sector for each 4-byte
// value.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;       // groups of 4 outputs a lane takes per pass (global form)
constexpr int kBlocksPerSm = 8;  // the global form's grid: at most this many blocks an SM
constexpr int kCluster = 8;      // blocks a cluster for the staged form of a long row
constexpr int kClusterGroups = 2;  // groups of 4 outputs a lane takes per pass (cluster form)

// Output (r, c) of the (i_rows, i_cols) result: the offset of its source in x.
template <int AXIS>
__device__ __forceinline__ long long source(long long e, int i_cols, int x_cols, int src) {
  const long long r = e / i_cols;
  return AXIS == 1 ? r * x_cols + src : static_cast<long long>(src) * x_cols + (e - r * i_cols);
}

// The global form. AXIS 1: out[r, j] = x[r, idx[r, j]]; AXIS 0: out[i, j] =
// x[idx[i, j], j]. n = i_rows * i_cols outputs. A warp takes a span of
// 128 * kGroups consecutive outputs a pass, lane l the groups of 4 at
// 128 g + 4 l, so each index load and each store of the warp is 512
// contiguous bytes. VEC: idx and out 16-byte aligned and i_cols a multiple
// of 4 (a group never crosses a row), so a full span moves as int4 / float4.
template <int AXIS, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_global(const float* __restrict__ x, const int* __restrict__ idx, int x_cols, int i_cols,
              long long n, float* __restrict__ out) {
  constexpr int kSpan = 128 * kGroups;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long wb = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32 * kSpan;
       wb < n; wb += warps * kSpan) {
    if (VEC && wb + kSpan <= n) {
      int4 s[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        s[g] = __ldg(reinterpret_cast<const int4*>(idx + wb + 128 * g + 4 * lane));
      float4 v[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        // The group's 4 outputs share a row: one division a group.
        const long long e = wb + 128 * g + 4 * lane;
        const long long r = e / i_cols;
        if (AXIS == 1) {
          const float* xr = x + r * x_cols;
          v[g] = make_float4(__ldg(xr + s[g].x), __ldg(xr + s[g].y), __ldg(xr + s[g].z),
                             __ldg(xr + s[g].w));
        } else {
          const float* xc = x + (e - r * i_cols);
          v[g] = make_float4(__ldg(xc + static_cast<long long>(s[g].x) * x_cols),
                             __ldg(xc + static_cast<long long>(s[g].y) * x_cols + 1),
                             __ldg(xc + static_cast<long long>(s[g].z) * x_cols + 2),
                             __ldg(xc + static_cast<long long>(s[g].w) * x_cols + 3));
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        *reinterpret_cast<float4*>(out + wb + 128 * g + 4 * lane) = v[g];
    } else {
      int s[4 * kGroups];
#pragma unroll
      for (int k = 0; k < 4 * kGroups; ++k) {
        const long long e = wb + 128 * (k / 4) + 4 * lane + k % 4;
        s[k] = e < n ? __ldg(idx + e) : 0;
      }
      float v[4 * kGroups];
#pragma unroll
      for (int k = 0; k < 4 * kGroups; ++k) {
        const long long e = wb + 128 * (k / 4) + 4 * lane + k % 4;
        if (e < n) v[k] = __ldg(x + source<AXIS>(e, i_cols, x_cols, s[k]));
      }
#pragma unroll
      for (int k = 0; k < 4 * kGroups; ++k) {
        const long long e = wb + 128 * (k / 4) + 4 * lane + k % 4;
        if (e < n) out[e] = v[k];
      }
    }
  }
}

// The staged form in one block. Axis 1: grid
// (ceil(i_cols / 256), i_rows), the block's row staged.
__global__ void gather_rows_staged(const float* __restrict__ x, const int* __restrict__ idx,
                                   int x_cols, int i_cols, float* __restrict__ out) {
  extern __shared__ float row[];
  const int r = blockIdx.y;
  const float* xr = x + static_cast<size_t>(r) * x_cols;
  for (int c = threadIdx.x; c < x_cols; c += blockDim.x) row[c] = xr[c];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= i_cols) return;
  out[static_cast<size_t>(r) * i_cols + j] = row[idx[static_cast<size_t>(r) * i_cols + j]];
}

// Axis 0: all of x staged; grid (ceil(i_cols / 256), i_rows).
__global__ void gather_cols_staged(const float* __restrict__ x, const int* __restrict__ idx,
                                   int x_rows, int x_cols, int i_cols, float* __restrict__ out) {
  extern __shared__ float tab[];
  for (int e = threadIdx.x; e < x_rows * x_cols; e += blockDim.x) tab[e] = x[e];
  __syncthreads();
  const int i = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= i_cols) return;
  out[static_cast<size_t>(i) * i_cols + j] =
      tab[idx[static_cast<size_t>(i) * i_cols + j] * x_cols + j];
}

// The staged form of a row too long for one block, on a cluster of
// kCluster blocks. Grid: i_rows * splits clusters, in row order. Block k of
// a cluster stages x[r, k * slice : (k + 1) * slice) (slice a multiple of 4)
// and serves output part (s * kCluster + k) of the row's splits * kCluster
// parts of `per` columns (a multiple of 128 * kClusterGroups); its warps
// take spans of 128 * kClusterGroups outputs, lane l the groups of 4 at
// 128 g + 4 l. VEC: x, idx and out 16-byte aligned and x_cols, i_cols
// multiples of 4, so the staging and each full span move as 16-byte words.
template <bool VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
gather_rows_cluster(const float* __restrict__ x, const int* __restrict__ idx, int x_cols,
                    int i_cols, int slice, int splits, int per, float* __restrict__ out) {
  constexpr int kSpan = 128 * kClusterGroups;
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / kCluster;
  const int r = cl / splits;
  const int s = cl - r * splits;
  const float* xr = x + static_cast<size_t>(r) * x_cols;
  const int lo = rank * slice;
  const int hi = min(lo + slice, x_cols);
  if (VEC) {
    for (int c = lo + 4 * threadIdx.x; c < hi; c += 4 * kThreads)
      smem4[(c - lo) >> 2] = __ldg(reinterpret_cast<const float4*>(xr + c));
  } else {
    for (int c = lo + threadIdx.x; c < hi; c += kThreads) part[c - lo] = __ldg(xr + c);
  }
  // Every block's part is staged before any block reads it.
  cluster.sync();
  const int j0 = (s * kCluster + rank) * per;
  const int j1 = min(j0 + per, i_cols);
  const int* ir = idx + static_cast<size_t>(r) * i_cols;
  float* orow = out + static_cast<size_t>(r) * i_cols;
  const int lane = threadIdx.x & 31;
  for (int wb = j0 + (threadIdx.x >> 5) * kSpan; wb < j1; wb += (kThreads / 32) * kSpan) {
    const bool full = VEC && wb + kSpan <= j1;
    int src[4 * kClusterGroups];
#pragma unroll
    for (int g = 0; g < kClusterGroups; ++g) {
      const int j = wb + 128 * g + 4 * lane;
      if (full) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(ir + j));
        src[4 * g] = a.x; src[4 * g + 1] = a.y; src[4 * g + 2] = a.z; src[4 * g + 3] = a.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) src[4 * g + k] = j + k < j1 ? __ldg(ir + j + k) : 0;
      }
    }
    float v[4 * kClusterGroups];
#pragma unroll
    for (int k = 0; k < 4 * kClusterGroups; ++k) {
      const int owner = src[k] / slice;
      v[k] = cluster.map_shared_rank(part, owner)[src[k] - owner * slice];
    }
#pragma unroll
    for (int g = 0; g < kClusterGroups; ++g) {
      const int j = wb + 128 * g + 4 * lane;
      if (full) {
        *reinterpret_cast<float4*>(orow + j) =
            make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j + k < j1) orow[j + k] = v[4 * g + k];
      }
    }
  }
  // No block leaves (and frees its shared memory) while another reads it.
  cluster.sync();
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int device_attr(cudaDeviceAttr attr, int* value) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, device);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// staged: 0 global, 1 staged; axis 0 or 1. x (x_rows, x_cols), idx and out
// (i_rows, i_cols); axis 0 needs i_cols == x_cols. A staged axis-1 call
// whose row does not fit one block runs on clusters of 8 blocks. Launches
// on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for bad arguments, a staged
// form too big for shared memory included).
int dc_gather_probe(int staged, int axis, const void* x, const void* idx, int x_rows,
                    int x_cols, int i_rows, int i_cols, void* out, void* stream) {
  if (x_rows <= 0 || x_cols <= 0 || i_rows <= 0 || i_cols <= 0 || (axis != 0 && axis != 1) ||
      (axis == 0 && i_cols != x_cols) || (axis == 1 && i_rows != x_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* px = static_cast<const float*>(x);
  const int* pi = static_cast<const int*>(idx);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (!staged) {
    int sms = 0;
    if ((err = device_attr(cudaDevAttrMultiProcessorCount, &sms))) return err;
    const long long n = static_cast<long long>(i_rows) * i_cols;
    const long long per_block = static_cast<long long>(kThreads) * 4 * kGroups;
    const long long want = (n + per_block - 1) / per_block;
    const int blocks = static_cast<int>(want < sms * kBlocksPerSm ? want : sms * kBlocksPerSm);
    const bool vec = aligned16(pi) && aligned16(po) && i_cols % 4 == 0;
    if (axis == 1) {
      if (vec)
        gather_global<1, true><<<blocks, kThreads, 0, st>>>(px, pi, x_cols, i_cols, n, po);
      else
        gather_global<1, false><<<blocks, kThreads, 0, st>>>(px, pi, x_cols, i_cols, n, po);
    } else {
      if (vec)
        gather_global<0, true><<<blocks, kThreads, 0, st>>>(px, pi, x_cols, i_cols, n, po);
      else
        gather_global<0, false><<<blocks, kThreads, 0, st>>>(px, pi, x_cols, i_cols, n, po);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int max_smem = 0;
  if ((err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &max_smem))) return err;
  const size_t smem = sizeof(float) * static_cast<size_t>(x_cols) * (axis == 0 ? x_rows : 1);
  const dim3 grid((i_cols + kThreads - 1) / kThreads, i_rows);
  if (axis == 0) {
    if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
    err = set_smem(gather_cols_staged, smem);
    if (!err) gather_cols_staged<<<grid, kThreads, smem, st>>>(px, pi, x_rows, x_cols, i_cols, po);
  } else if (smem <= static_cast<size_t>(max_smem)) {
    err = set_smem(gather_rows_staged, smem);
    if (!err) gather_rows_staged<<<grid, kThreads, smem, st>>>(px, pi, x_cols, i_cols, po);
  } else {
    // The row spread over a cluster: slices of a multiple of 4 floats.
    const int slice = ((x_cols + kCluster - 1) / kCluster + 3) / 4 * 4;
    const size_t cl_smem = sizeof(float) * static_cast<size_t>(slice);
    if (cl_smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    if ((err = device_attr(cudaDevAttrMultiProcessorCount, &sms))) return err;
    // About two blocks an SM: each cluster stages its row again.
    int splits = 2 * sms / (i_rows * kCluster);
    if (splits < 1) splits = 1;
    const int parts = splits * kCluster;
    constexpr int kSpan = 128 * kClusterGroups;
    const int per = ((i_cols + parts - 1) / parts + kSpan - 1) / kSpan * kSpan;
    const bool vec = aligned16(px) && aligned16(pi) && aligned16(po) && x_cols % 4 == 0 &&
                     i_cols % 4 == 0;
    const int blocks = i_rows * parts;
    if (vec) {
      err = set_smem(gather_rows_cluster<true>, cl_smem);
      if (!err)
        gather_rows_cluster<true><<<blocks, kThreads, cl_smem, st>>>(px, pi, x_cols, i_cols, slice,
                                                                     splits, per, po);
    } else {
      err = set_smem(gather_rows_cluster<false>, cl_smem);
      if (!err)
        gather_rows_cluster<false><<<blocks, kThreads, cl_smem, st>>>(px, pi, x_cols, i_cols,
                                                                      slice, splits, per, po);
    }
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
