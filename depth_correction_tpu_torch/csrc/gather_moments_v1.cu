// The first Hopper version of the fused gather + moments kernel (P7), kept
// unchanged beside its redesign (csrc/gather_moments.cu) so that the two
// compare inside one call on one card; only its C entry is renamed
// (dc_gather_moments_v1). No path launches it: chip_smoke.py's A/B and the
// card tests do, through ops/_kernels.launch_gather_moments_v1.
//
// Fused gather + weighted neighbourhood moments (P7) for Hopper (sm_90a),
// with a plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas kernel scripts/exp_pallas_gather.py: moments_kernel,
// which computes what depth_correction_tpu/ops/features.py:_moments_impl
// computes (the generic path of neighborhood_features, features.py:
// 748-794): per query row, the weighted mean and the six Bessel-corrected
// covariance components of its K gathered neighbours. Its plain torch
// version is gather_moments_plain in depth_correction_tpu_torch/ops/features.py.
//
// What bounds it on this card: the gather. Per row it reads K indices and
// K weights (8 bytes each, contiguous) and K points at random addresses
// (12 bytes each, one 32-byte sector apiece), for ~30 float ops per
// neighbour: far below the card's operations-per-byte balance, so it is
// bound by memory transactions. The design therefore gives each row one
// warp, whose lanes take neighbours j, j + 32, ...: the index and weight
// reads of a row are coalesced, and the 32 point gathers of a warp are in
// flight together. Lanes reduce their ten sums by warp shuffles, and lane
// 0 writes the row. No shared memory, no atomics, deterministic.
//
// Numerics: sums are taken about the row's first neighbour with a nonzero
// weight (neighbourhoods are small against their distance from the origin,
// and f32 sums of squares of raw coordinates would cancel). Index -1 and
// indices outside [0, N) contribute nothing; so does a zero weight.
// w_sum = max(sum w, 1e-12), the normaliser max(sum w - 1, 1e-6), as in
// features.py. The kernel allocates nothing; the wrapper allocates outputs.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void gather_moments_kernel(
    const float* __restrict__ pts,   // point i, component c at pts[i * sp + c * sc]
    long long sp, long long sc, int n_pts,
    const int* __restrict__ idx,     // (mq, k) neighbour indices, -1 padded
    const float* __restrict__ w,     // (mq, k) weights
    int mq, int k,
    float* __restrict__ mean,        // (3, mq)
    float* __restrict__ comps,       // (6, mq)
    float* __restrict__ wsum) {      // (mq,)
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= mq) return;  // uniform across the warp
  const int* ri = idx + static_cast<size_t>(row) * k;
  const float* rw = w + static_cast<size_t>(row) * k;

  // The shift: the row's first neighbour that contributes.
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int base = 0; base < k; base += 32) {
    const int j = base + lane;
    int id = -1;
    bool ok = false;
    if (j < k) {
      id = ri[j];
      ok = id >= 0 && id < n_pts && rw[j] != 0.f;
    }
    const unsigned found = __ballot_sync(kFull, ok);
    if (found) {  // uniform across the warp
      const long long sid = __shfl_sync(kFull, id, __ffs(found) - 1);
      sx = pts[sid * sp];
      sy = pts[sid * sp + sc];
      sz = pts[sid * sp + 2 * sc];
      break;
    }
  }

  float a[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) a[c] = 0.f;
  for (int j = lane; j < k; j += 32) {
    const int id = ri[j];
    const float wt = rw[j];
    if (id >= 0 && id < n_pts && wt != 0.f) {
      const long long i = id;
      const float x = pts[i * sp] - sx;
      const float y = pts[i * sp + sc] - sy;
      const float z = pts[i * sp + 2 * sc] - sz;
      const float wx = wt * x, wy = wt * y, wz = wt * z;
      a[0] += wt;
      a[1] += wx;
      a[2] += wy;
      a[3] += wz;
      a[4] += wx * x;
      a[5] += wy * y;
      a[6] += wz * z;
      a[7] += wx * y;
      a[8] += wx * z;
      a[9] += wy * z;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 10; ++c) a[c] += __shfl_xor_sync(kFull, a[c], off);
  }
  if (lane == 0) {
    const float s0c = fmaxf(a[0], 1e-12f);
    const float m0 = a[1] / s0c;
    const float m1 = a[2] / s0c;
    const float m2 = a[3] / s0c;
    const float denom = fmaxf(a[0] - 1.f, 1e-6f);
    mean[row] = m0 + sx;
    mean[mq + row] = m1 + sy;
    mean[2 * mq + row] = m2 + sz;
    comps[row] = (a[4] - a[0] * m0 * m0) / denom;
    comps[mq + row] = (a[5] - a[0] * m1 * m1) / denom;
    comps[2 * mq + row] = (a[6] - a[0] * m2 * m2) / denom;
    comps[3 * mq + row] = (a[7] - a[0] * m0 * m1) / denom;
    comps[4 * mq + row] = (a[8] - a[0] * m0 * m2) / denom;
    comps[5 * mq + row] = (a[9] - a[0] * m1 * m2) / denom;
    wsum[row] = s0c;
  }
}

constexpr int kRowsPerBlock = 8;  // 8 warps, 256 threads

}  // namespace

extern "C" {

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted).
int dc_gather_moments_v1(const void* pts, long long sp, long long sc, int n_pts,
                         const void* idx, const void* w, int mq, int k,
                         void* mean, void* comps, void* wsum, void* stream) {
  if (mq > 0) {
    const int blocks = (mq + kRowsPerBlock - 1) / kRowsPerBlock;
    gather_moments_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), sp, sc, n_pts,
        static_cast<const int*>(idx), static_cast<const float*>(w), mq, k,
        static_cast<float*>(mean), static_cast<float*>(comps),
        static_cast<float*>(wsum));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
