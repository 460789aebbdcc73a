// The first version of the slab-window moments (X1), kept unchanged beside
// its redesign (csrc/slabwin.cu) so that the two compare inside one call on
// one card; the redesign must equal it bit for bit. No path of the package
// launches it: chip_smoke.py's A/B and the card tests do, through
// ops/slabwin.slab_window_kernel_v1. Plain C interface, loaded through
// ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the XLA lax.scan engine depth_correction_tpu/ops/slabwin.py:
// slab_window_moments, as the redesign does; its plain torch version is
// slab_window_moments_plain in depth_correction_tpu_torch/ops/slabwin.py.
//
// Design (K1's first structure, csrc/cellwin_v1.cu): one block per 128-slot
// tile and one thread per row with its ten sums in registers; each of the
// tile's three spans is staged through shared memory in chunks of 128
// candidates, between two block barriers, and every thread tests every
// staged candidate. So a tile waits for its slowest warp at every chunk,
// and every row tests every candidate of its tile's spans.
//
// Numerics (the redesign keeps them): membership d = (x - ctr) - (q - ctr)
// on tile-centred coordinates, d2 = dx*dx + dy*dy + dz*dz with no fused
// multiply-add; sums about the row's own position; non-members branched
// over; a tile with no valid row writes zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;

// One block per 128-slot tile, one thread per slot. out rows: mean x, y, z;
// covariance 00, 11, 22, 01, 02, 12 (Bessel, normaliser max(s0 - 1, 1e-6));
// w_sum = max(s0, 0). A tile with no valid row writes zeros.
__global__ void __launch_bounds__(kTile) slab_window_v1_kernel(
    const float* __restrict__ pts,            // (3, n) sorted positions
    const unsigned char* __restrict__ valid,  // (n,) 0/1
    int n,
    const int* __restrict__ lo,               // (t, 3) span starts
    const int* __restrict__ width,            // (t, 3) span lengths
    const float* __restrict__ ctr,            // (t, 3) tile centres
    float r2,
    float* __restrict__ out) {                // (10, n)
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ float s_z[kTile];
  __shared__ unsigned char s_v[kTile];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int row = t * kTile + tid;
  const bool qv = valid[row] != 0;
  if (!__syncthreads_or(qv)) {  // the whole tile is padding
#pragma unroll
    for (int c = 0; c < 10; ++c) out[c * n + row] = 0.f;
    return;
  }
  const float cx = ctr[3 * t + 0];
  const float cy = ctr[3 * t + 1];
  const float cz = ctr[3 * t + 2];
  const float qx = pts[row] - cx;
  const float qy = pts[n + row] - cy;
  const float qz = pts[2 * n + row] - cz;

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
  float a5 = 0.f, a6 = 0.f, a7 = 0.f, a8 = 0.f, a9 = 0.f;
  for (int s = 0; s < 3; ++s) {
    const int start = lo[3 * t + s];
    const int len = width[3 * t + s];
    for (int off = 0; off < len; off += kTile) {
      const int m = min(kTile, len - off);
      __syncthreads();  // every thread has read the previous chunk
      if (tid < m) {
        const int j = start + off + tid;
        s_x[tid] = pts[j] - cx;
        s_y[tid] = pts[n + j] - cy;
        s_z[tid] = pts[2 * n + j] - cz;
        s_v[tid] = valid[j];
      }
      __syncthreads();
      if (qv) {
        for (int k = 0; k < m; ++k) {
          if (!s_v[k]) continue;
          const float dx = s_x[k] - qx;
          const float dy = s_y[k] - qy;
          const float dz = s_z[k] - qz;
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          if (d2 <= r2) {
            a0 += 1.f;
            a1 += dx;
            a2 += dy;
            a3 += dz;
            a4 += dx * dx;
            a5 += dy * dy;
            a6 += dz * dz;
            a7 += dx * dy;
            a8 += dx * dz;
            a9 += dy * dz;
          }
        }
      }
    }
  }
  const float s0c = fmaxf(a0, 1e-12f);
  const float m0 = a1 / s0c;
  const float m1 = a2 / s0c;
  const float m2 = a3 / s0c;
  const float denom = fmaxf(a0 - 1.f, 1e-6f);
  out[0 * n + row] = (m0 + qx) + cx;
  out[1 * n + row] = (m1 + qy) + cy;
  out[2 * n + row] = (m2 + qz) + cz;
  out[3 * n + row] = (a4 - a0 * m0 * m0) / denom;
  out[4 * n + row] = (a5 - a0 * m1 * m1) / denom;
  out[5 * n + row] = (a6 - a0 * m2 * m2) / denom;
  out[6 * n + row] = (a7 - a0 * m0 * m1) / denom;
  out[7 * n + row] = (a8 - a0 * m0 * m2) / denom;
  out[8 * n + row] = (a9 - a0 * m1 * m2) / denom;
  out[9 * n + row] = fmaxf(a0, 0.f);
}

}  // namespace

extern "C" {

// Launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (0 = the launch was accepted). n = 128 * t.
int dc_slab_window_v1(const void* pts, const void* valid, int n, const void* lo,
                   const void* width, const void* ctr, int t, float r2,
                   void* out, void* stream) {
  if (t > 0) {
    slab_window_v1_kernel<<<t, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const unsigned char*>(valid),
        n, static_cast<const int*>(lo), static_cast<const int*>(width),
        static_cast<const float*>(ctr), r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
