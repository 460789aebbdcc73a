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
// K weights (8 bytes each, contiguous) and K points at random addresses,
// for ~30 float ops per neighbour: far below the card's operations-per-byte
// balance, so it is bound by memory transactions and their latency. The
// points mostly sit in L2 (a 390,144-point cloud is 4.7 MB), so what
// counts is the number of L2 sectors a neighbour costs and how many
// dependent round trips a row waits for. The design:
// - A group of G lanes takes a row: G = 4 at K <= 32 (a warp holds eight
//   rows), 8 at K <= 64, 16 above (with a warp a row, K 88 took 26% longer
//   and K 168 3-22%). Lane g takes the row's neighbours g, g + G, ...,
//   C = 8 of them a pass (a pass covers 8 G neighbours; K 168 takes two),
//   so each index and weight load of the group reads G consecutive words.
//   A lane issues all C index and weight loads, then all C gathers, and
//   only then sums; the group's ten sums meet in a log2(G)-step butterfly.
// - The shift (the row's first contributing neighbour, about which the
//   sums are taken: f32 sums of squares of raw coordinates would cancel)
//   is found in the pass the lanes load anyway: each lane's first
//   contributor, the group's smallest by a min-butterfly, its coordinates
//   shuffled from the lane that gathered them. No separate pass, no second
//   read of the indices: a row is indices, gathers, store.
// - Where the wrapper asks for it (a launch of at least
//   ops/_kernels.GATHER_PACK_MIN_PAIRS index slots), the points are first
//   packed into (N, 4) float4 rows, so a neighbour is one 16-byte load
//   from one 32-byte sector; otherwise they are read with their own
//   strides: (N, 3) rows (the node, prep) touch one sector or two, a
//   (3, N) table three.
// Sums are taken in one fixed order (a lane sums its C neighbours, then
// the butterfly), and the two layouts give the same bits.
//
// The centred entry (dc_gather_moments_centred, the gather engine's
// differentiable forward) runs each row twice: the first pass as above,
// the second about the first pass's mean instead of the first contributor,
// so that the covariance is summed about the mean as the plain version's
// two passes sum it. Its float32 rounding then matches the plain
// version's: on the loss offset's local graph of the bench slice (K 40,
// neighbours up to 0.14 m from their mean; an H100 80GB HBM3 at 700 W)
// the single pass moved the loss at w = 0 by 1.21e-5 of float64, the two
// passes by 6.46e-6, the plain float32 version by 6.29e-6. The second
// pass reads the row again (from L1 / L2): 1.7x the single pass's time.
//
// Numerics: index -1 and indices outside [0, N) contribute nothing; so
// does a zero weight. w_sum = max(sum w, 1e-12), the normaliser
// max(sum w - 1, 1e-6), as in features.py; a row with no contributor has
// shift 0, so its mean is 0. The kernel allocates nothing; the wrapper
// allocates outputs and the packed table.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kNone = 1 << 30;  // no contributor in the pass

template <bool kPacked>
__device__ __forceinline__ void load_point(const float* __restrict__ pts, long long sp,
                                           long long sc, int i, float& x, float& y, float& z) {
  if (kPacked) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(pts) + i);
    x = v.x;
    y = v.y;
    z = v.z;
  } else {
    const float* p = pts + i * sp;
    x = __ldg(p);
    y = __ldg(p + sc);
    z = __ldg(p + 2 * sc);
  }
}

template <int G, int C, bool kPacked, bool kCentred>
__global__ void __launch_bounds__(kThreads) gather_moments_kernel(
    const float* __restrict__ pts,   // point i, component c at pts[i * sp + c * sc]; packed: (N, 4)
    long long sp, long long sc, int n_pts,
    const int* __restrict__ idx,     // (mq, k) neighbour indices, -1 padded
    const float* __restrict__ w,     // (mq, k) weights
    int mq, int k,
    float* __restrict__ mean,        // (3, mq)
    float* __restrict__ comps,       // (6, mq)
    float* __restrict__ wsum) {      // (mq,)
  const int g = threadIdx.x & (G - 1);
  const int row = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  // A lane of a row past mq loads nothing but still takes part in the
  // group's and the warp's shuffles.
  const bool live = row < mq;
  const int* ri = idx + static_cast<size_t>(row) * k;
  const float* rw = w + static_cast<size_t>(row) * k;

  float sx = 0.f, sy = 0.f, sz = 0.f;
  bool found = false;  // uniform across the row's group
  float a[10];
  // One pass, or two in the centred form: the second about the first's mean.
  for (int pass = 0; pass < (kCentred ? 2 : 1); ++pass) {
    if (pass == 1 && found) {
      const float s0 = fmaxf(a[0], 1e-12f);
      sx += a[1] / s0;
      sy += a[2] / s0;
      sz += a[3] / s0;
    }
#pragma unroll
    for (int c = 0; c < 10; ++c) a[c] = 0.f;
    for (int base = 0; base < k; base += G * C) {  // uniform across the warp
      int id[C];
      float wt[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const int j = base + q * G + g;
        id[q] = -1;
        wt[q] = 0.f;
        if (live && j < k) {
          id[q] = __ldg(ri + j);
          wt[q] = __ldg(rw + j);
        }
      }
      bool ok[C];
      float x[C], y[C], z[C];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        ok[q] = id[q] >= 0 && id[q] < n_pts && wt[q] != 0.f;
        x[q] = y[q] = z[q] = 0.f;
        if (ok[q]) load_point<kPacked>(pts, sp, sc, id[q], x[q], y[q], z[q]);
      }
      // The shift, in the first pass that has a contributor: the group's
      // smallest neighbour position q * G + g among the lanes' first
      // contributors.
      if (__any_sync(kFull, !found)) {
        int key = kNone;
        float fx = 0.f, fy = 0.f, fz = 0.f;
#pragma unroll
        for (int q = C - 1; q >= 0; --q) {
          if (ok[q]) {
            key = q * G + g;
            fx = x[q];
            fy = y[q];
            fz = z[q];
          }
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) key = min(key, __shfl_xor_sync(kFull, key, off));
        const int src = key & (G - 1);
        fx = __shfl_sync(kFull, fx, src, G);
        fy = __shfl_sync(kFull, fy, src, G);
        fz = __shfl_sync(kFull, fz, src, G);
        if (!found && key != kNone) {
          sx = fx;
          sy = fy;
          sz = fz;
          found = true;
        }
      }
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (ok[q]) {
          const float dx = x[q] - sx, dy = y[q] - sy, dz = z[q] - sz;
          const float wx = wt[q] * dx, wy = wt[q] * dy, wz = wt[q] * dz;
          a[0] += wt[q];
          a[1] += wx;
          a[2] += wy;
          a[3] += wz;
          a[4] += wx * dx;
          a[5] += wy * dy;
          a[6] += wz * dz;
          a[7] += wx * dy;
          a[8] += wx * dz;
          a[9] += wy * dz;
        }
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < 10; ++c) a[c] += __shfl_xor_sync(kFull, a[c], off);
    }
  }
  if (live && g == 0) {
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

// (N, 4) float4 rows (x, y, z, 0) from points with strides (sp, sc).
__global__ void pack_points_kernel(const float* __restrict__ pts, long long sp, long long sc,
                                   int n_pts, float4* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_pts) {
    const float* p = pts + i * sp;
    packed[i] = make_float4(p[0], p[sc], p[2 * sc], 0.f);
  }
}

template <int G, int C, bool kCentred = false>
void launch(const float* pts, long long sp, long long sc, int n_pts, bool packed,
            const int* idx, const float* w, int mq, int k, float* mean, float* comps,
            float* wsum, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int blocks = (mq + kRowsPerBlock - 1) / kRowsPerBlock;
  if (packed)
    gather_moments_kernel<G, C, true, kCentred><<<blocks, kThreads, 0, stream>>>(
        pts, 4, 1, n_pts, idx, w, mq, k, mean, comps, wsum);
  else
    gather_moments_kernel<G, C, false, kCentred><<<blocks, kThreads, 0, stream>>>(
        pts, sp, sc, n_pts, idx, w, mq, k, mean, comps, wsum);
}

template <bool kCentred>
int run(const void* pts, long long sp, long long sc, int n_pts, const void* idx, const void* w,
        int mq, int k, void* mean, void* comps, void* wsum, void* packed, void* stream) {
  if (mq > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* src = static_cast<const float*>(pts);
    const bool pk = packed != nullptr && n_pts > 0;
    if (pk) {
      pack_points_kernel<<<(n_pts + 255) / 256, 256, 0, s>>>(src, sp, sc, n_pts,
                                                             static_cast<float4*>(packed));
      src = static_cast<const float*>(packed);
    }
    const int* ix = static_cast<const int*>(idx);
    const float* wt = static_cast<const float*>(w);
    float* m = static_cast<float*>(mean);
    float* c = static_cast<float*>(comps);
    float* ws = static_cast<float*>(wsum);
    // Lanes a row by K: the fastest grouping on an H100 at K 32, 48, 88
    // and 168 (scripts/exp_gather_variants.py).
    if (k <= 32)
      launch<4, 8, kCentred>(src, sp, sc, n_pts, pk, ix, wt, mq, k, m, c, ws, s);
    else if (k <= 64)
      launch<8, 8, kCentred>(src, sp, sc, n_pts, pk, ix, wt, mq, k, m, c, ws, s);
    else
      launch<16, 8, kCentred>(src, sp, sc, n_pts, pk, ix, wt, mq, k, m, c, ws, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// packed: null, or an (n_pts, 4) float32 scratch table (16-byte aligned)
// that is filled first and then read in place of pts. Launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError()
// (0 = the launches were accepted).
int dc_gather_moments(const void* pts, long long sp, long long sc, int n_pts,
                      const void* idx, const void* w, int mq, int k,
                      void* mean, void* comps, void* wsum, void* packed, void* stream) {
  return run<false>(pts, sp, sc, n_pts, idx, w, mq, k, mean, comps, wsum, packed, stream);
}

// The centred form (two passes a row, the second about the mean); the
// arguments and contract of dc_gather_moments.
int dc_gather_moments_centred(const void* pts, long long sp, long long sc, int n_pts,
                              const void* idx, const void* w, int mq, int k,
                              void* mean, void* comps, void* wsum, void* packed,
                              void* stream) {
  return run<true>(pts, sp, sc, n_pts, idx, w, mq, k, mean, comps, wsum, packed, stream);
}

}  // extern "C"
