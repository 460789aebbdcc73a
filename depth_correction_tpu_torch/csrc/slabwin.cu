// Slab-window neighbourhood moments (X1) for Hopper (sm_90a), with a plain
// C interface loaded through ctypes by depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the XLA lax.scan engine depth_correction_tpu/ops/slabwin.py:
// slab_window_moments (the online corrector's large-scan engine). Its plain
// torch version is slab_window_moments_plain in
// depth_correction_tpu_torch/ops/slabwin.py, which also computes the spans.
//
// Input: a column-aligned cell-sorted scan (ops/grid_hash.py), cut into
// tiles of 128 slots. Every within-r neighbour of a tile's rows lies in
// three contiguous ranges of the sorted table, [lo_s, lo_s + width_s) for
// s = 0, 1, 2 (the tile's y-window inside the major slabs x-1, x, x+1; a
// column-straddling tile has one whole-slab range and two empty ones).
//
// Design (K1's, csrc/cellwin_fwd.cuh):
// - One block per 128-slot tile, four warps of 32 rows, one thread per row
//   with its ten sums in registers. Warps work alone: each reads its own
//   tile's three spans, with no block barrier, so a warp whose rows keep
//   much does not hold back the others.
// - Each warp culls. A lane tests one span entry against the axis-aligned
//   box of the warp's VALID rows (padding rows at 1e15 and rows the filters
//   dropped are left out: they have no member), on the tile-centred float32
//   values the pair test subtracts.
// - Ballot and pack: the kept entries are written, packed, ascending and
//   span by span, to the warp's buffer in shared memory; the warp walks the
//   buffer with a warp-uniform counted loop. An entry's position is read
//   only if it is valid, and the walk reads it from the buffer.
// - What bounds it: issue per kept pair test and per member step; the
//   bound in chip_smoke.py charges the pair tests and box tests that the
//   host model of the cull (scripts/slab_cull.py) counts.
//
// Why the cull loses no member (conservative by construction, no margin):
// the pair test here has NO fused multiply-add, d2 = fadd(fadd(fmul(dx,
// dx), fmul(dy, dy)), fmul(dz, dz)) with dx = fl(e - q), unlike K1's FMA
// form, so the box distance uses this same sequence. The box [lo, hi] is
// taken over the same tile-centred values q; an entry's gap per axis,
// max(lo - e, 0, e - hi), goes through the same rounded subtraction, and
// rounding is monotone, so |fl(e - q)| >= fl(gap) for every q in the box;
// fmul and fadd of non-negative values are monotone, so box_d2 <= d2 of
// every valid row. An entry with box_d2 > r2 fails every valid row's test.
// The kept entries are added in one fixed order (spans in order, entries
// ascending), so the output is, bit for bit, that of testing every entry.
//
// Numerics:
// - Membership keeps the TPU engine's per-pair arithmetic: d = (x - ctr) -
//   (q - ctr) on tile-centred coordinates, d2 = dx*dx + dy*dy + dz*dz with
//   no fused multiply-add, so membership equals the plain version's in f32.
// - The sums are taken about the row's own position (d itself), not the
//   tile centre: a tile's rows can lie metres apart, and f32 sums of squares
//   of metre-scale coordinates lose ~1e-6 m^2 of a covariance, where members
//   within r of the row keep the error near 1e-8 m^2.
// - Non-members are branched over, never multiplied by a zero weight:
//   padding slots sit at 1e15.
// - Every read is bounded by the span's own length, so the TPU engine's
//   static span width w_slab, its retry and its two width classes are not
//   needed. No atomics: each output is written by one thread.
// The kernel allocates nothing; the Python wrapper allocates the output.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kWarp = 32;
constexpr int kWarps = kTile / kWarp;
constexpr unsigned kAll = 0xffffffffu;
// Kept span entries a warp buffers in shared memory before it walks them.
constexpr int kBuf = 128;

// The pair test's distance: no fused multiply-add.
__device__ __forceinline__ float d2_form(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The gap from the entry coordinate e to [lo, hi], through the pair test's
// rounded subtraction (rounding to nearest is symmetric: fl(q - e) =
// -fl(e - q)).
__device__ __forceinline__ float box_gap(float e, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, e), 0.f), __fsub_rn(e, hi));
}

// lo and hi of v over the lanes with `real` (+inf and -inf when none is).
__device__ __forceinline__ void warp_range(float v, bool real, float& lo, float& hi) {
  lo = real ? v : __int_as_float(0x7f800000);
  hi = real ? v : __int_as_float(0xff800000);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kAll, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kAll, hi, off));
  }
}

// One block per 128-slot tile, one thread per slot, each warp alone. out
// rows: mean x, y, z; covariance 00, 11, 22, 01, 02, 12 (Bessel, normaliser
// max(s0 - 1, 1e-6)); w_sum = max(s0, 0). A tile with no valid row writes
// zeros.
__global__ void __launch_bounds__(kTile) slab_window_kernel(
    const float* __restrict__ pts,            // (3, n) sorted positions
    const unsigned char* __restrict__ valid,  // (n,) 0/1
    int n,
    const int* __restrict__ lo,               // (t, 3) span starts
    const int* __restrict__ width,            // (t, 3) span lengths
    const float* __restrict__ ctr,            // (t, 3) tile centres
    float r2,
    float* __restrict__ out) {                // (10, n)
  __shared__ float4 s_buf[kWarps][kBuf];

  const int t = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  float4* buf = s_buf[threadIdx.x / kWarp];
  const int row = t * kTile + threadIdx.x;
  // Whether the tile holds a valid row, by each warp alone: a lane reads 4
  // of the tile's 128 validity bytes.
  const unsigned char* tv = valid + t * kTile + 4 * lane;
  if (!__any_sync(kAll, (tv[0] | tv[1] | tv[2] | tv[3]) != 0)) {
#pragma unroll
    for (int c = 0; c < 10; ++c) out[c * n + row] = 0.f;
    return;
  }
  const bool qv = valid[row] != 0;
  const float cx = ctr[3 * t + 0];
  const float cy = ctr[3 * t + 1];
  const float cz = ctr[3 * t + 2];
  const float qx = pts[row] - cx;
  const float qy = pts[n + row] - cy;
  const float qz = pts[2 * n + row] - cz;

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
  float a5 = 0.f, a6 = 0.f, a7 = 0.f, a8 = 0.f, a9 = 0.f;
  if (__any_sync(kAll, qv)) {  // a warp without a valid row reads nothing
    float bx0, bx1, by0, by1, bz0, bz1;
    warp_range(qx, qv, bx0, bx1);
    warp_range(qy, qv, by0, by1);
    warp_range(qz, qv, bz0, bz1);
    // The three spans back to back: [0, p1) span 0, [p1, p2) span 1,
    // [p2, total) span 2.
    const int s0 = lo[3 * t + 0], s1 = lo[3 * t + 1], s2 = lo[3 * t + 2];
    const int p1 = max(width[3 * t + 0], 0);
    const int p2 = p1 + max(width[3 * t + 1], 0);
    const int total = p2 + max(width[3 * t + 2], 0);
    const unsigned below = (1u << lane) - 1u;
    for (int b = 0; b < total;) {
      // Fill the buffer while a round of 32 still fits, then walk it.
      int cnt = 0;
      for (; b < total && cnt <= kBuf - kWarp; b += kWarp) {
        const int idx = b + lane;
        bool keep = false;
        float4 e;
        if (idx < total) {
          const int j = idx < p1 ? s0 + idx : (idx < p2 ? s1 + (idx - p1) : s2 + (idx - p2));
          if (valid[j]) {
            e.x = pts[j] - cx;
            e.y = pts[n + j] - cy;
            e.z = pts[2 * n + j] - cz;
            e.w = 0.f;
            keep = d2_form(box_gap(e.x, bx0, bx1), box_gap(e.y, by0, by1),
                           box_gap(e.z, bz0, bz1)) <= r2;
          }
        }
        const unsigned kept = __ballot_sync(kAll, keep);
        if (keep) buf[cnt + __popc(kept & below)] = e;
        cnt += __popc(kept);
      }
      __syncwarp();
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {  // the buffered entries, ascending
        const float4 e = buf[k];
        const float dx = e.x - qx;
        const float dy = e.y - qy;
        const float dz = e.z - qz;
        const float d2 = d2_form(dx, dy, dz);
        if (qv && d2 <= r2) {
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
      __syncwarp();  // the buffer is read before the next fill
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
int dc_slab_window(const void* pts, const void* valid, int n, const void* lo,
                   const void* width, const void* ctr, int t, float r2,
                   void* out, void* stream) {
  if (t > 0) {
    slab_window_kernel<<<t, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const unsigned char*>(valid),
        n, static_cast<const int*>(lo), static_cast<const int*>(width),
        static_cast<const float*>(ctr), r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
