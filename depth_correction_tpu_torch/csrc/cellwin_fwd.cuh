// The cell-window forward body (K1), as a template over compile-time
// knockouts, and what K1 and K2 (csrc/cellwin.cu) share: the staging of a
// tile's window, the membership distance and the warp's box test.
// csrc/cellwin.cu instantiates kFull as K1; csrc/cellwin_knockout.cu
// instantiates every mode for the knockout probe (P1). kFull is K1's code
// itself, so P1's `full` is bit-equal to K1 on the same inputs.
//
// K1 replaces the Pallas kernel depth_correction_tpu/ops/cellwin.py:
// _fwd_kernel. A body in which every thread tests every staged window
// entry is bound by instruction issue, ~30 issued warp-instructions per
// (warp, staged entry) step, and not by its loads (P1, PERF.md §6). This
// body issues fewer:
// - Each warp culls its window. A lane tests one window entry against the
//   axis-aligned box of the warp's REAL rows; a ballot gives the warp its
//   kept entries, which the lanes write, packed and in ascending order, to
//   the warp's buffer in shared memory; the warp then walks the buffer with
//   a warp-uniform counted loop (no divergence; unrolled, so the loads of
//   several entries overlap). On the bench slice's table the cull keeps
//   about 42% of K1's pair tests and 40% of K2's (chip_smoke.py prints
//   `pairs_kept`, counted by the host model scripts/cellwin_cull.py;
//   PERF.md §6).
// - The payload of an entry (current x, y, z; K2: the nine cotangents) is
//   read from device memory only when the entry is kept, and the walk reads
//   it as one 16-byte and one 8-byte load (K2: three 16-byte loads).
// - Warps work alone: a warp reads its own tile's window, with no block
//   barrier, so a warp whose box keeps much does not hold back the others.
// What bounds it now: issue per kept pair test and per member step, and
// the latency between them (PERF.md §6 attributes K1's time with P1).
//
// Why the cull loses no member (it is conservative by construction, with
// no margin): the box of the real rows, [lo, hi] per axis, is taken over
// the same tile-centred float32 values q that the pair test subtracts, and
// an entry e's gap to it, max(lo - e, 0, e - hi), goes through the same
// rounded operations as the pair test's difference. Rounding is monotone,
// so every real row q in the box has |fl(e - q)| >= fl(gap) per axis; the
// distance box_d2 is then the pair test's own sequence (d2_form) on the
// three gaps, and fmul and fma with non-negative addends are monotone too,
// so box_d2 <= d2 of every real row. An entry with box_d2 > r2 fails
// every real row's test. Padding rows (q_est at the builder's -1e15
// sentinel; K2: padding points at +1e15) are left out of the box, since
// they would widen it to the whole scene; the builder places no point
// within r of them, so they have no member to lose. A warp with no real
// row reads nothing.
//
// Numerics (the culled entries fail every test, so the sums are those of
// testing every entry; the kept ones are added in one fixed order, spans
// in order and entries ascending):
// - Membership d2 <= r2 in the difference form on tile-centred
//   coordinates, d2 = fma(dz, dz, fma(dx, dx, dy * dy)): the sequence nvcc
//   gives `dx * dx + dy * dy + dz * dz` (PTX mul, fma, fma; checked in the
//   SASS), written with explicit round-to-nearest intrinsics. The host
//   builder's exactness audit (eps_rel 2e-5 of r^2, FMA included) covers
//   this form only; never the expansion |q|^2 + |x|^2 - 2 q.x.
// - K1 sums about each row's own establishment position (below).
// - Non-members are SELECTED out (a branch), never multiplied by a zero
//   weight: padding entries carry the far sentinels +-1e15.
// - Every read is bounded by the raw span length; no atomics, and each
//   output element has one writer.
// The knockout modes without the cull (kNoD2, kEmpty, kNoCull) keep every
// entry; kEmpty reads every entry's payload and walks nothing.
//
// The knockout modes, each the Hopper meaning of a knockout of
// scripts/exp_cellwin_knockout.py (the TPU probe's docstring :9-16):
//   kFull     K1: cull, membership test, row-centred moment sums, epilogue.
//   kNoD2     no cull and no membership test: every staged entry of a span
//             is a member.
//   kNoFeats  constant features: every sum is the member count.
//   kNoDot    the member count alone, without the nine multiply-adds.
//   kNoMask   no per-slot select: the ten sums take a {0, 1} weight times
//             each term of every kept entry, so the d2 test against the
//             +-1e15 padding alone keeps padding out.
//   kEmpty    stage every span into shared memory and write q, nothing
//             else: the floor set by the grid, the staging and the loads.
//   kNoCull   K1 with the ballot forced to keep every entry: the output
//             equals kFull's bit for bit, and the time it adds to kFull's
//             is what the cull buys.
// kNoD2, kNoFeats, kNoDot and kNoMask write the raw sums a0..a9 (kEmpty:
// q_est's x, y, z and zeros) and skip the epilogue; kNoCull writes kFull's
// output. The TPU probe's dot1, kcat1 and kcat3 are arrangements of the
// matrix unit's dot; K1 on this card has no dot, so their question is
// asked of the tensor-core moment product instead (csrc/moment_dot.cu,
// csrc/moment_window.cu).

#pragma once
#include <cuda_runtime.h>

namespace {

enum CellwinMode {
  kFull = 0, kNoD2 = 1, kNoFeats = 2, kNoDot = 3, kNoMask = 4, kEmpty = 5, kNoCull = 6
};

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
// Warps per block. Each warp works alone (its own rows, buffer and span
// table, no block barrier); a block of several lets more warps share an SM.
constexpr int kWarpsPerBlock = 4;
// Kept window entries a warp buffers in shared memory before it walks
// them: K1's entries take 24 bytes, K2's 48.
constexpr int kFwdBuf = 128;
constexpr int kBwdBuf = 64;
// The builder's padding sentinels: rows at -1e15, points at +1e15.
constexpr float kRowPad = -1e15f;
constexpr float kPointPad = 1e15f;

// The membership distance, in the sequence nvcc gives dx*dx + dy*dy + dz*dz.
__device__ __forceinline__ float d2_form(float dx, float dy, float dz) {
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// The gap from the entry coordinate e to [lo, hi], through the same
// rounded subtraction as the pair test's e - q (or q - e: rounding to
// nearest is symmetric).
__device__ __forceinline__ float box_gap(float e, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, e), 0.f), __fsub_rn(e, hi));
}

// The box of the warp's real values: lo and hi per axis over the lanes
// with `real`; lo = +inf and hi = -inf when no lane is real.
struct WarpBox {
  float lo[3], hi[3];
};

__device__ __forceinline__ WarpBox warp_box(const float v[3], bool real) {
  WarpBox b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = real ? v[a] : __int_as_float(0x7f800000);
    float hi = real ? v[a] : __int_as_float(0xff800000);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kAll, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(kAll, hi, off));
    }
    b.lo[a] = lo;
    b.hi[a] = hi;
  }
  return b;
}

// True when the entry (ex, ey, ez) may lie within r of a real value of the
// box (box_d2 <= r2); false only when it lies farther from every one.
__device__ __forceinline__ bool box_keeps(const WarpBox& b, float ex, float ey, float ez,
                                          float r2) {
  return d2_form(box_gap(ex, b.lo[0], b.hi[0]), box_gap(ey, b.lo[1], b.hi[1]),
                 box_gap(ez, b.lo[2], b.hi[2])) <= r2;
}

// This thread's work: the warps of the launch take the tiles' slots in
// order, 32 to a warp (a tile of `cap` slots takes ceil(cap / 32) warps);
// `t` is the thread's tile, `slot` its slot there, and `t` is -1 for a
// warp past the last tile.
struct WarpTask {
  int t, slot;
};

__device__ __forceinline__ WarpTask warp_task(int tiles, int cap) {
  const int per_tile = (cap + kWarp - 1) / kWarp;
  const int gw = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (gw >= tiles * per_tile) return {-1, 0};
  return {gw / per_tile, (gw % per_tile) * kWarp + static_cast<int>(threadIdx.x) % kWarp};
}

// Shared memory of one warp: `buf` kept entries of `entry_bytes` and the
// span table (ns starts, ns + 1 offsets), rounded up to 16 bytes.
__host__ __device__ __forceinline__ size_t warp_smem(int buf, int entry_bytes, int ns) {
  const size_t bytes = static_cast<size_t>(buf) * entry_bytes +
                       (2 * static_cast<size_t>(ns) + 1) * sizeof(int);
  return (bytes + 15) / 16 * 16;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: above the
// default 48 KB (the span table grows with ns, 8 bytes a mini-span per
// warp) it opts in, up to the card's limit (227 KB on sm_90, ~6,900
// mini-spans a tile); past that it returns cudaErrorInvalidValue, which the
// launch returns.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Blocks of kWarpsPerBlock warps for `tiles` tiles of `cap` slots.
inline int warp_blocks(int tiles, int cap) {
  const int warps = tiles * ((cap + kWarp - 1) / kWarp);
  return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// The warp's copy of its tile's span table: s_start[s] and the offset
// s_pre[s] of span s in the window, its spans back to back (s_pre[ns] is
// the window's length; negative lengths count as empty).
__device__ __forceinline__ void warp_spans(const int* starts, const int* lens, int ns,
                                           int* s_start, int* s_pre) {
  const int lane = threadIdx.x % kWarp;
  int carry = 0;
  for (int b = 0; b < ns; b += kWarp) {
    const int s = b + lane;
    const int len = s < ns ? max(lens[s], 0) : 0;
    int incl = len;  // inclusive scan over the lanes
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl += v;
    }
    if (s < ns) {
      s_start[s] = starts[s];
      s_pre[s] = carry + incl - len;
    }
    carry += __shfl_sync(kAll, incl, kWarp - 1);
  }
  if (lane == 0) s_pre[ns] = carry;
  __syncwarp();
}

// The span holding window entry idx < s_pre[ns], searched forward from
// span s, which holds an earlier entry (empty spans are passed over).
__device__ __forceinline__ int span_of(const int* s_pre, int s, int idx) {
  while (s_pre[s + 1] <= idx) ++s;
  return s;
}

// One warp per 32 rows of a row tile (a tile of row_cap rows takes
// ceil(row_cap / 32) warps), one lane per query row; each warp reads its
// tile's window in rounds of 32 entries, keeps those its box test passes
// (every entry in the modes without the cull), buffers them in its shared
// memory, ascending, and walks the buffer whenever the next round might
// not fit and at the end.
// out rows (kFull): mean x, y, z (shifted back), cov 00, 11, 22, 01, 02, 12,
// and w_sum = max(s0, 1e-12) — the epilogue of the TPU kernel. Unlike the
// TPU kernel, the sums are taken about each row's own establishment
// position instead of the tile centre: a tile's z-run can span metres,
// and sums of squares of metre-scale coordinates lose ~1e-5 m^2 of a
// two-neighbour covariance in f32, where row-centred ones stay below 1e-7.
template <int MODE>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock) cellwin_fwd_kernel(
    const float* __restrict__ pts,    // (m_pad, 3) current positions
    const float* __restrict__ est,    // rows x, y, z of a (., m_pad) table
    int m_pad,
    const float* __restrict__ q_est,  // rows x, y, z of a (., mq_pad) table
    int mq_pad,
    const int* __restrict__ f_start,  // (t1, ns) span starts (point axis)
    const int* __restrict__ f_len,    // (t1, ns) span lengths
    const float* __restrict__ f_ctr,  // (t1, 3) tile centres
    int t1, int ns, int row_cap, float r2,
    float* __restrict__ out) {        // (10, mq_pad)
  constexpr bool kCull = MODE != kNoD2 && MODE != kEmpty && MODE != kNoCull;
  extern __shared__ float4 smem4[];
  const WarpTask task = warp_task(t1, row_cap);
  if (task.t < 0) return;  // past the last tile: no barrier follows
  // The warp's shared memory: tile-centred est x, y, z and current x, and
  // current y, z of the kept entries, then the span table.
  float4* s_a = reinterpret_cast<float4*>(
      reinterpret_cast<char*>(smem4) +
      threadIdx.x / kWarp * warp_smem(kFwdBuf, sizeof(float4) + sizeof(float2), ns));
  float2* s_b = reinterpret_cast<float2*>(s_a + kFwdBuf);
  int* s_start = reinterpret_cast<int*>(s_b + kFwdBuf);
  int* s_pre = s_start + ns;

  const int lane = threadIdx.x % kWarp;
  const int t = task.t;
  const int slot = task.slot;
  const bool has_row = slot < row_cap;  // the tile's last warp may be partial
  const int row = t * row_cap + slot;
  const float cx = f_ctr[3 * t + 0];
  const float cy = f_ctr[3 * t + 1];
  const float cz = f_ctr[3 * t + 2];
  // A lane without a row sits at the padding sentinel: it has no member.
  const float q0 = has_row ? q_est[row] : kRowPad;
  const float qx = q0 - cx;
  const float qy = (has_row ? q_est[mq_pad + row] : kRowPad) - cy;
  const float qz = (has_row ? q_est[2 * mq_pad + row] : kRowPad) - cz;
  warp_spans(f_start + t * ns, f_len + t * ns, ns, s_start, s_pre);

  WarpBox box;
  bool any_real = true;
  if constexpr (kCull) {
    const float q[3] = {qx, qy, qz};
    const bool real = q0 != kRowPad;
    box = warp_box(q, real);
    any_real = __any_sync(kAll, real);
  }

  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
  float a5 = 0.f, a6 = 0.f, a7 = 0.f, a8 = 0.f, a9 = 0.f;
  auto visit = [&](int k) {
    const float4 e = s_a[k];
    if constexpr (MODE == kNoD2) {
      const float2 e12 = s_b[k];
      const float x0 = e.w - qx;
      const float x1 = e12.x - qy;
      const float x2 = e12.y - qz;
      a0 += 1.f;
      a1 += x0;
      a2 += x1;
      a3 += x2;
      a4 += x0 * x0;
      a5 += x1 * x1;
      a6 += x2 * x2;
      a7 += x0 * x1;
      a8 += x0 * x2;
      a9 += x1 * x2;
      return;
    }
    const float d2 = d2_form(__fsub_rn(e.x, qx), __fsub_rn(e.y, qy), __fsub_rn(e.z, qz));
    if constexpr (MODE == kNoMask) {
      const float2 e12 = s_b[k];
      const float w1 = d2 <= r2 ? 1.f : 0.f;
      const float x0 = e.w - qx;
      const float x1 = e12.x - qy;
      const float x2 = e12.y - qz;
      const float v0 = w1 * x0;
      const float v1 = w1 * x1;
      const float v2 = w1 * x2;
      a0 += w1;
      a1 += v0;
      a2 += v1;
      a3 += v2;
      a4 += v0 * x0;
      a5 += v1 * x1;
      a6 += v2 * x2;
      a7 += v0 * x1;
      a8 += v0 * x2;
      a9 += v1 * x2;
    } else if (d2 <= r2) {
      if constexpr (MODE == kNoFeats) {
        a0 += 1.f; a1 += 1.f; a2 += 1.f; a3 += 1.f; a4 += 1.f;
        a5 += 1.f; a6 += 1.f; a7 += 1.f; a8 += 1.f; a9 += 1.f;
      } else if constexpr (MODE == kNoDot) {
        a0 += 1.f;
      } else {
        // Row-centred current coordinates: every member lies within r of
        // the row, so |x| <= ~r and the f32 sums of squares stay small.
        const float2 e12 = s_b[k];
        const float x0 = e.w - qx;
        const float x1 = e12.x - qy;
        const float x2 = e12.y - qz;
        a0 += 1.f;
        a1 += x0;
        a2 += x1;
        a3 += x2;
        a4 += x0 * x0;
        a5 += x1 * x1;
        a6 += x2 * x2;
        a7 += x0 * x1;
        a8 += x0 * x2;
        a9 += x1 * x2;
      }
    }
  };
  const int total = any_real ? s_pre[ns] : 0;  // a warp with no real row reads nothing
  const unsigned below = (1u << lane) - 1u;
  int s = 0;  // the span of the next round's first entry
  for (int b = 0; b < total;) {
    // Fill the buffer while a round of 32 still fits, then walk it.
    int cnt = 0;
    for (; b < total && cnt <= kFwdBuf - kWarp; b += kWarp) {
      const int idx = b + lane;
      bool keep = false;
      float4 ea;
      float2 eb;
      int sl = s;
      if (idx < total) {
        sl = span_of(s_pre, s, idx);
        const int j = s_start[sl] + (idx - s_pre[sl]);
        ea.x = est[j] - cx;
        ea.y = est[m_pad + j] - cy;
        ea.z = est[2 * m_pad + j] - cz;
        if constexpr (kCull) {
          keep = box_keeps(box, ea.x, ea.y, ea.z, r2);
        } else {
          keep = true;
        }
        if (keep) {
          ea.w = pts[3 * j + 0] - cx;
          eb = make_float2(pts[3 * j + 1] - cy, pts[3 * j + 2] - cz);
        }
      }
      s = __shfl_sync(kAll, sl, kWarp - 1);
      const unsigned m = __ballot_sync(kAll, keep);
      if (keep) {
        const int pos = cnt + __popc(m & below);
        s_a[pos] = ea;
        s_b[pos] = eb;
      }
      cnt += __popc(m);
    }
    __syncwarp();
    if constexpr (MODE == kEmpty) {
      asm volatile("" ::: "memory");  // the staged stores stay
    } else {
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) visit(k);  // the buffered entries, ascending
    }
    __syncwarp();  // the buffer is read before the next fill
  }

  if (!has_row) return;
  if constexpr (MODE == kFull || MODE == kNoCull) {
    const float s0c = fmaxf(a0, 1e-12f);
    const float m0 = a1 / s0c;
    const float m1 = a2 / s0c;
    const float m2 = a3 / s0c;
    const float denom = fmaxf(a0 - 1.f, 1e-6f);
    out[0 * mq_pad + row] = (m0 + qx) + cx;
    out[1 * mq_pad + row] = (m1 + qy) + cy;
    out[2 * mq_pad + row] = (m2 + qz) + cz;
    out[3 * mq_pad + row] = (a4 - a0 * m0 * m0) / denom;
    out[4 * mq_pad + row] = (a5 - a0 * m1 * m1) / denom;
    out[5 * mq_pad + row] = (a6 - a0 * m2 * m2) / denom;
    out[6 * mq_pad + row] = (a7 - a0 * m0 * m1) / denom;
    out[7 * mq_pad + row] = (a8 - a0 * m0 * m2) / denom;
    out[8 * mq_pad + row] = (a9 - a0 * m1 * m2) / denom;
    out[9 * mq_pad + row] = s0c;
  } else if constexpr (MODE == kEmpty) {
    out[0 * mq_pad + row] = q_est[row];
    out[1 * mq_pad + row] = q_est[mq_pad + row];
    out[2 * mq_pad + row] = q_est[2 * mq_pad + row];
    for (int c = 3; c < 10; ++c) out[c * mq_pad + row] = 0.f;
  } else {
    out[0 * mq_pad + row] = a0;
    out[1 * mq_pad + row] = a1;
    out[2 * mq_pad + row] = a2;
    out[3 * mq_pad + row] = a3;
    out[4 * mq_pad + row] = a4;
    out[5 * mq_pad + row] = a5;
    out[6 * mq_pad + row] = a6;
    out[7 * mq_pad + row] = a7;
    out[8 * mq_pad + row] = a8;
    out[9 * mq_pad + row] = a9;
  }
}

// Launches mode MODE on the caller's stream; returns cudaGetLastError().
template <int MODE>
int launch_cellwin_fwd_mode(const void* pts, const void* est, int m_pad,
                            const void* q_est, int mq_pad, const void* f_start,
                            const void* f_len, const void* f_ctr, int t1, int ns,
                            int row_cap, float r2, void* out, void* stream) {
  if (t1 > 0) {
    const size_t smem =
        kWarpsPerBlock * warp_smem(kFwdBuf, sizeof(float4) + sizeof(float2), ns);
    const cudaError_t err = allow_smem(cellwin_fwd_kernel<MODE>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cellwin_fwd_kernel<MODE><<<warp_blocks(t1, row_cap), kWarp * kWarpsPerBlock, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(est), m_pad,
        static_cast<const float*>(q_est), mq_pad,
        static_cast<const int*>(f_start), static_cast<const int*>(f_len),
        static_cast<const float*>(f_ctr), t1, ns, row_cap, r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
