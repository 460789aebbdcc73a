// The moment product's precision probe (P2) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes by
// depth_correction_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas probe scripts/exp_mosaic_dot_probe.py:main.kernel: on
// every one of T1 grid steps, sum over NS spans the product a_s @ b_s of a
// (16, S) float32 feature block and an (S, 128) right-hand side that is
// exactly {0, 1} (the membership matrix of the cell-window kernels). Its
// plain torch version is moment_dot_plain in
// depth_correction_tpu_torch/ops/moment_dot.py.
//
// Precision variants (tf32_mma.cuh) and the TPU variants they stand for:
//   fp32    float32 FMAs, no tensor cores          (TPU `highest`)
//   tf32    one TF32 pass of hi = trunc(a)          (TPU `default`, one bf16 pass)
//   tf32x2  hi + mid, two TF32 passes               (TPU `split2_cast` / `split2_bits`)
//   tf32x3  hi + mid + lo, three passes, f32-exact  (TPU `split3_bits`)
// b is truncated to TF32 as well (a no-op for {0, 1}), so every operand
// of a product is exactly TF32 and the products are exact.
//
// What bounds it on this card: the work is T1 x 2 x 16 x (NS S) x 128
// FLOPs a pass (6.7 GFLOP at the probe's shapes) against ~2 MB of inputs
// that stay in L2, so the bound is the math: 14 us a pass at the 495
// TFLOP/s TF32 peak, 0.1 ms in float32 FMAs.
//
// The design. The TPU probe read the same a and b on every grid step (its
// inputs carry no tile dimension); here one block serves kTiles = 4 tiles,
// so b crosses L2 once per 4 tiles (T1 = 512: 128 blocks, one wave), and
// every tile's (16, 128) slot is still its own sum. The spans are cut into
// chunks of 64 k (the last of a span shorter, a multiple of 8), and each
// chunk's b (64, 128) and a (16, 64) pass through a three-stage ring in
// shared memory, b by cp.async, so the next chunk's loads overlap this
// chunk's products and one barrier a chunk suffices (a stage is written
// two chunks after it was read, and every thread has passed the barrier
// of the chunk between).
//
// - TF32 variants: wgmma (Hopper's warpgroup product, the only route to the
//   TF32 rate) computes out^T = b^T a^T, since wgmma takes a .tf32 operand
//   from shared memory only K-major: a (16, S) already is, b is not. So
//   a's P TF32 components (P passes), split once per element per block as
//   the chunk is staged, are stacked along N (hi rows 0-15, mid 16-31, lo
//   32-47) as the shared-memory B operand, and one m64n(16P)k8 does all
//   passes, each in its own accumulator columns. The operand is stored in
//   the 128-byte swizzled layout, which wgmma reads faster than the
//   unswizzled one. b^T is the A operand, read from the staged chunk into
//   registers (rows padded to 136 floats: the fragment reads of a warp hit
//   32 banks) once per chunk and reused for all 4 tiles. Two warpgroups
//   take b's columns 0-63 and 64-127; each runs its 4 tiles' products on
//   two accumulator sets in turn, so one tile's wgmma chain is in flight
//   while the other's sums are added.
//   The precision scheme is v1's: the tensor core's f32 accumulation is not
//   IEEE round-to-nearest, so the accumulators restart every chunk (scale-d
//   = 0 on its first wgmma) and are added into float32 sums with ordinary
//   adds, the small passes first and the hi pass apart:
//   sum += (mid + lo) + hi.
// - fp32: FMAs in v1's order (k ascending, one sum per output), so it
//   equals v1 bit for bit. Each warp pair owns one tile; each thread keeps
//   4 columns x 8 rows in registers and reads its b quad and a's rows from
//   the staged chunk as 16-byte loads (a's are broadcasts).

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kCols = 128;   // R: the product's width
constexpr int kRows = 16;    // M: the feature rows
constexpr int kChunk = 64;   // k per chunk (and per restarted accumulator)
constexpr int kTiles = 4;    // tiles served by one block
constexpr int kThreads = 256;
constexpr int kBPitch = kCols + 8;  // the TF32 kernel's staged b rows
constexpr int kStages = 3;          // the ring of staged chunks

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Which span and k range chunk c is: spans of s_len cut into chunks of 64.
struct Chunk {
  int s, kc, len;
};

__device__ __forceinline__ Chunk chunk_of(int c, int s_len) {
  const int per_span = (s_len + kChunk - 1) / kChunk;
  const int kc = (c % per_span) * kChunk;
  return {c / per_span, kc, min(kChunk, s_len - kc)};
}

// b's rows kc .. kc + len of span s into shared rows of `pitch` floats.
template <int PITCH>
__device__ __forceinline__ void stage_b(float* sb, const float* __restrict__ b, Chunk ch,
                                        int s_len, int tid) {
  const float* src = b + (static_cast<size_t>(ch.s) * s_len + ch.kc) * kCols;
  for (int i = tid; i < ch.len * (kCols / 4); i += kThreads)
    cp_async16(sb + (i / (kCols / 4)) * PITCH + (i % (kCols / 4)) * 4, src + 4 * i);
}

// a's 16 x len block of chunk ch: thread tid takes row tid / 16, k quad
// tid % 16 (one float4), when the quad lies inside the chunk.
__device__ __forceinline__ const float* a_quad(const float* __restrict__ a, Chunk ch, int s_len,
                                               int tid) {
  const int f = tid / 16, q = tid % 16;
  if (4 * q >= ch.len) return nullptr;
  return a + (static_cast<size_t>(ch.s) * kRows + f) * s_len + ch.kc + 4 * q;
}

// ---------------------------------------------------------------------------
// fp32: float32 FMAs.

constexpr int kFpStage = kChunk * kCols + kRows * kChunk;  // floats: b (64, 128), a (16, 64)

// Stage chunk c (b and a, both by cp.async) into ring slot c % kStages.
__device__ __forceinline__ void stage_fp32(float* smem, const float* __restrict__ a,
                                           const float* __restrict__ b, int c, int s_len,
                                           int tid) {
  float* sb = smem + (c % kStages) * kFpStage;
  const Chunk ch = chunk_of(c, s_len);
  stage_b<kCols>(sb, b, ch, s_len, tid);
  if (const float* src = a_quad(a, ch, s_len, tid))
    cp_async16(sb + kChunk * kCols + (tid / 16) * kChunk + 4 * (tid % 16), src);
  cp_async_commit();
}

// Warps 2 i and 2 i + 1 own tile i of the block (rows 0-7 and 8-15); lane
// l owns columns 4 l .. 4 l + 3.
__global__ void __launch_bounds__(kThreads, 1)
    moment_dot_fp32(const float* __restrict__ a,  // (ns, 16, S)
                    const float* __restrict__ b,  // (ns, S, 128)
                    int ns, int s_len, int n_tiles,
                    float* __restrict__ out) {    // (16, 128 n_tiles)
  extern __shared__ __align__(1024) float smem[];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x * kTiles + tid / 64;
  const int f0 = 8 * ((tid / 32) % 2);
  const int lane = tid % 32;
  const int nc = ns * ((s_len + kChunk - 1) / kChunk);
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  stage_fp32(smem, a, b, 0, s_len, tid);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      stage_fp32(smem, a, b, c + 1, s_len, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sb = smem + (c % kStages) * kFpStage;
    const float* sa = sb + kChunk * kCols + f0 * kChunk;
    const int len = chunk_of(c, s_len).len;
#pragma unroll 2
    for (int k = 0; k < len; k += 4) {
      float4 av[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) av[r] = *reinterpret_cast<const float4*>(sa + r * kChunk + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 bv = *reinterpret_cast<const float4*>(sb + (k + kk) * kCols + 4 * lane);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float x = kk == 0 ? av[r].x : kk == 1 ? av[r].y : kk == 2 ? av[r].z : av[r].w;
          acc[r][0] = fmaf(x, bv.x, acc[r][0]);
          acc[r][1] = fmaf(x, bv.y, acc[r][1]);
          acc[r][2] = fmaf(x, bv.z, acc[r][2]);
          acc[r][3] = fmaf(x, bv.w, acc[r][3]);
        }
      }
    }
  }
  if (tile < n_tiles) {
    const size_t oc = static_cast<size_t>(kCols) * n_tiles;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<float4*>(out + (f0 + r) * oc + tile * kCols + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---------------------------------------------------------------------------
// TF32 variants: wgmma m64n(16P)k8, A = b^T from registers, B = a's stacked
// components from shared memory.

template <int P>
struct Tf32Layout {
  static constexpr int N = 16 * P;            // rows of the stacked B operand
  static constexpr int NB = N / 8;            // its 8-row groups
  static constexpr int ND = N / 2;            // accumulator registers a thread
  static constexpr int kComps = N * kChunk;   // floats of one stage's components
  static constexpr int kStage = kComps + kChunk * kBPitch;
  static constexpr size_t kSmem = kStages * kStage * sizeof(float);
  static_assert(kStage * sizeof(float) % 1024 == 0, "stages keep the operand's atoms aligned");
};

// a's P components of one float4 (row f = tid / 16, k = 4 q .. 4 q + 3 of
// the chunk) into the stage's B operand, each one 16-byte chunk of row
// n = 16 p + f.
template <int P>
__device__ __forceinline__ void store_comps(float* sc, float4 x, int tid) {
  using L = Tf32Layout<P>;
  const int f = tid / 16, q = tid % 16;
  uint32_t c0[3], c1[3], c2[3], c3[3];
  tf32_split<P>(x.x, c0);
  tf32_split<P>(x.y, c1);
  tf32_split<P>(x.z, c2);
  tf32_split<P>(x.w, c3);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int n = 16 * p + f;
    *reinterpret_cast<float4*>(sc + comp_offset<L::NB>(n, q)) =
        make_float4(__uint_as_float(c0[p]), __uint_as_float(c1[p]), __uint_as_float(c2[p]),
                    __uint_as_float(c3[p]));
  }
}

// One tile's chunk: nks wgmmas into d, the first with scale-d = 0.
template <int P>
__device__ __forceinline__ void issue_chunk(float (&d)[Tf32Layout<P>::ND],
                                            const uint32_t (&fr)[kChunk / 8][4], uint32_t base,
                                            int nks) {
  using L = Tf32Layout<P>;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kChunk / 8; ++ks)
    if (ks < nks)
      wgmma_tf32<L::N>(d, fr[ks], comp_desc<L::NB>(base, ks), ks);
  wgmma_commit();
}

// sum += the chunk's passes: (mid + lo) + hi, v1's order of the small
// passes before the hi pass.
template <int P>
__device__ __forceinline__ void add_chunk(float (&sum)[8], float (&d)[Tf32Layout<P>::ND]) {
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (P == 1) {
      sum[i] += d[i];
    } else if constexpr (P == 2) {
      sum[i] += d[8 + i] + d[i];
    } else {
      sum[i] += (d[8 + i] + d[16 + i]) + d[i];
    }
  }
}

// Warpgroup w takes b's columns 64 w .. 64 w + 63 (the wgmma's M); within
// it warp i holds rows 16 i .. 16 i + 15 of the A fragments and of the
// accumulators (the PTX ISA's m64nNk8 .tf32 fragment layouts).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    moment_dot_tf32(const float* __restrict__ a,  // (ns, 16, S)
                    const float* __restrict__ b,  // (ns, S, 128)
                    int ns, int s_len, int n_tiles,
                    float* __restrict__ out) {    // (16, 128 n_tiles)
  static_assert(kTiles == 4, "the issue order below serves four tiles");
  using L = Tf32Layout<P>;
  extern __shared__ __align__(1024) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3);
  const int nc = ns * ((s_len + kChunk - 1) / kChunk);

  float acc[kTiles][8];
  float ca[L::ND], cb[L::ND];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTiles; ++j) acc[j][i] = 0.f;
#pragma unroll
  for (int i = 0; i < L::ND; ++i) ca[i] = cb[i] = 0.f;

  {  // chunk 0 into stage 0
    const Chunk ch = chunk_of(0, s_len);
    stage_b<kBPitch>(smem + L::kComps, b, ch, s_len, tid);
    cp_async_commit();
    if (const float* src = a_quad(a, ch, s_len, tid))
      store_comps<P>(smem, __ldg(reinterpret_cast<const float4*>(src)), tid);
    fence_proxy_async();
  }
  for (int c = 0; c < nc; ++c) {
    // Chunk c + 1: b by cp.async into the other stage, a into registers
    // (split and stored after this chunk's products).
    const float* next = nullptr;
    if (c + 1 < nc) {
      const Chunk nx = chunk_of(c + 1, s_len);
      stage_b<kBPitch>(smem + ((c + 1) % kStages) * L::kStage + L::kComps, b, nx, s_len, tid);
      cp_async_commit();
      next = a_quad(a, nx, s_len, tid);
    }
    const float4 raw = next ? __ldg(reinterpret_cast<const float4*>(next))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    if (c + 1 < nc) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float* sc = smem + (c % kStages) * L::kStage;
    const float* sb = sc + L::kComps;
    const int nks = chunk_of(c, s_len).len / 8;
    // A = b^T: A[m][k] = b[k][m0 + m]; a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
    // a3 (g + 8, t + 4), truncated to TF32.
    uint32_t fr[kChunk / 8][4];
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const float* r0 = sb + (8 * ks + t) * kBPitch + m0 + g;
      const float* r1 = r0 + 4 * kBPitch;
      const bool in = ks < nks;
      fr[ks][0] = in ? __float_as_uint(tf32_trunc(r0[0])) : 0u;
      fr[ks][1] = in ? __float_as_uint(tf32_trunc(r0[8])) : 0u;
      fr[ks][2] = in ? __float_as_uint(tf32_trunc(r1[0])) : 0u;
      fr[ks][3] = in ? __float_as_uint(tf32_trunc(r1[8])) : 0u;
    }
    // The block's four tiles on two accumulator sets in turn: one tile's
    // chain runs while the previous one's sums are added.
    const uint32_t base = smem_u32(sc);
    issue_chunk<P>(ca, fr, base, nks);
    issue_chunk<P>(cb, fr, base, nks);
    wgmma_wait<1>();
    add_chunk<P>(acc[0], ca);
    issue_chunk<P>(ca, fr, base, nks);
    wgmma_wait<1>();
    add_chunk<P>(acc[1], cb);
    issue_chunk<P>(cb, fr, base, nks);
    wgmma_wait<1>();
    add_chunk<P>(acc[2], ca);
    wgmma_wait<0>();
    add_chunk<P>(acc[3], cb);

    if (next) store_comps<P>(smem + ((c + 1) % kStages) * L::kStage, raw, tid);
    fence_proxy_async();
  }

  const size_t oc = static_cast<size_t>(kCols) * n_tiles;
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int tile = blockIdx.x * kTiles + i;
    if (tile >= n_tiles) break;
    const int col = tile * kCols + m0 + g;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int f = 8 * j + 2 * t;
      out[f * oc + col] = acc[i][4 * j];
      out[(f + 1) * oc + col] = acc[i][4 * j + 1];
      out[f * oc + col + 8] = acc[i][4 * j + 2];
      out[(f + 1) * oc + col + 8] = acc[i][4 * j + 3];
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const float* a, const float* b, int ns, int s_len,
           int n_tiles, float* out, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n_tiles + kTiles - 1) / kTiles, kThreads, smem, stream>>>(a, b, ns, s_len, n_tiles,
                                                                       out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// prec: 0 fp32, 1 tf32, 2 tf32x2, 3 tf32x3; s_len a multiple of 8; a, b and
// out 16-byte aligned. Launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue for
// bad arguments).
int dc_moment_dot(int prec, const void* a, const void* b, int ns, int s_len, int n_tiles,
                  void* out, void* stream) {
  if (n_tiles <= 0 || ns <= 0 || s_len <= 0 || s_len % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (prec) {
    case kFp32:
      return launch(moment_dot_fp32, kStages * kFpStage * sizeof(float), pa, pb, ns, s_len,
                    n_tiles, po, st);
    case kTf32:
      return launch(moment_dot_tf32<1>, Tf32Layout<1>::kSmem, pa, pb, ns, s_len, n_tiles, po, st);
    case kTf32x2:
      return launch(moment_dot_tf32<2>, Tf32Layout<2>::kSmem, pa, pb, ns, s_len, n_tiles, po, st);
    case kTf32x3:
      return launch(moment_dot_tf32<3>, Tf32Layout<3>::kSmem, pa, pb, ns, s_len, n_tiles, po, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
