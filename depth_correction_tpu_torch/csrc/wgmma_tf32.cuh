// Hopper's warpgroup TF32 product (wgmma) as the moment-product kernels use
// it (csrc/moment_dot.cu, csrc/moment_window.cu): out^T = A B with A, a
// {0, 1} membership or b^T, in registers (the PTX ISA's m64nNk8 .tf32 A
// fragment: warp w of the warpgroup holds rows 16 w .. 16 w + 15; with
// g = lane >> 2 and t = lane & 3, a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4)), B the TF32 components of the features, K-major in
// shared memory in the 128-byte swizzle, and D in registers (d[4 i + 0] =
// (g, 8 i + 2 t), d[4 i + 1] = (g, 8 i + 2 t + 1), d[4 i + 2] = (g + 8,
// 8 i + 2 t), d[4 i + 3] = (g + 8, 8 i + 2 t + 1)).

#pragma once
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_m64n16k8(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n48k8(float (&d)[24], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (N == 16) {
    wgmma_m64n16k8(d, a, desc, scale_d);
  } else if constexpr (N == 32) {
    wgmma_m64n32k8(d, a, desc, scale_d);
  } else {
    static_assert(N == 48, "one to three passes");
    wgmma_m64n48k8(d, a, desc, scale_d);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from reading accumulators before the wait that
// completes them (the wait names no registers).
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Make this thread's shared-memory stores visible to wgmma's operand reads
// (the async proxy); a barrier follows before any wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The B operand of one stage, K-major in the 128-byte swizzle: atoms of 8
// rows (N) x 32 k (128 bytes a row, 1 KB an atom, 1 KB aligned), in which
// the 16-byte chunk j of row r is stored at chunk j ^ r; the atoms of one
// k range are 1 KB apart along N, and the chunk's two k ranges (k 0-31,
// 32-63) NB KB apart. Float offset of row n, k quad q (k = 4 q .. 4 q + 3):
template <int NB>
__device__ __forceinline__ int comp_offset(int n, int q) {
  const int r = n % 8, j = q % 8;
  return (q / 8) * NB * 256 + (n / 8) * 256 + r * 32 + (j ^ r) * 4;
}

// The wgmma descriptor of that operand for k8 step ks: start address
// (within an atom, advanced 32 bytes a step), the stride between 8-row
// atoms along N (1 KB; the leading offset is unused in this layout) and
// the 128-byte swizzle mode.
template <int NB>
__device__ __forceinline__ uint64_t comp_desc(uint32_t base, int ks) {
  const uint32_t addr = base + (ks / 4) * NB * 1024 + (ks % 4) * 32;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

}  // namespace
