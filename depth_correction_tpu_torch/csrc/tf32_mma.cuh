// TF32 tensor-core pieces shared by the moment-product probes
// (csrc/moment_dot.cu, csrc/moment_window.cu).
//
// - The split: a float32 x is cut into components that are exactly
//   representable in TF32 (sign, 8 exponent bits, 10 mantissa bits), by
//   truncation with an integer mask: hi = x & 0xFFFFE000, rem = x - hi
//   (exact in f32), mid = rem & 0xFFFFE000, lo = (rem - mid) & 0xFFFFE000
//   (rem - mid has at most 2 significant bits, so the last mask keeps it
//   whole). hi + mid + lo == x for every normal float32. The code, not the
//   hardware, defines the rounding: the tensor core reads only the top 19
//   bits of a TF32 operand, and every operand here has zeros below them.
//   The plain twin (ops/moment_dot.tf32_split) repeats the same masks.
// - The step: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, one warp
//   computing D (16x8) = A (16x8, row) * B (8x8, col) + C, with the
//   fragment layouts of the PTX ISA ("Matrix Fragments for mma.m16n8k8",
//   .tf32): with g = lane >> 2 and t = lane & 3,
//     A: a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
//     B: b0 = B[t][g], b1 = B[t + 4][g]
//     C, D: c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]

#pragma once
#include <cstdint>

namespace {

// Precision variants of the moment product, in the order of the Python
// PRECISIONS tuple (ops/moment_dot.py).
enum Precision { kFp32 = 0, kTf32 = 1, kTf32x2 = 2, kTf32x3 = 3 };

__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// The first `n` TF32 components of x (n = 1, 2 or 3), as raw bits.
template <int N>
__device__ __forceinline__ void tf32_split(float x, uint32_t (&c)[3]) {
  const float hi = tf32_trunc(x);
  c[0] = __float_as_uint(hi);
  if constexpr (N >= 2) {
    const float rem = x - hi;
    const float mid = tf32_trunc(rem);
    c[1] = __float_as_uint(mid);
    if constexpr (N >= 3) c[2] = __float_as_uint(tf32_trunc(rem - mid));
  }
}

// D = A * B + D for one m16n8k8 TF32 tile (fragments as above).
__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint32_t b0,
                                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace
