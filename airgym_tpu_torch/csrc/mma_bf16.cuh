// One warp-level bf16 product on the tensor cores, and its fragments.
//
// mma_16816(d, a, b) is PTX's mma.sync.aligned.m16n8k16.row.col.f32.bf16.
// bf16.f32: D (16 x 8, float32) += A (16 x 16, bf16) * B (16 x 8, bf16),
// issued by all 32 lanes of a warp together. bf16 x bf16 products are
// exact in float32; only the order of the float32 sums is the card's.
//
// Fragments, in PTX's documented m16n8k16 lane layout (the same as
// CUTLASS's SM80_16x8x16_F32BF16BF16F32_TN), with g = lane >> 2 and
// t = lane & 3; each 32-bit register holds two bf16 values, the lower
// column (or k) index in the lower half:
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//                           a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..);
//   B (16 x 8, "col": k contiguous for each n): b[0] = k 2t..2t+1 at n = g,
//                           b[1] = k 2t+8..2t+9 at n = g;
//   D (16 x 8, float32):    d[0..1] = (g, 2t..2t+1), d[2..3] = (g+8, 2t..).
// The loaders read tiles that lie in shared memory as raw bf16 bits
// (uint16_t) with 32-bit loads: A row-major with an even row stride, B as
// [n][k] with an even row stride. No ldmatrix, so the CPU emulation
// (cuda_emu.h: the lanes swap fragments through a per-warp buffer) stays
// simple.
#pragma once

#include <cstdint>

namespace mma {

// the bits of x rounded to bf16 (nearest even)
__device__ __forceinline__ uint16_t bf16_bits(float x) {
#ifdef AIRGYM_CUDA_EMU
  return __float2bfloat16_rn(x).bits;
#else
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
#endif
}

// two bf16 values (lo at the lower index) in one register
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A fragment of the 16 x 16 tile at p (row-major, row stride ld)
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* p,
                                       int ld) {
  const int l = lane_id(), g = l >> 2, t = l & 3;
  const uint16_t* q = p + g * ld + 2 * t;
  a[0] = ld32(q);
  a[1] = ld32(q + 8 * ld);
  a[2] = ld32(q + 8);
  a[3] = ld32(q + 8 * ld + 8);
}

// B fragment of the 16 (k) x 8 (n) tile stored as [n][k] at p, row stride ld
__device__ __forceinline__ void load_b(uint32_t b[2], const uint16_t* p,
                                       int ld) {
  const int l = lane_id();
  const uint16_t* q = p + (l >> 2) * ld + 2 * (l & 3);
  b[0] = ld32(q);
  b[1] = ld32(q + 8);
}

// d += a * b over one m16n8k16 tile (all 32 lanes of the warp together)
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
#ifdef AIRGYM_CUDA_EMU
  emu_mma_16816(d, a, b);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

}  // namespace mma
