// 3xTF32 tensor-core products for the f32 kernels: the split of an f32
// into two TF32 parts, mma.sync.m16n8k8 (tf32) and ldmatrix.
//
// An f32 a splits into hi = a rounded to TF32 (half a TF32 ulp added, the
// 13 low bits dropped) and lo = a - hi, exact in f32; hi + lo == a.  The
// tensor cores read the TF32 part of an f32 register and drop the 13 low
// bits, which costs lo a relative 2^-10 and a no more than 2^-21.  a * b
// is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b into a fresh accumulator
// that is added to the running sum in f32: the tensor cores align and
// truncate the addends of an mma to the largest one, so summing into a
// large running sum inside the mma would lose more.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }

__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (a + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__uint_as_float(a) - __uint_as_float(hi));
}

__device__ __forceinline__ float4 split_tf32(float4 v, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(bits(v.x), h[0], l[0]);
  split_tf32(bits(v.y), h[1], l[1]);
  split_tf32(bits(v.z), h[2], l[2]);
  split_tf32(bits(v.w), h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// d += a * b (one TF32 product).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, into a fresh accumulator (C = 0).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// Four 8 x 4 f32 tiles of shared memory (8 x 8 as b16) into registers:
// lanes 8m..8m+7 give the row addresses of tile m, and lane 4g + t gets
// element (g, t) of each tile: an m16n8k8 A fragment, or the B
// fragments of two n-tiles, from rows whose k runs along the row.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
      : "memory");
}

// A 16 x 8 A operand in the m16n8k8 fragment order ((g, t), (g+8, t),
// (g, t+4), (g+8, t+4) for lane 4g + t), as its hi and lo TF32 parts.
struct Frag {
  uint32_t hi[4], lo[4];
  // from f32 values (bits), split here
  __device__ __forceinline__ void set(const uint32_t (&a)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[e], hi[e], lo[e]);
  }
};

// d += a * b, b an 8 x 8 B operand given as (k = t, n = g) and
// (k = t + 4, n = g), split already: (bh0, bh1) its hi parts, (bl0, bl1)
// its lo parts.  The two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Frag& a,
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float t[4];
  mma_tf32_zero(t, a.lo, bh0, bh1);
  mma_tf32(t, a.hi, bl0, bl1);
  mma_tf32(t, a.hi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

}  // namespace repro_torch
