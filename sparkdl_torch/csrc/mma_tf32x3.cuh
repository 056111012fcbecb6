// Warp-level tensor-core helpers for Hopper (sm_90a), shared by the
// attention kernels: mma.sync products at float32 accuracy (3xTF32) and in
// bfloat16, and the cp.async copies that feed them.
//
// 3xTF32. A TF32 operand keeps 10 of float32's 23 mantissa bits, so one
// TF32 product is good to about 3 decimal digits. Splitting each float32
// operand as x = big + small, with big = tf32(x) and small = tf32(x - big),
// and summing small*big + big*small + big*big in a float32 accumulator (the
// small*small term is below float32's rounding) gives float32 accuracy at
// a third of the TF32 tensor-core rate. tf32_rna rounds as
// cvt.rna.tf32.f32 does (to nearest, ties away from zero) and zeroes the
// 13 low bits itself, which the split's x - big needs.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma3 {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d = a * b + d: a 16x8 row-major tf32, b 8x8 column-major tf32, d 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at float32 accuracy: the three passes, small terms first,
// chained through d
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// the same, but the three passes sum from zero and reach d in one float32
// add (round to nearest). Every mma rounds the running sum it is handed by
// the tensor cores' own rule; chained through d over a long contraction,
// that drifts by several float32 ulps of d. Costs 4 adds a call.
__device__ __forceinline__ void mma_tf32x3_rn(float (&d)[4], const uint32_t (&a_big)[4],
                                              const uint32_t (&a_small)[4],
                                              const uint32_t (&b_big)[2],
                                              const uint32_t (&b_small)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32x3(t, a_big, a_small, b_big, b_small);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// d = a * b + d: a 16x16 row-major bf16, b 16x8 column-major bf16, d 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats as a bf16 pair, lo in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (src is
// then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace mma3
