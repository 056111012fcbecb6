// Warp-level tensor-core helpers for Hopper (sm_90a), shared by the
// attention kernels and the fused GEMM: mma.sync products at float32
// accuracy (3xTF32) and in bfloat16, their fragment loads from shared
// memory (Op<T>), and the cp.async copies that feed them.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma3 {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// the split with small left whole: the tensor cores read its top 19 bits,
// truncating. Two integer ops fewer; big + small then stands for x within
// 2^-21 of |x| (rounded: 2^-22), the error biased toward zero
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
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

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A shared-memory row of dp elements of T, padded by 16 bytes (4 floats, 8
// bf16), so that the 32-bit fragment loads of a warp fall in 32 different
// banks (row stride = 4 words mod 32: lane (g, t) hits bank 4g + t, or
// 8t + g transposed)
template <typename T>
__host__ __device__ constexpr int row_stride(int dp) {
  return dp + 16 / static_cast<int>(sizeof(T));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Fragments of one warp's mma.sync, lane = 4 g + t. A is 16 x K row-major,
// B is K x 8, accumulators 16 x 8 float32: lane holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). Shared tiles are [rows][rs] in T.
//
// Accumulator to A operand without moving data (a_from_c). For TF32
// m16n8k8 the accumulator layout (lane holds columns 2t, 2t+1 of rows g,
// g+8) is not the A layout (columns t, t+4). A product sums over its k
// index in any order, so the second product numbers its 8 contracted rows
// as 0, 2, 4, 6, 1, 3, 5, 7: then a lane's accumulator (c0, c1, c2, c3) is
// its A fragment (a0, a2, a1, a3) as it stands, and the B fragment reads
// rows 2t and 2t + 1 of the shared tile (load_b_kn). bfloat16 m16n8k16
// needs no renumbering: two accumulator tiles pack into one A fragment.
template <typename T> struct Op;

template <> struct Op<float> {
  static constexpr int K = 8;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };

  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_tf32x3(d, a.big, a.small, b.big, b.small);
  }
  static __device__ __forceinline__ void mma_rn(float (&d)[4], const A& a, const B& b) {
    mma_tf32x3_rn(d, a.big, a.small, b.big, b.small);
  }
  // A[m][k] = x[m][8 ks + k]
  static __device__ __forceinline__ A load_a(const float* x, int rs, int ks, int g, int t) {
    const float* p = x + g * rs + ks * K + t;
    A a;
    split_tf32(p[0], a.big[0], a.small[0]);
    split_tf32(p[8 * rs], a.big[1], a.small[1]);
    split_tf32(p[4], a.big[2], a.small[2]);
    split_tf32(p[8 * rs + 4], a.big[3], a.small[3]);
    return a;
  }
  // B[k][n] = x[n0 + n][8 ks + k]
  static __device__ __forceinline__ B load_b_nk(const float* x, int rs, int n0, int ks, int g,
                                                int t) {
    const float* p = x + (n0 + g) * rs + ks * K + t;
    B b;
    split_tf32(p[0], b.big[0], b.small[0]);
    split_tf32(p[4], b.big[1], b.small[1]);
    return b;
  }
  // B[k][n] = x[8 ks + r(k)][n0 + n], k renumbered: r(t) = 2t, r(t + 4) = 2t + 1
  static __device__ __forceinline__ B load_b_kn(const float* x, int rs, int ks, int n0, int g,
                                                int t) {
    const float* p = x + (ks * K + 2 * t) * rs + n0 + g;
    B b;
    split_tf32(p[0], b.big[0], b.small[0]);
    split_tf32(p[rs], b.big[1], b.small[1]);
    return b;
  }
  // A over the accumulator columns [8 ks, 8 ks + 8), renumbered as load_b_kn
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4], int ks) {
    A a;
    split_tf32(c[ks][0], a.big[0], a.small[0]);
    split_tf32(c[ks][2], a.big[1], a.small[1]);
    split_tf32(c[ks][1], a.big[2], a.small[2]);
    split_tf32(c[ks][3], a.big[3], a.small[3]);
    return a;
  }
};

template <> struct Op<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int K = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ uint32_t u32(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.r, b.r);
  }
  static __device__ __forceinline__ void mma_rn(float (&d)[4], const A& a, const B& b) {
    mma_bf16(d, a.r, b.r);  // bfloat16 operands: their rounding dominates
  }
  // A[m][k] = x[m][16 ks + k]: lane holds k = 2t, 2t + 1 and 2t + 8, 2t + 9
  static __device__ __forceinline__ A load_a(const T* x, int rs, int ks, int g, int t) {
    const T* p = x + g * rs + ks * K + 2 * t;
    return A{{u32(p), u32(p + 8 * rs), u32(p + 8), u32(p + 8 * rs + 8)}};
  }
  // B[k][n] = x[n0 + n][16 ks + k]
  static __device__ __forceinline__ B load_b_nk(const T* x, int rs, int n0, int ks, int g,
                                                int t) {
    const T* p = x + (n0 + g) * rs + ks * K + 2 * t;
    return B{{u32(p), u32(p + 8)}};
  }
  // B[k][n] = x[16 ks + k][n0 + n]
  static __device__ __forceinline__ B load_b_kn(const T* x, int rs, int ks, int n0, int g,
                                                int t) {
    const T* p = x + (ks * K + 2 * t) * rs + n0 + g;
    return B{{pack_bf16(p[0], p[rs]), pack_bf16(p[8 * rs], p[9 * rs])}};
  }
  // A over the accumulator columns [16 ks, 16 ks + 16): tiles 2 ks, 2 ks + 1
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4], int ks) {
    const float(&lo)[4] = c[2 * ks];
    const float(&hi)[4] = c[2 * ks + 1];
    return A{{pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]),
              pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])}};
  }
};

// Above 48 KB of shared memory a kernel runs only after opting in; once per
// kernel and device (a bit per device id in `opted_in`), so that launches,
// and their capture in a CUDA graph, skip it
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, unsigned long long& opted_in) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted_in |= 1ull << dev;
  }
  return cudaSuccess;
}

// registers per thread, shared bytes per block (static + dynamic), resident
// blocks per SM at `threads`, and local (spill) bytes per thread of a kernel
template <typename K>
cudaError_t kernel_attrs(K kernel, int threads, size_t dyn_bytes, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_bytes);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes + dyn_bytes);
  out[2] = blocks;
  out[3] = static_cast<int>(fa.localSizeBytes);
  return err;
}

}  // namespace mma3
