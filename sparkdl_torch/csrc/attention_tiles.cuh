// Tile loads, stores and warp products shared by the flash attention
// kernels (flash_attention.cu, flash_attention_bwd.cu). A block of NT
// threads stages rows of one (batch row, head) slice of a strided
// [B, L, H, D] tensor in shared memory, [rows][row_stride<T>(DP)], and each
// warp multiplies its own 16 rows against a staged tile with mma.sync
// (mma_tf32x3.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace attn {

using mma3::Op;
using mma3::row_stride;

// c[16 x 8N] += x[16 x DP] . y[8N x DP]^T: x the warp's 16 rows, y a loop tile.
// Scores: each k-step sums from zero (mma_rn), since their error enters
// exp() and through p everything after it
template <typename T, int DP, int N>
__device__ __forceinline__ void gemm_xyt(float (&c)[N][4], const T* x, const T* y, int g,
                                         int t) {
  constexpr int RS = row_stride<T>(DP);
#pragma unroll
  for (int ks = 0; ks < DP / Op<T>::K; ++ks) {
    const typename Op<T>::A a = Op<T>::load_a(x, RS, ks, g, t);
#pragma unroll
    for (int j = 0; j < N; ++j)
      Op<T>::mma_rn(c[j], a, Op<T>::load_b_nk(y, RS, 8 * j, ks, g, t));
  }
}

// acc[16 x DP] += c[16 x 8N] . y[8N x DP]: c the accumulators of gemm_xyt
// (p or ds). RN: each k-step sums from zero and adds into acc in float32
// (mma_rn); else the k-steps chain through acc (mma)
template <typename T, int DP, int N, bool RN>
__device__ __forceinline__ void gemm_cy(float (&acc)[DP / 8][4], const float (&c)[N][4],
                                        const T* y, int g, int t) {
  constexpr int RS = row_stride<T>(DP);
#pragma unroll
  for (int ks = 0; ks < 8 * N / Op<T>::K; ++ks) {
    const typename Op<T>::A a = Op<T>::a_from_c(c, ks);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const typename Op<T>::B b = Op<T>::load_b_kn(y, RS, ks, 8 * n, g, t);
      if constexpr (RN) Op<T>::mma_rn(acc[n], a, b);
      else Op<T>::mma(acc[n], a, b);
    }
  }
}

// rows [r0, r0 + R) of one (batch row, head) slice of a strided [B, L, H, D]
// tensor (src points at its row 0, sl its row stride) -> shared [R][RS],
// zeros past L and past D, by a block of NT threads. vec: 16-byte cp.async,
// asynchronous (the caller commits and waits). Otherwise the scalar path:
// element loads and stores.
template <typename T, int DP, int R, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int L, long long sl,
                                          int D, int vec) {
  constexpr int RS = row_stride<T>(DP);
  if (vec) {
    constexpr int V = 16 / sizeof(T), CPR = DP / V;
    for (int i = threadIdx.x; i < R * CPR; i += NT) {
      const int rr = i / CPR, c = (i % CPR) * V, row = r0 + rr;
      const bool in = row < L && c < D;
      mma3::cp_async16(dst + rr * RS + c, in ? src + row * sl + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < R * DP; i += NT) {
      const int rr = i / DP, d = i % DP, row = r0 + rr;
      dst[rr * RS + d] = (row < L && d < D) ? src[row * sl + d] : mma3::from_f<T>(0.f);
    }
  }
}

// acc[16 x DP] of a warp -> rows row0, row0 + 8 of a contiguous [., D] output
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[DP / 8][4], long long row0,
                                           bool in0, bool in1, int D, long long row_elems, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!(r ? in1 : in0)) continue;
    T* o = out + (row0 + 8 * r) * row_elems;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < D) o[d] = mma3::from_f<T>(acc[n][2 * r]);
      if (d + 1 < D) o[d + 1] = mma3::from_f<T>(acc[n][2 * r + 1]);
    }
  }
}

// rows of a [B, L, H, D] tensor at p with these strides are 16-byte chunks
inline int vec_rows(const void* p, long long sb, long long sl, long long sh, int D, int elt) {
  const long long v = 16 / elt;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && D % v == 0 && sb % v == 0 &&
         sl % v == 0 && sh % v == 0;
}

}  // namespace attn
