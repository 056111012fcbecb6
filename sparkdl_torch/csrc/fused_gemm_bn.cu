// Fused 1x1-conv GEMM with BatchNorm-training epilogues, for Hopper (sm_90a).
//
// Replaces: sparkdl_tpu/ops/fused_gemm_bn.py::_fwd_kernel (the Pallas
// kernel, reached through conv1x1_bn_stats -> gemm_bn_stats -> _fwd_call).
// Same function, read for what it computes:
//
//   a[m, k] = act(scale[k] * x[m, k] + shift[k])   (act: ReLU or identity;
//                                                   no affine without scale)
//   y[m, n] = sum_k a[m, k] * w[k, n] + bias[n]
//   stats[0, n] = sum_m y[m, n],  stats[1, n] = sum_m y[m, n]^2
//
// x [M, K] row-major, w [K, N] by strides (a torch [N, K] weight passes as
// its transpose, strides (1, K)), y [M, N] row-major, in float32 or
// bfloat16 (for bfloat16, a drops to bfloat16 before the product, as the
// TPU kernel does); float32 accumulation and float32 stats, taken from the
// accumulator (bias included) before y is rounded to its storage type.
//
// The TPU kernel revisits one [2, N] stats block sequentially over the M
// tiles. Blocks on the card run in no order, so the reduction across M
// tiles is a second pass: each GEMM block writes its tile's partial sums
// [2, BN] (rows past M left out) to a [tiles, 2, N] scratch, and a second
// kernel sums them in a fixed order. No atomics: a step gives the same
// bits run to run.
//
// Bound on this card (H100 SXM, 700 W), at ResNet50's first stage-1 1x1
// (B = 64, 56x56, K = 256 -> N = 64): 2*M*K*N = 6.6 GFLOP = 0.10 ms at
// 67 TFLOP/s f32; x 205 MB + y 51 MB = 0.077 ms at 3.35 TB/s. The
// ResNet50 shapes sit near the ridge on the CUDA cores: operations bound
// the wide ones (K, N >= 512), bytes the narrow ones.
//
// What the design does about it:
// - A 128 x 64 output tile per block of 256 threads, 8 x 4 outputs per
//   thread in registers, K in steps of 16 staged through shared memory
//   (A transposed, rows padded): 3 float4 shared-memory reads per 32
//   FMAs. The BN-normalize + ReLU prologue runs on the A load, so the
//   normalized activation never exists in device memory; bias and the
//   stats run on the accumulator, so no pass over y is needed for them.
// - The per-tile stats are reduced over the block's 16 row groups in
//   shared memory in a fixed order.
// - float32 FMAs on the CUDA cores, no wgmma/TMA, no double-buffering:
//   a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // K per shared-memory stage
constexpr int NT = 256;  // threads: 16 row groups x 16 column groups
constexpr int TM = BM / 16;  // rows per thread (8)
constexpr int TN = BN / 16;  // columns per thread (4)
constexpr int RED_COLS = 32, RED_GROUPS = 32;  // the stats reduce's block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* x; const void* w;
  const float* scale; const float* shift; const float* bias;  // scale/shift [K], bias [N]; may be null
  void* y; float* partial;  // y [M, N]; partial [tiles, 2, N]
  int M, K, N;
  long long wsk, wsn;
  int relu_in;
};

template <typename T>
__global__ void __launch_bounds__(NT) gemm_bn_kernel(const Args a) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float red[2][16][BN];

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += BK) {
    // A: 128 x 16, the previous BN's normalize (+ReLU) on the load
#pragma unroll
    for (int e = 0; e < BM * BK / NT; ++e) {
      const int i = tid + NT * e, row = i / BK, kk = i % BK;
      const int gm = m0 + row, gk = k0 + kk;
      float val = 0.f;
      if (gm < a.M && gk < a.K) {
        val = to_f(x[static_cast<long long>(gm) * a.K + gk]);
        if (a.scale) val = fmaf(val, a.scale[gk], a.shift[gk]);
        if (a.relu_in) val = fmaxf(val, 0.f);
        val = to_f(from_f<T>(val));  // the operand in its storage type
      }
      As[kk][row] = val;
    }
    // B: 16 x 64, neighbouring threads on neighbouring addresses
#pragma unroll
    for (int e = 0; e < BK * BN / NT; ++e) {
      const int i = tid + NT * e;
      int kk, nn;
      if (a.wsn == 1) { nn = i % BN; kk = i / BN; } else { kk = i % BK; nn = i / BK; }
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < a.K && gn < a.N) ? to_f(w[gk * a.wsk + gn * a.wsn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias, store, this tile's column sums of y and y^2 (rows < M)
  T* y = static_cast<T*>(a.y);
  float s[TN], sq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    const float bj = (a.bias && gn < a.N) ? a.bias[gn] : 0.f;
    s[j] = sq[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < a.M && gn < a.N) {
        const float val = acc[i][j] + bj;
        y[static_cast<long long>(gm) * a.N + gn] = from_f<T>(val);
        s[j] += val;
        sq[j] = fmaf(val, val, sq[j]);
      }
    }
    red[0][ty][tx * TN + j] = s[j];
    red[1][ty][tx * TN + j] = sq[j];
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int stat = tid / BN, nn = tid % BN;
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) t += red[stat][g][nn];  // fixed order
    if (n0 + nn < a.N)
      a.partial[(static_cast<long long>(blockIdx.x) * 2 + stat) * a.N + n0 + nn] = t;
  }
}

// stats[2, N] = sum over the tiles of partial[tiles, 2, N], in a fixed order:
// RED_GROUPS strided partial sums per column, then those in order
__global__ void __launch_bounds__(RED_COLS * RED_GROUPS)
stats_reduce_kernel(const float* partial, float* stats, int tiles, int n2) {
  __shared__ float red[RED_GROUPS][RED_COLS];
  const int col = threadIdx.x % RED_COLS, g = threadIdx.x / RED_COLS;
  const int idx = blockIdx.x * RED_COLS + col;
  float t = 0.f;
  if (idx < n2)
    for (int i = g; i < tiles; i += RED_GROUPS) t += partial[static_cast<long long>(i) * n2 + idx];
  red[g][col] = t;
  __syncthreads();
  if (g == 0 && idx < n2) {
    float sum = 0.f;
#pragma unroll 8
    for (int i = 0; i < RED_GROUPS; ++i) sum += red[i][col];
    stats[idx] = sum;
  }
}

template <typename T>
int launch(const Args& a, float* stats, cudaStream_t stream) {
  const int tiles = (a.M + BM - 1) / BM;
  gemm_bn_kernel<T><<<dim3(tiles, (a.N + BN - 1) / BN), NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n2 = 2 * a.N;
  stats_reduce_kernel<<<(n2 + RED_COLS - 1) / RED_COLS, RED_COLS * RED_GROUPS, 0, stream>>>(
      a.partial, stats, tiles, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes (sparkdl_torch/ops/fused_gemm_bn.py).
// x [M, K] contiguous, w [K, N] with element strides (wsk, wsn), y [M, N]
// contiguous: float32 (bf16 = 0) or bfloat16 (bf16 = 1). scale, shift
// float32 [K] (both or neither), bias float32 [N] or null. partial:
// float32 scratch [ceil(M / 128), 2, N]; stats: float32 [2, N] out (sum of
// y, sum of y^2). Launches the GEMM and the stats reduce on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launches (0 on
// success). The caller checks shapes: M, K, N >= 1.
extern "C" int gemm_bn_stats(const void* x, const void* w, const float* scale,
                             const float* shift, const float* bias, void* y, float* partial,
                             float* stats, int bf16, int M, int K, int N, long long wsk,
                             long long wsn, int relu_in, void* stream) {
  const Args a{x, w, scale, shift, bias, y, partial, M, K, N, wsk, wsn, relu_in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, stats, st) : launch<float>(a, stats, st);
}

// The number of M tiles (rows of the partial scratch) for M rows.
extern "C" int gemm_bn_tiles(int M) { return (M + BM - 1) / BM; }
