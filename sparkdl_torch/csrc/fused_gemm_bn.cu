// Fused 1x1-conv GEMM with BatchNorm-training epilogues, for Hopper (sm_90a),
// on the tensor cores at float32 accuracy.
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
// Bound on this card (H100 SXM, 700 W; chip_smoke.py's count). Each of the
// seven ResNet50 1x1 shapes of a B = 64, 224 px step is 2*M*K*N = 6.58
// GFLOP, 25 launches a step: 164.4 GFLOP.
// - On the CUDA cores (67 TFLOP/s f32): 0.098 ms a launch, 2.454 ms a step.
// - On the tensor cores as 3xTF32 (three TF32 passes a product, 495
//   TFLOP/s): 0.0399 ms a launch, 0.996 ms a step. Bytes (x, w, y, bias,
//   scale and shift, each once) are 0.077 ms at the first stage-1 shape
//   (56x56, K = 256 -> N = 64: x 205 MB + y 51 MB at 3.35 TB/s) down to
//   0.011 ms at 7x7, 0.691 ms a step. So bytes bound the narrow early
//   shape, operations the deep ones: 0.996 ms a step (operations).
//
// What the design does about it:
// - Tensor cores through mma.sync (mma_tf32x3.cuh): float32 as m16n8k8
//   TF32 with the 3xTF32 split (float32 accuracy at a third of the TF32
//   rate, 2.5x the CUDA cores' f32 peak), bfloat16 as m16n8k16 in one pass.
//   x is the row-major A operand; w's usual strides (1, K) are k-contiguous
//   rows per output column, which is mma's "col" B operand as it lies.
// - Tiles: a block owns 64 x 64 outputs, 4 warps of 32 x 32 (2 x 4 mma
//   tiles each), 4 blocks an SM. The deep-K shapes get enough blocks
//   (2048 -> 512 at M = 3136: 392 for 132 SMs, where 128-row blocks give
//   200). Over a step, 128-row blocks of 8 warps were 1% slower, warps of
//   64 x 32 or 32 x 64 (128-row blocks) 1–8% slower, 64-wide K slices or a
//   4-stage ring 9–15% slower.
// - Loads: K in steps of 32 through a 3-stage ring of 16-byte cp.async
//   copies (x and w rows, and the K-slice's scale and shift), two slices in
//   flight while one is computed. Where rows cannot be read as 16-byte
//   chunks (K not a multiple of 4 floats or 8 bf16, a base off 16 bytes, w
//   in other strides), the same kernel takes a scalar path: element loads,
//   not overlapped with compute. Rows past M, columns past N and K past K
//   are zeros. Shared rows are padded by 16 bytes (conflict-free fragment
//   loads).
// - The grid's fastest axis walks the N tiles, so the blocks in flight
//   share their rows of x and read them from L2 (2.7% faster than M first).
// - The BN-normalize + ReLU prologue runs as A fragments are read from
//   shared memory, before the TF32 split (bfloat16: before the drop to
//   bfloat16), so the normalized activation never exists in device memory.
//   The split leaves its small half for the tensor cores to truncate
//   (split_tf32_trunc): 4% faster, y's error 1.46e-6 against 1.37e-6
//   rounded.
// - Accuracy: an mma rounds the running sum it is handed by the tensor
//   cores' own rule, so a chain of them over K up to 2048 drifts: chained
//   through the accumulator, y came 1.38e-5 from the plain version at the
//   ResNet50 shapes, over chip_smoke.py's 1e-5. Each ring stage's 32-wide
//   K slice (RUN = 4 float32 k-steps of three passes, 2 bfloat16 ones)
//   sums from zero and reaches the accumulator in one float32 add: 1.5e-6,
//   2.6% faster than summing every k-step from zero (1.6e-6;
//   tools/fwd_gemm_variants.py on an H100 80GB HBM3 at 700 W, as are the
//   other figures here).
// - Epilogue on the accumulators: bias, the store of y, and the tile's
//   column sums of y and y^2 (rows < M), reduced over a warp's rows with
//   shuffles and over the block's warps in shared memory, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

using mma3::from_f;
using mma3::Op;
using mma3::row_stride;

constexpr int BM = 64;         // output rows per block
constexpr int BN = 64;         // output columns per block
constexpr int BK = 32;         // K per ring stage
constexpr int STAGES = 3;      // ring depth
constexpr int WM = 32, WN = 32;             // a warp's output sub-tile
constexpr int MT = WM / 16, NTL = WN / 8;   // its mma tiles: 2 x 4
constexpr int WARPS_M = BM / WM;
constexpr int NT = 32 * WARPS_M * (BN / WN);  // threads per block
constexpr int MIN_BLOCKS = 4;  // resident blocks per SM the register budget is cut for
constexpr int RED_COLS = 32, RED_GROUPS = 32;  // the stats reduce's block

struct Args {
  const void* x; const void* w;
  const float* scale; const float* shift; const float* bias;  // scale/shift [K], bias [N]; may be null
  void* y; float* partial;  // y [M, N]; partial [tiles, 2, N]
  int M, K, N;
  long long wsk, wsn;
  int relu_in;
  int vec_x, vec_w;  // x rows / w's k-contiguous rows readable as 16-byte chunks
};

template <typename T>
constexpr size_t smem_bytes() {
  return STAGES * ((BM + BN) * row_stride<T>(BK) * sizeof(T) + 2 * BK * sizeof(float));
}

__device__ __forceinline__ float act(float x, float sc, float sh, bool affine, bool relu) {
  if (affine) x = fmaf(x, sc, sh);
  return relu ? fmaxf(x, 0.f) : x;
}

// A fragment of k-step ks from a staged x tile [16 rows][RS], the
// prologue applied (sc, sh: the stage's scale and shift)
__device__ __forceinline__ Op<float>::A load_a_act(const float* x, int rs, int ks, int g, int t,
                                                   const float* sc, const float* sh, bool affine,
                                                   bool relu) {
  const int k = ks * 8 + t;
  const float s0 = affine ? sc[k] : 1.f, h0 = affine ? sh[k] : 0.f;
  const float s1 = affine ? sc[k + 4] : 1.f, h1 = affine ? sh[k + 4] : 0.f;
  const float* p = x + g * rs + k;
  Op<float>::A a;
  mma3::split_tf32_trunc(act(p[0], s0, h0, affine, relu), a.big[0], a.small[0]);
  mma3::split_tf32_trunc(act(p[8 * rs], s0, h0, affine, relu), a.big[1], a.small[1]);
  mma3::split_tf32_trunc(act(p[4], s1, h1, affine, relu), a.big[2], a.small[2]);
  mma3::split_tf32_trunc(act(p[8 * rs + 4], s1, h1, affine, relu), a.big[3], a.small[3]);
  return a;
}

// B fragment of k-step ks from a staged w^T tile [8 columns][RS]
// (Op<float>::load_b_nk with the truncating split)
__device__ __forceinline__ Op<float>::B load_b(const float* w, int rs, int n0, int ks, int g,
                                               int t) {
  const float* p = w + (n0 + g) * rs + ks * 8 + t;
  Op<float>::B b;
  mma3::split_tf32_trunc(p[0], b.big[0], b.small[0]);
  mma3::split_tf32_trunc(p[4], b.big[1], b.small[1]);
  return b;
}

__device__ __forceinline__ Op<__nv_bfloat16>::B load_b(const __nv_bfloat16* w, int rs, int n0,
                                                       int ks, int g, int t) {
  return Op<__nv_bfloat16>::load_b_nk(w, rs, n0, ks, g, t);
}

// bfloat16: the pair at p (k, k + 1) through the prologue, back to bfloat16
__device__ __forceinline__ uint32_t act_pair(const __nv_bfloat16* p, const float* sc,
                                             const float* sh, int k, bool affine, bool relu) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  if (!affine) return relu ? mma3::pack_bf16(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f))
                           : *reinterpret_cast<const uint32_t*>(p);
  return mma3::pack_bf16(act(v.x, sc[k], sh[k], true, relu), act(v.y, sc[k + 1], sh[k + 1], true,
                                                                     relu));
}

__device__ __forceinline__ Op<__nv_bfloat16>::A load_a_act(const __nv_bfloat16* x, int rs, int ks,
                                                           int g, int t, const float* sc,
                                                           const float* sh, bool affine,
                                                           bool relu) {
  const int k = ks * 16 + 2 * t;
  const __nv_bfloat16* p = x + g * rs + k;
  return Op<__nv_bfloat16>::A{{act_pair(p, sc, sh, k, affine, relu),
                               act_pair(p + 8 * rs, sc, sh, k, affine, relu),
                               act_pair(p + 8, sc, sh, k + 8, affine, relu),
                               act_pair(p + 8 * rs + 8, sc, sh, k + 8, affine, relu)}};
}

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) gemm_bn_kernel(const Args a) {
  constexpr int RS = row_stride<T>(BK);
  constexpr int KSTEPS = BK / Op<T>::K;
  constexpr int RUN = KSTEPS;  // k-steps summed from zero before they reach acc: a ring stage
  static_assert(KSTEPS % RUN == 0, "runs tile a ring stage");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);                      // [STAGES][BM][RS]
  T* sB = sA + STAGES * BM * RS;                           // [STAGES][BN][RS]: w^T rows
  float* sSc = reinterpret_cast<float*>(sB + STAGES * BN * RS);  // [STAGES][BK]
  float* sSh = sSc + STAGES * BK;                                // [STAGES][BK]
  __shared__ float red[2][WARPS_M][BN];

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int tid = threadIdx.x, wid = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int wm = wid % WARPS_M, wn = wid / WARPS_M;
  const int mt = blockIdx.y, nt = blockIdx.x;  // this block's M and N tiles
  const int m0 = mt * BM, n0 = nt * BN;
  const bool affine = a.scale != nullptr, relu = a.relu_in != 0;
  const int nk = (a.K + BK - 1) / BK;

  // K-slice kt -> ring stage kt % STAGES; commits a group even past K, so
  // that wait_group counts stages
  auto fetch = [&](int kt) {
    if (kt < nk) {
      const int st = kt % STAGES, k0 = kt * BK;
      T* dA = sA + st * BM * RS;
      T* dB = sB + st * BN * RS;
      constexpr int V = 16 / sizeof(T), CPR = BK / V;
      if (a.vec_x) {
        for (int i = tid; i < BM * CPR; i += NT) {
          const int rr = i / CPR, c = (i % CPR) * V, row = m0 + rr;
          const bool in = row < a.M && k0 + c < a.K;
          mma3::cp_async16(dA + rr * RS + c,
                           in ? x + static_cast<long long>(row) * a.K + k0 + c : x, in);
        }
      } else {
        for (int i = tid; i < BM * BK; i += NT) {
          const int rr = i / BK, c = i % BK, row = m0 + rr;
          dA[rr * RS + c] = (row < a.M && k0 + c < a.K)
                                ? x[static_cast<long long>(row) * a.K + k0 + c]
                                : from_f<T>(0.f);
        }
      }
      if (a.vec_w) {
        for (int i = tid; i < BN * CPR; i += NT) {
          const int nn = i / CPR, c = (i % CPR) * V, col = n0 + nn;
          const bool in = col < a.N && k0 + c < a.K;
          mma3::cp_async16(dB + nn * RS + c, in ? w + col * a.wsn + k0 + c : w, in);
        }
      } else {
        for (int i = tid; i < BN * BK; i += NT) {
          int nn, c;  // neighbouring threads on neighbouring addresses
          if (a.wsn == 1) { nn = i % BN; c = i / BN; } else { c = i % BK; nn = i / BK; }
          const int col = n0 + nn, kk = k0 + c;
          dB[nn * RS + c] = (col < a.N && kk < a.K) ? w[kk * a.wsk + col * a.wsn]
                                                    : from_f<T>(0.f);
        }
      }
      static_assert(NT >= 2 * BK, "a thread per scale and shift of a K slice");
      if (affine && tid < 2 * BK) {
        const int kk = k0 + tid % BK;
        const float* src = tid < BK ? a.scale : a.shift;
        const bool in = kk < a.K;  // past K: scale = shift = 0, so a = 0
        mma3::cp_async4((tid < BK ? sSc : sSh) + st * BK + tid % BK, in ? src + kk : src, in);
      }
    }
    mma3::cp_async_commit();
  };

  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int kt = 0; kt < nk; ++kt) {
    mma3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt has landed; slice kt - 1 (the stage refilled next) is consumed
    fetch(kt + STAGES - 1);
    const int st = kt % STAGES;
    const T* tA = sA + st * BM * RS + wm * WM * RS;
    const T* tB = sB + st * BN * RS;
    const float* sc = sSc + st * BK;
    const float* sh = sSh + st * BK;
#pragma unroll
    for (int ks0 = 0; ks0 < KSTEPS; ks0 += RUN) {
      float part[MT][NTL][4];  // a run of k-steps, from zero
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int ks = ks0; ks < ks0 + RUN; ++ks) {
        typename Op<T>::A af[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          af[i] = load_a_act(tA + 16 * i * RS, RS, ks, g, t, sc, sh, affine, relu);
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          const typename Op<T>::B bf = load_b(tB, RS, wn * WN + 8 * j, ks, g, t);
#pragma unroll
          for (int i = 0; i < MT; ++i) Op<T>::mma(part[i][j], af[i], bf);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NTL; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }
  mma3::cp_async_wait_all();

  // epilogue: bias, store, this tile's column sums of y and y^2 (rows < M)
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int nn = wn * WN + 8 * j + 2 * t + c, col = n0 + nn;
      const float bj = (a.bias && col < a.N) ? a.bias[col] : 0.f;
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + wm * WM + 16 * i + 8 * r + g;
          if (row < a.M) {
            const float val = acc[i][j][2 * r + c] + bj;
            if (col < a.N) y[static_cast<long long>(row) * a.N + col] = from_f<T>(val);
            s += val;
            sq = fmaf(val, val, sq);
          }
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over g: fixed order
        s += __shfl_xor_sync(0xffffffffu, s, off);
        sq += __shfl_xor_sync(0xffffffffu, sq, off);
      }
      if (g == 0) {
        red[0][wm][nn] = s;
        red[1][wm][nn] = sq;
      }
    }
  __syncthreads();
  for (int i = tid; i < 2 * BN; i += NT) {
    const int stat = i / BN, nn = i % BN;
    float tot = 0.f;
#pragma unroll
    for (int r = 0; r < WARPS_M; ++r) tot += red[stat][r][nn];  // fixed order
    if (n0 + nn < a.N)
      a.partial[(static_cast<long long>(mt) * 2 + stat) * a.N + n0 + nn] = tot;
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

// attrs null: launch the GEMM and the stats reduce; else fill attrs with
// the GEMM's registers per thread, shared bytes per block, resident blocks
// per SM and local (spill) bytes per thread, and launch nothing
template <typename T>
int run(const Args& a, float* stats, cudaStream_t stream, int* attrs) {
  static unsigned long long opted_in = 0;
  constexpr size_t bytes = smem_bytes<T>();
  cudaError_t err = mma3::opt_in(gemm_bn_kernel<T>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attrs) return static_cast<int>(mma3::kernel_attrs(gemm_bn_kernel<T>, NT, bytes, attrs));
  const int tiles = (a.M + BM - 1) / BM;
  gemm_bn_kernel<T><<<dim3((a.N + BN - 1) / BN, tiles), NT, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n2 = 2 * a.N;
  stats_reduce_kernel<<<(n2 + RED_COLS - 1) / RED_COLS, RED_COLS * RED_GROUPS, 0, stream>>>(
      a.partial, stats, tiles, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry, bound with ctypes (sparkdl_torch/ops/fused_gemm_bn.py).
// M up to 65535 * 64 rows (a launch past that returns
// cudaErrorInvalidConfiguration).
// x [M, K] contiguous, w [K, N] with element strides (wsk, wsn), y [M, N]
// contiguous: float32 (bf16 = 0) or bfloat16 (bf16 = 1). scale, shift
// float32 [K] (both or neither), bias float32 [N] or null. partial:
// float32 scratch [gemm_bn_tiles(M), 2, N]; stats: float32 [2, N] out
// (sum of y, sum of y^2). Launches the GEMM and the stats reduce on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launches (0 on success). The caller checks shapes: M, K, N >= 1.
extern "C" int gemm_bn_stats(const void* x, const void* w, const float* scale,
                             const float* shift, const float* bias, void* y, float* partial,
                             float* stats, int bf16, int M, int K, int N, long long wsk,
                             long long wsn, int relu_in, void* stream) {
  const long long v = bf16 ? 8 : 4;  // elements in 16 bytes
  const int vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % v == 0;
  const int vec_w =
      reinterpret_cast<uintptr_t>(w) % 16 == 0 && wsk == 1 && wsn % v == 0 && K % v == 0;
  const Args a{x, w, scale, shift, bias, y, partial, M, K, N, wsk, wsn, relu_in, vec_x, vec_w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(a, stats, st, nullptr) : run<float>(a, stats, st, nullptr);
}

// The number of M tiles (rows of the partial scratch) for M rows.
extern "C" int gemm_bn_tiles(int M) { return (M + BM - 1) / BM; }

// The build of the GEMM kernel, float32 (bf16 = 0) or bfloat16: fills
// out[4] with registers per thread, shared bytes per block, resident blocks
// per SM and local bytes per thread; returns a cudaError_t (0 on success).
extern "C" int gemm_bn_stats_attrs(int bf16, int* out) {
  const Args a{};
  return bf16 ? run<__nv_bfloat16>(a, nullptr, nullptr, out)
              : run<float>(a, nullptr, nullptr, out);
}
