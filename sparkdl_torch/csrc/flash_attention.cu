// Flash attention forward as one CUDA kernel for Hopper (sm_90a).
//
// Replaces: sparkdl_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas
// forward, reached through flash_attention -> _flash -> _fwd). It computes
// the same function, read for what it computes and not block by block:
//
//   o[b, i, h] = softmax_j(s[b, h, i, j]) . v[b, j, h]
//   s = (q[b, i, h] . k[b, j, h]) * scale   where key j is valid for row i,
//       -1e30                               where it is masked
//
// A key is masked when kv_mask[b, j] is false or, causal, when
// j > q_offset + i. The -1e30 sentinel (not -inf) is the TPU kernel's and
// the plain version's: a row whose keys are all masked (a left-pad query
// row) comes out as the uniform average of every value row, finite, so no
// NaN can reach a later layer. With lse, it also writes the float32
// logsumexp [B, H, Lq] the backward pass needs.
//
// q [B, Lq, H, D], k and v [B, Lk, H, D] are read in place by strides (a
// cached prefill passes a strided view of its KV cache); o is [B, Lq, H, D]
// contiguous, in q's type. float32 or bfloat16 operands, float32 scores,
// softmax statistics and accumulation; for bfloat16 the probabilities drop
// to bfloat16 before the PV product, as the TPU kernel does. D <= 128.
// None of the TPU layout is carried over: no D->128 lane padding, no
// L->block padding, no [B*H] fold with its transposed copies, no
// all-lanes-equal lse.
//
// Bound on this card (H100 SXM, 700 W), at the GPT-2 prefill shape B = 16,
// Lq = Lk = 128, H = 12, D = 64, causal, float32: ~0.41 GFLOP (QK and PV
// over the causal half) = 0.006 ms at 67 TFLOP/s; q, k, v, o are 25.2 MB
// = 0.0075 ms at 3.35 TB/s. So bytes bound it, barely: attention at short
// lengths sits on the ridge, and the work per block is small.
//
// What the design does about it:
// - One block per (64-row Q tile, head, batch row): 384 blocks at the GPT-2
//   prefill shape, ~3 per SM. It loops over 64-key tiles staged in shared
//   memory; scores and probabilities never reach device memory. Online
//   (max, sum) per row in registers, float32 accumulators in registers.
// - 256 threads, four per query row. A thread scores 16 keys (columns
//   c, c+4, ...) with float4 shared-memory reads (rows padded to D+4 floats,
//   so the four keys a warp reads at once fall in different banks), reduces
//   the row's max and sum over its four lanes with shuffles, and owns D/4
//   output columns (interleaved float4 chunks) for the PV product.
// - Causal: key tiles wholly above the diagonal are skipped, as the TPU
//   kernel skips them. They are visited after all only when some row of the
//   tile has seen no valid key yet: its masked columns carry weight 1 each,
//   so the result equals the plain version's uniform average exactly.
// - The key mask is read per tile as [B, Lk], never broadcast over heads.
// - float32 FMAs on the CUDA cores, no wgmma/TMA and no double-buffering
//   yet: a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int NT = 256;       // threads: 4 per query row
constexpr int KPT = BN / 4;   // keys scored per thread
constexpr float NEG = -1e30f; // the masked-score sentinel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared-memory bytes for a head width padded to DP
constexpr size_t smem_bytes(int DP) {
  return (3 * BM * (DP + 4) + BM * (BN + 1)) * sizeof(float) + BN * sizeof(int);
}

struct Args {
  const void* q; const void* k; const void* v; const uint8_t* mask;
  void* out; float* lse;
  int Lq, Lk, H, D;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, msb;
  float scale; int causal, q_offset;
};

template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Args a) {
  constexpr int RS = DP + 4;  // shared row stride (floats)
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * RS;
  float* sV = sK + BN * RS;
  float* sP = sV + BN * RS;                         // [BM][BN + 1]
  int* sOk = reinterpret_cast<int*>(sP + BM * (BN + 1));  // per key: 1 valid, 0 masked, -1 past Lk

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + r;
  const long long qpos = static_cast<long long>(a.q_offset) + row;

  for (int i = tid; i < BM * DP; i += NT) {
    const int rr = i / DP, d = i % DP;
    float x = 0.f;
    if (q0 + rr < a.Lq && d < a.D)
      x = to_f(q[b * a.qsb + (q0 + rr) * a.qsl + h * a.qsh + d]);
    sQ[rr * RS + d] = x;
  }

  float m_i = NEG, l_i = 0.f;
  float acc[DP / 4];
#pragma unroll
  for (int t = 0; t < DP / 4; ++t) acc[t] = 0.f;

  auto tile = [&](int kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's sK, sV, sOk are consumed
    for (int i = tid; i < BN * DP; i += NT) {
      const int j = i / DP, d = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < a.Lk && d < a.D) {
        kx = to_f(k[b * a.ksb + (k0 + j) * a.ksl + h * a.ksh + d]);
        vx = to_f(v[b * a.vsb + (k0 + j) * a.vsl + h * a.vsh + d]);
      }
      sK[j * RS + d] = kx;
      sV[j * RS + d] = vx;
    }
    if (tid < BN) {
      const int col = k0 + tid;
      sOk[tid] = col >= a.Lk ? -1 : (a.mask ? (a.mask[b * a.msb + col] != 0) : 1);
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(sQ + r * RS + d);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float4 kb = *reinterpret_cast<const float4*>(sK + (c + 4 * i) * RS + d);
        s[i] = fmaf(qa.x, kb.x, s[i]);
        s[i] = fmaf(qa.y, kb.y, s[i]);
        s[i] = fmaf(qa.z, kb.z, s[i]);
        s[i] = fmaf(qa.w, kb.w, s[i]);
      }
    }

    float tmax = NEG;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = c + 4 * i;
      const int ok = sOk[j];
      float x;
      if (ok < 0) x = -INFINITY;  // past Lk: no weight at all, even in an all-masked row
      else if (!ok || (a.causal && k0 + j > qpos)) x = NEG;
      else x = s[i] * a.scale;
      s[i] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);  // >= NEG: finite
    const float corr = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      // bfloat16 operands: P drops to bfloat16 before PV, the sum stays f32
      sP[r * (BN + 1) + c + 4 * i] = to_f(from_f<T>(p));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * corr + psum;
    m_i = m_new;
#pragma unroll
    for (int t = 0; t < DP / 4; ++t) acc[t] *= corr;
    __syncwarp();  // row r's probabilities come from its own four lanes

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float p = sP[r * (BN + 1) + j];
#pragma unroll
      for (int t = 0; t < DP / 16; ++t) {
        const float4 vb = *reinterpret_cast<const float4*>(sV + j * RS + (4 * t + c) * 4);
        acc[4 * t + 0] = fmaf(p, vb.x, acc[4 * t + 0]);
        acc[4 * t + 1] = fmaf(p, vb.y, acc[4 * t + 1]);
        acc[4 * t + 2] = fmaf(p, vb.z, acc[4 * t + 2]);
        acc[4 * t + 3] = fmaf(p, vb.w, acc[4 * t + 3]);
      }
    }
  };

  const int nkt = (a.Lk + BN - 1) / BN;
  int kt_end = nkt;
  if (a.causal) {
    const long long last = static_cast<long long>(a.q_offset) + min(q0 + BM, a.Lq) - 1;
    kt_end = static_cast<int>(min(static_cast<long long>(nkt), last / BN + 1));
  }
  int kt = 0;
  for (; kt < kt_end; ++kt) tile(kt);
  // tiles above the diagonal carry weight only for rows with no valid key
  if (kt < nkt && __syncthreads_or(row < a.Lq && m_i <= NEG))
    for (; kt < nkt; ++kt) tile(kt);

  if (row < a.Lq) {
    const float l = fmaxf(l_i, 1e-30f);
    T* o = static_cast<T*>(a.out) + ((static_cast<long long>(b) * a.Lq + row) * a.H + h) * a.D;
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (4 * t + c) * 4 + e;
        if (d < a.D) o[d] = from_f<T>(acc[4 * t + e] / l);
      }
    if (a.lse && c == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Lq + row] = m_i + logf(l);
  }
}

template <typename T, int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DP);
  // above 48 KB only after opting in; once per device (a bit per device
  // id), so that launches, and their capture in a CUDA graph, skip it
  static unsigned long long opted_in = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(opted_in >> dev & 1ull)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in |= 1ull << dev;
  }
  const dim3 grid((a.Lq + BM - 1) / BM, a.H, B);
  flash_fwd_kernel<T, DP><<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 16) return launch<T, 16>(a, B, stream);
  if (a.D <= 32) return launch<T, 32>(a, B, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  return launch<T, 128>(a, B, stream);
}

}  // namespace

// C entry, bound with ctypes (sparkdl_torch/ops/flash_attention.py).
// q [B, Lq, H, D], k and v [B, Lk, H, D]: float32 (bf16 = 0) or bfloat16
// (bf16 = 1), strides in elements, the last dimension contiguous. mask:
// bool [B, Lk] with batch stride msb and contiguous columns, or null for
// no key mask. out: [B, Lq, H, D] contiguous in the operands' type. lse:
// float32 [B, H, Lq] contiguous, or null. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 on
// success). The caller checks shapes: 1 <= D <= 128, Lk >= 1, B, Lq >= 1.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, float* lse, int bf16, int B, int Lq, int Lk, int H,
                                   int D, long long qsb, long long qsl, long long qsh,
                                   long long ksb, long long ksl, long long ksh, long long vsb,
                                   long long vsl, long long vsh, long long msb, float scale,
                                   int causal, int q_offset, void* stream) {
  const Args a{q, k, v, static_cast<const uint8_t*>(mask), out, lse, Lq, Lk, H, D,
               qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, msb, scale, causal, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(a, B, st) : launch_d<float>(a, B, st);
}
