// Flash attention backward as two CUDA kernels for Hopper (sm_90a).
//
// Replaces: sparkdl_tpu/ops/flash_attention.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the Pallas backward, reached through the custom VJP
// _flash -> _flash_bwd -> _bwd). Same function, read for what it computes:
//
//   p[i, j]  = exp(s[i, j] - lse[i])      s = (q_i . k_j) * scale, masked -1e30
//   dp[i, j] = dO_i . v_j
//   ds[i, j] = p[i, j] * (dp[i, j] - delta[i]) * scale    (0 where masked)
//   dq_i = sum_j ds[i, j] k_j      dk_j = sum_i ds[i, j] q_i
//   dv_j = sum_i p[i, j] dO_i
//
// with lse the forward's float32 logsumexp [B, H, Lq] and delta =
// rowsum(dO * O) in float32 [B, H, Lq], computed by the caller. A key is
// masked when kv_mask[b, j] is false or, causal, when j > q_offset + i.
//
// All-masked query rows (no valid key, e.g. a pad row): the forward gives
// them the uniform average of the Lk value rows and an lse of -1e30 (the
// sentinel swallows log Lk in float32), so exp(s - lse) would give p = 1.
// The plain backward (autograd of the forward's plain version) has
// p = 1/Lk there: dv_j gets dO_i / Lk from every key j, and dq, dk get
// nothing (every score of the row is masked, so ds = 0). Both kernels
// detect such a row by lse <= -1e29 and use exactly that.
//
// q, k, v, dO [B, L, H, D] are read in place by strides (last dim
// contiguous); dq, dk, dv are written [B, L, H, D] contiguous in the
// operands' type. float32 or bfloat16 operands, float32 scores and
// accumulation; for bfloat16, p drops to bfloat16 before the dv product
// (as the forward drops it before PV) and ds before the dq and dk
// products (as the TPU kernels do). D <= 128.
//
// Bound on this card (H100 SXM, 700 W), at the BERT-base fine-tune shape
// B = 32, L = 128, H = 12, D = 64, float32, not causal: the dq kernel
// does 3 products of 2*B*H*L^2*D = 0.81 GFLOP each, the dk/dv kernel 4;
// 5.6 GFLOP together = 0.084 ms at 67 TFLOP/s f32. Bytes: q, k, v, dO in,
// dq, dk, dv out, 25.2 MB x 7/4 = 44 MB = 0.013 ms at 3.35 TB/s. So
// operations bound it (on the CUDA cores; the tensor cores are later work).
//
// What the design does about it:
// - No atomics: every output tile has one owner. The dq kernel is one
//   block per (64-row q tile, head, batch row), looping over 64-key tiles;
//   the dk/dv kernel one block per (64-key tile, head, batch row), looping
//   over 64-row q tiles. The TPU's sequential grid axis becomes that loop.
// - Scores, p and ds never reach device memory: they live in registers
//   and in one (two for dk/dv) 64 x 65 shared-memory tile.
// - 256 threads, four per output row, the forward kernel's layout: a
//   thread scores 16 columns (c, c+4, ...) with float4 shared-memory reads
//   (rows padded to D+4 floats against bank conflicts) and owns D/4 output
//   columns (interleaved float4 chunks) of its row.
// - Causally dead tiles are skipped, as the TPU kernels skip them; the
//   dk/dv kernel visits one after all only when a row of the q tile has no
//   valid key (its p = 1/Lk reaches every key).
// - float32 FMAs on the CUDA cores, no wgmma/TMA, no double-buffering:
//   a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int NT = 256;       // threads: 4 per output row
constexpr int CPT = 16;       // columns scored per thread (64 / 4)
constexpr float NEG = -1e30f; // the masked-score sentinel
constexpr float DEAD = -1e29f; // lse at or below: a row with no valid key

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout; const uint8_t* mask;
  const float* lse; const float* delta;  // [B, H, Lq] contiguous
  void* dq; void* dk; void* dv;          // [B, L, H, D] contiguous
  int Lq, Lk, H, D;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh, msb;
  float scale; int causal, q_offset;
};

// rows [r0, r0 + BM) of a strided [B, L, H, D] tensor -> shared [BM][DP + 4]
// as float, zero past L and past D
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int L,
                                          long long sb, long long sl, long long sh,
                                          int b, int h, int D) {
  constexpr int RS = DP + 4;
  for (int i = threadIdx.x; i < BM * DP; i += NT) {
    const int rr = i / DP, d = i % DP;
    float x = 0.f;
    if (r0 + rr < L && d < D) x = to_f(src[b * sb + (r0 + rr) * sl + h * sh + d]);
    dst[rr * RS + d] = x;
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (4 * BM * (DP + 4) + BM * (BN + 1)) * sizeof(float) + BN * sizeof(int);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return (4 * BM * (DP + 4) + 2 * BN * (BM + 1) + 2 * BM) * sizeof(float);
}

// dq: one block per (q tile, head, batch row)
template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const Args a) {
  constexpr int RS = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = sQ + BM * RS;   // dO
  float* sK = sO + BM * RS;
  float* sV = sK + BN * RS;
  float* sS = sV + BN * RS;   // ds [BM][BN + 1]
  int* sOk = reinterpret_cast<int*>(sS + BM * (BN + 1));  // per key: 1 valid, 0 masked, -1 past Lk

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int row = q0 + r;
  const long long qpos = static_cast<long long>(a.q_offset) + row;

  load_tile<T, DP>(sQ, q, q0, a.Lq, a.qsb, a.qsl, a.qsh, b, h, a.D);
  load_tile<T, DP>(sO, dout, q0, a.Lq, a.osb, a.osl, a.osh, b, h, a.D);
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Lq + row;
  const float lse = row < a.Lq ? a.lse[stat] : 0.f;
  const float delta = row < a.Lq ? a.delta[stat] : 0.f;
  // a row with no valid key has ds = 0 everywhere: it adds nothing to dq
  const bool live_row = row < a.Lq && lse > DEAD;

  float acc[DP / 4];
#pragma unroll
  for (int t = 0; t < DP / 4; ++t) acc[t] = 0.f;

  const int nkt = (a.Lk + BN - 1) / BN;
  int kt_end = nkt;
  if (a.causal) {
    const long long last = static_cast<long long>(a.q_offset) + min(q0 + BM, a.Lq) - 1;
    kt_end = static_cast<int>(min(static_cast<long long>(nkt), last / BN + 1));
  }
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's sK, sV, sS, sOk are consumed
    load_tile<T, DP>(sK, k, k0, a.Lk, a.ksb, a.ksl, a.ksh, b, h, a.D);
    load_tile<T, DP>(sV, v, k0, a.Lk, a.vsb, a.vsl, a.vsh, b, h, a.D);
    if (tid < BN) {
      const int col = k0 + tid;
      sOk[tid] = col >= a.Lk ? -1 : (a.mask ? (a.mask[b * a.msb + col] != 0) : 1);
    }
    __syncthreads();

    float s[CPT], dp[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(sQ + r * RS + d);
      const float4 oa = *reinterpret_cast<const float4*>(sO + r * RS + d);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float4 kb = *reinterpret_cast<const float4*>(sK + (c + 4 * i) * RS + d);
        const float4 vb = *reinterpret_cast<const float4*>(sV + (c + 4 * i) * RS + d);
        s[i] = fmaf(qa.x, kb.x, fmaf(qa.y, kb.y, fmaf(qa.z, kb.z, fmaf(qa.w, kb.w, s[i]))));
        dp[i] = fmaf(oa.x, vb.x, fmaf(oa.y, vb.y, fmaf(oa.z, vb.z, fmaf(oa.w, vb.w, dp[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int j = c + 4 * i;
      float ds = 0.f;
      if (live_row && sOk[j] > 0 && !(a.causal && k0 + j > qpos)) {
        const float p = expf(s[i] * a.scale - lse);
        ds = p * (dp[i] - delta) * a.scale;
      }
      sS[r * (BN + 1) + j] = to_f(from_f<T>(ds));
    }
    __syncwarp();  // row r's ds come from its own four lanes

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float ds = sS[r * (BN + 1) + j];
#pragma unroll
      for (int t = 0; t < DP / 16; ++t) {
        const float4 kb = *reinterpret_cast<const float4*>(sK + j * RS + (4 * t + c) * 4);
        acc[4 * t + 0] = fmaf(ds, kb.x, acc[4 * t + 0]);
        acc[4 * t + 1] = fmaf(ds, kb.y, acc[4 * t + 1]);
        acc[4 * t + 2] = fmaf(ds, kb.z, acc[4 * t + 2]);
        acc[4 * t + 3] = fmaf(ds, kb.w, acc[4 * t + 3]);
      }
    }
  }

  if (row < a.Lq) {
    T* o = static_cast<T*>(a.dq) + ((static_cast<long long>(b) * a.Lq + row) * a.H + h) * a.D;
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (4 * t + c) * 4 + e;
        if (d < a.D) o[d] = from_f<T>(acc[4 * t + e]);
      }
  }
}

// dk, dv: one block per (key tile, head, batch row)
template <typename T, int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const Args a) {
  constexpr int RS = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + BN * RS;
  float* sQ = sV + BN * RS;
  float* sO = sQ + BM * RS;   // dO
  float* sP = sO + BM * RS;   // p  [BN][BM + 1], key-major
  float* sS = sP + BN * (BM + 1);  // ds [BN][BM + 1]
  float* sLse = sS + BN * (BM + 1);
  float* sDelta = sLse + BM;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int k0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int key = k0 + r;
  const bool key_in = key < a.Lk;
  const bool key_ok = key_in && (a.mask ? a.mask[b * a.msb + key] != 0 : true);
  const float inv_lk = 1.f / static_cast<float>(a.Lk);

  load_tile<T, DP>(sK, k, k0, a.Lk, a.ksb, a.ksl, a.ksh, b, h, a.D);
  load_tile<T, DP>(sV, v, k0, a.Lk, a.vsb, a.vsl, a.vsh, b, h, a.D);

  float acc_k[DP / 4], acc_v[DP / 4];
#pragma unroll
  for (int t = 0; t < DP / 4; ++t) acc_k[t] = acc_v[t] = 0.f;

  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.Lq;
  const int nqt = (a.Lq + BM - 1) / BM;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // the previous tile's sQ, sO, sP, sS, sLse are consumed
    bool any_dead = false;
    if (tid < BM) {
      const int row = q0 + tid;
      const float lse = row < a.Lq ? a.lse[stat0 + row] : 0.f;
      sLse[tid] = lse;
      sDelta[tid] = row < a.Lq ? a.delta[stat0 + row] : 0.f;
      any_dead = row < a.Lq && lse <= DEAD;
    }
    // causally dead for every key of the tile: the tile's last query sits
    // before its first key. Visited only for rows with no valid key.
    const bool causal_dead = a.causal && static_cast<long long>(a.q_offset) +
                                             min(q0 + BM, a.Lq) - 1 < k0;
    if (__syncthreads_or(any_dead) == 0 && causal_dead) continue;
    load_tile<T, DP>(sQ, q, q0, a.Lq, a.qsb, a.qsl, a.qsh, b, h, a.D);
    load_tile<T, DP>(sO, dout, q0, a.Lq, a.osb, a.osl, a.osh, b, h, a.D);
    __syncthreads();

    float s[CPT], dp[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(sK + r * RS + d);
      const float4 va = *reinterpret_cast<const float4*>(sV + r * RS + d);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float4 qb = *reinterpret_cast<const float4*>(sQ + (c + 4 * i) * RS + d);
        const float4 ob = *reinterpret_cast<const float4*>(sO + (c + 4 * i) * RS + d);
        s[i] = fmaf(ka.x, qb.x, fmaf(ka.y, qb.y, fmaf(ka.z, qb.z, fmaf(ka.w, qb.w, s[i]))));
        dp[i] = fmaf(va.x, ob.x, fmaf(va.y, ob.y, fmaf(va.z, ob.z, fmaf(va.w, ob.w, dp[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int qi = c + 4 * i, row = q0 + qi;
      const float lse = sLse[qi];
      float p = 0.f, ds = 0.f;
      if (row < a.Lq && key_in) {
        if (lse <= DEAD) {
          p = inv_lk;  // no valid key in the row: uniform over all Lk keys
        } else if (key_ok && !(a.causal && static_cast<long long>(key) >
                                               static_cast<long long>(a.q_offset) + row)) {
          p = expf(s[i] * a.scale - lse);
          ds = p * (dp[i] - sDelta[qi]) * a.scale;
        }
      }
      sP[r * (BM + 1) + qi] = to_f(from_f<T>(p));
      sS[r * (BM + 1) + qi] = to_f(from_f<T>(ds));
    }
    __syncwarp();  // key row r's p and ds come from its own four lanes

#pragma unroll 4
    for (int i = 0; i < BM; ++i) {
      const float p = sP[r * (BM + 1) + i];
      const float ds = sS[r * (BM + 1) + i];
#pragma unroll
      for (int t = 0; t < DP / 16; ++t) {
        const float4 ob = *reinterpret_cast<const float4*>(sO + i * RS + (4 * t + c) * 4);
        const float4 qb = *reinterpret_cast<const float4*>(sQ + i * RS + (4 * t + c) * 4);
        acc_v[4 * t + 0] = fmaf(p, ob.x, acc_v[4 * t + 0]);
        acc_v[4 * t + 1] = fmaf(p, ob.y, acc_v[4 * t + 1]);
        acc_v[4 * t + 2] = fmaf(p, ob.z, acc_v[4 * t + 2]);
        acc_v[4 * t + 3] = fmaf(p, ob.w, acc_v[4 * t + 3]);
        acc_k[4 * t + 0] = fmaf(ds, qb.x, acc_k[4 * t + 0]);
        acc_k[4 * t + 1] = fmaf(ds, qb.y, acc_k[4 * t + 1]);
        acc_k[4 * t + 2] = fmaf(ds, qb.z, acc_k[4 * t + 2]);
        acc_k[4 * t + 3] = fmaf(ds, qb.w, acc_k[4 * t + 3]);
      }
    }
  }

  if (key_in) {
    const long long base = ((static_cast<long long>(b) * a.Lk + key) * a.H + h) * a.D;
    T* ok = static_cast<T*>(a.dk) + base;
    T* ov = static_cast<T*>(a.dv) + base;
#pragma unroll
    for (int t = 0; t < DP / 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (4 * t + c) * 4 + e;
        if (d < a.D) {
          ok[d] = from_f<T>(acc_k[4 * t + e]);
          ov[d] = from_f<T>(acc_v[4 * t + e]);
        }
      }
  }
}

// above 48 KB of shared memory only after opting in; once per kernel and
// device (a bit per device id), so that launches, and their capture in a
// CUDA graph, skip it
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

template <typename T, int DP>
int launch_dq(const Args& a, int B, cudaStream_t stream) {
  static unsigned long long opted_in = 0;
  const size_t bytes = dq_smem_bytes<DP>();
  cudaError_t err = opt_in(flash_bwd_dq_kernel<T, DP>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lq + BM - 1) / BM, a.H, B);
  flash_bwd_dq_kernel<T, DP><<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dkv(const Args& a, int B, cudaStream_t stream) {
  static unsigned long long opted_in = 0;
  const size_t bytes = dkv_smem_bytes<DP>();
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<T, DP>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Lk + BN - 1) / BN, a.H, B);
  flash_bwd_dkv_kernel<T, DP><<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int B, int which, cudaStream_t stream) {
  if (which == 0) {
    if (a.D <= 16) return launch_dq<T, 16>(a, B, stream);
    if (a.D <= 32) return launch_dq<T, 32>(a, B, stream);
    if (a.D <= 64) return launch_dq<T, 64>(a, B, stream);
    return launch_dq<T, 128>(a, B, stream);
  }
  if (a.D <= 16) return launch_dkv<T, 16>(a, B, stream);
  if (a.D <= 32) return launch_dkv<T, 32>(a, B, stream);
  if (a.D <= 64) return launch_dkv<T, 64>(a, B, stream);
  return launch_dkv<T, 128>(a, B, stream);
}

}  // namespace

// C entry, bound with ctypes (sparkdl_torch/ops/flash_attention.py).
// which = 0 launches the dq kernel (writes dq), 1 the dk/dv kernel (writes
// dk, dv). q [B, Lq, H, D], k and v [B, Lk, H, D], dout [B, Lq, H, D]:
// float32 (bf16 = 0) or bfloat16 (bf16 = 1), strides in elements, the last
// dimension contiguous. mask: bool [B, Lk] with batch stride msb and
// contiguous columns, or null. lse, delta: float32 [B, H, Lq] contiguous.
// dq [B, Lq, H, D], dk and dv [B, Lk, H, D] contiguous in the operands'
// type. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success). The caller checks
// shapes: 1 <= D <= 128, Lk >= 1, B, Lq, H >= 1.
extern "C" int flash_attention_bwd(int which, const void* q, const void* k, const void* v,
                                   const void* dout, const void* mask, const float* lse,
                                   const float* delta, void* dq, void* dk, void* dv, int bf16,
                                   int B, int Lq, int Lk, int H, int D, long long qsb,
                                   long long qsl, long long qsh, long long ksb, long long ksl,
                                   long long ksh, long long vsb, long long vsl, long long vsh,
                                   long long osb, long long osl, long long osh, long long msb,
                                   float scale, int causal, int q_offset, void* stream) {
  const Args a{q, k, v, dout, static_cast<const uint8_t*>(mask), lse, delta, dq, dk, dv,
               Lq, Lk, H, D, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh,
               msb, scale, causal, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(a, B, which, st) : launch_d<float>(a, B, which, st);
}
