// Flash attention forward as one CUDA kernel for Hopper (sm_90a), on the
// tensor cores at float32 accuracy.
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
// NaN can reach a later layer, and its lse is -1e30 (the sentinel swallows
// log Lk in float32), which the backward kernels read as "no valid key".
// With lse, it also writes the float32 logsumexp [B, H, Lq] the backward
// pass needs.
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
// Bound on this card (H100 SXM, 700 W; chip_smoke.py's count). QK and PV
// are 4 * B * H * D flops per (row, visible key). Bytes: q, k, v read once,
// o written once, the [B, Lk] mask.
// - GPT-2 prefill, B = 16, Lq = Lk = 128, H = 12, D = 64, causal, float32:
//   0.406 GFLOP; 25.2 MB = 0.0075 ms at 3.35 TB/s. On the CUDA cores (67
//   TFLOP/s f32) 0.0061 ms; on the tensor cores as 3xTF32 (three TF32
//   passes a product, 495 TFLOP/s) 0.0025 ms. Bytes bound it: 0.0075 ms.
// - BERT-base fine-tune, B = 32, L = 128, not causal: 1.61 GFLOP = 0.0240
//   ms on the CUDA cores, 0.0098 ms as 3xTF32; 50.3 MB = 0.0150 ms. Bytes
//   bound it on the tensor cores: 0.0150 ms.
//
// What the design does about it:
// - Tensor cores through mma.sync (mma_tf32x3.cuh). float32: m16n8k8 TF32
//   with the 3xTF32 split (x = big + small; small*big + big*small +
//   big*big into a float32 accumulator), float32 accuracy at a third of
//   the TF32 rate, 2.5x the CUDA cores' float32 peak. bfloat16: m16n8k16 in
//   one pass. The shape is the backward's dq kernel without dP: one block
//   per (64-row q tile, head, batch row), 4 warps of 16 owned query rows,
//   a loop over 32-key tiles of K and V.
// - S = Q.K^T lands in mma accumulator registers; the mask, the scale and
//   the online (max, sum) work there. A row's max reduces over its 4 lanes
//   with two shuffles; its sum stays a per-lane partial (every lane of a
//   row rescales by the same factor) and reduces once at the end. Scores
//   and probabilities never reach shared or device memory.
// - O += P.V: P goes from accumulator to A fragment with no shuffle, by
//   the k-renumbering of Op<float>::a_from_c / load_b_kn; for bfloat16 it
//   packs to bfloat16 pairs. O's accumulators are rescaled per row each
//   tile.
// - Accuracy. An mma rounds the running sum it is handed by the tensor
//   cores' own rule, so a chain of them drifts (the backward's finding).
//   Both products sum each k-step from zero and add it in float32
//   (mma_tf32x3_rn): S because its error enters exp(), O because the
//   backward reads it (delta = rowsum(dO * O) must agree with the p it
//   rebuilds). With O chained, the kernel's own errors stayed at 1e-6 but
//   BERT's first-step gradients came 1.47e-4 from the dense path, over
//   chip_smoke.py's 1e-4; from zero, 1.46e-5, for 5% more time
//   (tools/fwd_gemm_variants.py on an H100 80GB HBM3 at 700 W, as are the
//   other figures here).
// - Registers bind: 168 a thread, 3 blocks an SM at D <= 64 (8 bytes spill
//   at D = 64 f32). A budget for 4 blocks (128 registers, 56 bytes spill)
//   ran 5% slower, so did holding the warp's TF32-split Q fragments in
//   registers for the whole loop; 16-key tiles ran the same as 32.
// - Loads: Q once into shared memory (re-read each tile as fragments); K
//   and V through a two-stage ring of 16-byte cp.async copies, tile t + 1
//   requested before tile t is computed. Rows that
//   cannot be read as 16-byte chunks (D not a multiple of 4 floats or 8
//   bf16, a stride or base off a 16-byte boundary) take the scalar path in
//   the same kernel (attention_tiles.cuh load_rows). Rows past L and
//   columns past D are zeros; keys past Lk score -inf, so even an
//   all-masked row gives them no weight.
// - Causal: key tiles wholly above the diagonal are skipped, as the TPU
//   kernel skips them. They are visited after all only when some row of
//   the block has seen no valid key yet: its masked columns carry weight 1
//   each, so the result equals the plain version's uniform average exactly.
//   The running max starts at -1e30, not -inf, for the same reason.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

using attn::gemm_cy;
using attn::gemm_xyt;
using attn::load_rows;
using attn::store_rows;
using attn::vec_rows;
using mma3::row_stride;

constexpr int NW = 4;          // warps per block
constexpr int NT = 32 * NW;    // threads per block
constexpr int BO = 16 * NW;    // query rows a block owns: 16 per warp
constexpr int BL = 32;         // keys per loop tile
constexpr int NJ = BL / 8;     // 8-column accumulator tiles across a loop tile
static_assert(BL % 16 == 0, "a bf16 k-step of P.V spans 16 keys");
constexpr float NEG = -1e30f;  // the masked-score sentinel

struct Args {
  const void* q; const void* k; const void* v; const uint8_t* mask;
  void* out; float* lse;
  int Lq, Lk, H, D;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, msb;
  float scale; int causal, q_offset;
  int vec_q, vec_k, vec_v;  // rows readable as 16-byte chunks
};

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return (BO + 4 * BL) * row_stride<T>(DP) * sizeof(T) + 2 * BL * sizeof(int);
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, DP <= 64 ? 3 : 2) flash_fwd_kernel(const Args a) {
  constexpr int RS = row_stride<T>(DP);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BO * RS;      // [2][BL][RS]
  T* sV = sK + 2 * BL * RS;  // [2][BL][RS]
  int* sOk = reinterpret_cast<int*>(sV + 2 * BL * RS);  // [2][BL]: 1 valid, 0 masked, -1 past Lk

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int q0 = blockIdx.x * BO, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  const uint8_t* mask = a.mask ? a.mask + b * a.msb : nullptr;
  auto key_state = [&](int col) -> int {
    return col >= a.Lk ? -1 : (!mask || mask[col] != 0);
  };

  load_rows<T, DP, BO, NT>(sQ, q, q0, a.Lq, a.qsl, a.D, a.vec_q);
  mma3::cp_async_commit();

  // this lane's two query rows: row0 and row0 + 8
  const int row0 = q0 + 16 * w + g;
  const long long qpos0 = static_cast<long long>(a.q_offset) + row0;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nkt = (a.Lk + BL - 1) / BL;
  int stop = nkt;  // causal: the tiles from stop on are wholly above the diagonal
  if (a.causal) {
    const long long last = static_cast<long long>(a.q_offset) + min(q0 + BO, a.Lq) - 1;
    stop = static_cast<int>(min(static_cast<long long>(nkt), last / BL + 1));
  }
  // key tile kt -> ring buffer buf: K and V asynchronously, the key states
  auto fetch = [&](int kt, int buf) {
    load_rows<T, DP, BL, NT>(sK + buf * BL * RS, k, kt * BL, a.Lk, a.ksl, a.D, a.vec_k);
    load_rows<T, DP, BL, NT>(sV + buf * BL * RS, v, kt * BL, a.Lk, a.vsl, a.D, a.vec_v);
    mma3::cp_async_commit();
    if (tid < BL) sOk[buf * BL + tid] = key_state(kt * BL + tid);
  };

  fetch(0, 0);
  for (int kt = 0, buf = 0; kt < stop; ++kt, buf ^= 1) {
    const int k0 = kt * BL;
    mma3::cp_async_wait_all();
    __syncthreads();  // tile kt has landed; tile kt - 1 (the other buffer) is consumed
    if (kt + 1 < stop) fetch(kt + 1, buf ^ 1);
    const int* ok = sOk + buf * BL;

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    gemm_xyt<T, DP, NJ>(s, sQ + 16 * w * RS, sK + buf * BL * RS, g, t);

    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * t + (e & 1);
        const int st = ok[col];
        float x;
        if (st < 0) x = -INFINITY;  // past Lk: no weight at all, even in an all-masked row
        else if (!st || (a.causal && k0 + col > qpos0 + 8 * r)) x = NEG;
        else x = s[j][e] * a.scale;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // >= NEG: finite
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;  // float32; for bfloat16 P drops to bfloat16 in the product only
        s[j][e] = p;
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    gemm_cy<T, DP, NJ, true>(acc, s, sV + buf * BL * RS, g, t);

    // the tiles above the diagonal carry weight only for rows with no valid
    // key yet: visit them after all if the block has one (uniform branch)
    if (kt + 1 == stop && stop < nkt) {
      const bool dead = (row0 < a.Lq && m[0] <= NEG) || (row0 + 8 < a.Lq && m[1] <= NEG);
      if (__syncthreads_or(dead)) {  // also: every warp is done with both buffers
        stop = nkt;
        fetch(kt + 1, buf ^ 1);
      }
    }
  }
  mma3::cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= l[e >> 1];
  store_rows<T, DP>(static_cast<T*>(a.out) + (static_cast<long long>(b) * a.Lq * a.H + h) * a.D,
                    acc, row0, row0 < a.Lq, row0 + 8 < a.Lq, a.D,
                    static_cast<long long>(a.H) * a.D, t);
  if (a.lse && t == 0) {
    float* lse = a.lse + (static_cast<long long>(b) * a.H + h) * a.Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < a.Lq) lse[row0 + 8 * r] = m[r] + logf(l[r]);
  }
}

// attrs null: launch the kernel; else fill attrs with its registers per
// thread, shared bytes per block, resident blocks per SM and local (spill)
// bytes per thread, and launch nothing
template <typename T, int DP>
int run(const Args& a, int B, cudaStream_t stream, int* attrs) {
  static unsigned long long opted_in = 0;
  constexpr size_t bytes = smem_bytes<T, DP>();
  cudaError_t err = mma3::opt_in(flash_fwd_kernel<T, DP>, bytes, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attrs) return static_cast<int>(mma3::kernel_attrs(flash_fwd_kernel<T, DP>, NT, bytes,
                                                        attrs));
  const dim3 grid((a.Lq + BO - 1) / BO, a.H, B);
  flash_fwd_kernel<T, DP><<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_d(const Args& a, int B, cudaStream_t stream, int* attrs) {
  if (a.D <= 16) return run<T, 16>(a, B, stream, attrs);
  if (a.D <= 32) return run<T, 32>(a, B, stream, attrs);
  if (a.D <= 64) return run<T, 64>(a, B, stream, attrs);
  return run<T, 128>(a, B, stream, attrs);
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
  const int elt = bf16 ? 2 : 4;
  const Args a{q, k, v, static_cast<const uint8_t*>(mask), out, lse, Lq, Lk, H, D,
               qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, msb, scale, causal, q_offset,
               vec_rows(q, qsb, qsl, qsh, D, elt), vec_rows(k, ksb, ksl, ksh, D, elt),
               vec_rows(v, vsb, vsl, vsh, D, elt)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run_d<__nv_bfloat16>(a, B, st, nullptr) : run_d<float>(a, B, st, nullptr);
}

// The build of the kernel: bf16 and D select the instantiation as
// flash_attention_fwd does. Fills out[4] with registers per thread, shared
// bytes per block, resident blocks per SM (at 128 threads) and local bytes
// per thread; returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd_attrs(int bf16, int D, int* out) {
  Args a{};
  a.D = D;
  return bf16 ? run_d<__nv_bfloat16>(a, 1, nullptr, out) : run_d<float>(a, 1, nullptr, out);
}
