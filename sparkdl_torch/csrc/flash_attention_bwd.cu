// Flash attention backward as two CUDA kernels for Hopper (sm_90a), on the
// tensor cores at float32 accuracy.
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
// B = 32, L = 128, H = 12, D = 64, float32, not causal (chip_smoke.py's
// count). One L x L x D product is 2*B*H*L^2*D = 0.805 GFLOP; dq does 3,
// dk/dv 4. Bytes, each input read once and each output written once: a
// [B, L, H, D] tensor is 12.58 MB, lse and delta 0.39 MB together; dq reads
// q, dO, k, v and writes dq: 63.3 MB = 0.0189 ms at 3.35 TB/s; dk/dv reads
// the same and writes dk, dv: 75.9 MB = 0.0227 ms.
// - On the CUDA cores (67 TFLOP/s f32): 0.0361 and 0.0481 ms, operations.
// - On the tensor cores as 3xTF32 (three TF32 passes per product, 495
//   TFLOP/s): 7.25 and 9.66 GFLOP = 0.0146 and 0.0195 ms, so bytes bound
//   both kernels: 0.0189 and 0.0227 ms.
//
// What the design does about it:
// - Tensor cores through mma.sync (mma_tf32x3.cuh). float32: m16n8k8 TF32
//   with the 3xTF32 split (x = big + small, small*big + big*small +
//   big*big into a float32 accumulator), float32 accuracy at a third of
//   the TF32 rate, 2.5x the CUDA cores' float32 peak. bfloat16: m16n8k16 in
//   one pass. Not wgmma: wgmma takes TF32 only K-major from shared memory,
//   and dk = ds^T q and dv = p^T dO contract over the query index, so they
//   would need a transpose in shared memory; mma.sync fragments are loaded
//   by address, so the transpose is an indexing choice. wgmma is later work.
// - One owner per output tile, no atomics: bitwise reproducible. The dq
//   kernel is one block per (64-row q tile, head, batch row), looping over
//   16-key tiles; the dk/dv kernel one block per (64-key tile, head, batch
//   row), looping over 16-row q tiles. The TPU's sequential grid axis
//   becomes that loop. 4 warps; each owns 16 of the block's 64 rows (dq:
//   query rows; dk/dv: keys) and builds its 16 x 16 scores S and dP (dk/dv:
//   S^T and dP^T, key-major, so p and ds come out laid out for dv and dk)
//   in mma accumulator registers, where p and ds are computed. Scores, p
//   and ds never reach shared or device memory.
// - Accumulator to A operand without moving data. For TF32 m16n8k8 the
//   accumulator layout (lane holds columns 2t, 2t+1 of rows g, g+8) is not
//   the A layout (columns t, t+4). Neither __shfl_sync nor a staging tile:
//   a product sums over its k index in any order, so the second product
//   numbers its 8 contracted rows as 0, 2, 4, 6, 1, 3, 5, 7. Then a lane's
//   accumulator (c0, c1, c2, c3) is its A fragment (a0, a2, a1, a3) as it
//   stands, and the B fragment reads rows 2t and 2t + 1 of the shared tile
//   (Op<float>::load_b_kn). bfloat16 m16n8k16 needs no renumbering: two
//   accumulator tiles pack into one A fragment, as in FlashAttention-2.
// - Accuracy. An mma rounds the running sum it is handed by the tensor
//   cores' own rule, so a long chain of them drifts. S and dP sum each
//   k-step from zero and add it in float32 (mma_tf32x3_rn): their error
//   enters exp() and through p every gradient. dq, dk and dv chain through
//   their accumulators. On the H100, chaining all five products put BERT's
//   first-step gradients 1.5e-4 from the dense path; this split gives
//   3.1e-5, as summing all five from zero does, in 4% less time
//   (tools/flash_bwd_variants.py).
// - Shared-memory rows are padded by 16 bytes (4 floats, 8 bf16), so the
//   32-bit fragment loads of a warp fall in 32 different banks (row stride
//   = 4 words mod 32: lane (g, t) hits bank 4g + t, or 8t + g transposed).
// - Loads: a two-stage ring, 16-byte cp.async. The loop tile t + 1 (dq: K
//   and V; dk/dv: Q, dO, lse and delta) is issued before tile t is
//   computed. Operands stay in their own type in shared memory and are
//   converted (split into TF32 pairs) as fragments are loaded. Where a row
//   cannot be read as 16-byte chunks (D not a multiple of 4 floats or 8
//   bf16, a stride or base off a 16-byte boundary), load_rows takes its
//   scalar path in the same kernel: element loads with zero fill, not
//   overlapped with compute. Rows past L and columns past D are zeros.
// - Occupancy: 128 threads. At D = 64 in float32 a block holds 51 KB of
//   shared memory (its own 64 rows of two operands, and the two-stage ring
//   of 16-row tiles of two operands) and 168 registers a thread, so 3
//   blocks fit on an SM (registers bind). At the BERT shape on the H100,
//   32-row loop tiles ran 4% slower (tools/flash_bwd_variants.py).
// - Causally dead tiles are skipped; the dk/dv kernel visits one after all
//   when a row of it has no valid key (its p = 1/Lk reaches every key),
//   probing such tiles four at a time, a warp each.

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
constexpr int BO = 16 * NW;    // rows a block owns: 16 per warp
constexpr int BL = 16;         // rows of the tile the block loops over
constexpr int NJ = BL / 8;     // 8-column accumulator tiles across a loop tile
static_assert(BL % 16 == 0 && BL <= 32, "a bf16 k-step spans 16 rows; a probe, a warp's lanes");
constexpr float DEAD = -1e29f; // lse at or below: a row with no valid key

struct Args {
  const void* q; const void* k; const void* v; const void* dout; const uint8_t* mask;
  const float* lse; const float* delta;  // [B, H, Lq] contiguous
  void* dq; void* dk; void* dv;          // [B, L, H, D] contiguous
  int Lq, Lk, H, D;
  long long qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh, msb;
  float scale; int causal, q_offset;
  int vec_q, vec_k, vec_v, vec_o;        // rows readable as 16-byte chunks
};

template <typename T, int DP>
constexpr size_t dq_smem_bytes() {
  return (2 * BO + 4 * BL) * row_stride<T>(DP) * sizeof(T) + 2 * BL * sizeof(int);
}

template <typename T, int DP>
constexpr size_t dkv_smem_bytes() {
  return (2 * BO + 4 * BL) * row_stride<T>(DP) * sizeof(T) + 4 * BL * sizeof(float) +
         NW * sizeof(int);
}

// dq: one block per (64-row q tile, head, batch row)
template <typename T, int DP>
__global__ void __launch_bounds__(NT, DP <= 64 ? 3 : 1) flash_bwd_dq_kernel(const Args a) {
  constexpr int RS = row_stride<T>(DP);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + BO * RS;      // dO
  T* sK = sO + BO * RS;      // [2][BL][RS]
  T* sV = sK + 2 * BL * RS;  // [2][BL][RS]
  int* sOk = reinterpret_cast<int*>(sV + 2 * BL * RS);  // [2][BL]: key valid

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int q0 = blockIdx.x * BO, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.osb + h * a.osh;
  const uint8_t* mask = a.mask ? a.mask + b * a.msb : nullptr;
  auto key_ok = [&](int col) -> int { return col < a.Lk && (!mask || mask[col] != 0); };

  const int nkt = (a.Lk + BL - 1) / BL;
  int kt_end = nkt;
  if (a.causal) {
    const long long last = static_cast<long long>(a.q_offset) + min(q0 + BO, a.Lq) - 1;
    kt_end = static_cast<int>(min(static_cast<long long>(nkt), last / BL + 1));
  }

  load_rows<T, DP, BO, NT>(sQ, q, q0, a.Lq, a.qsl, a.D, a.vec_q);
  load_rows<T, DP, BO, NT>(sO, dout, q0, a.Lq, a.osl, a.D, a.vec_o);
  load_rows<T, DP, BL, NT>(sK, k, 0, a.Lk, a.ksl, a.D, a.vec_k);
  load_rows<T, DP, BL, NT>(sV, v, 0, a.Lk, a.vsl, a.D, a.vec_v);
  mma3::cp_async_commit();
  if (tid < BL) sOk[tid] = key_ok(tid);

  // this lane's two query rows
  const int row0 = q0 + 16 * w + g;
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.Lq;
  float lse[2], delta[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < a.Lq ? a.lse[stat + row] : 0.f;
    delta[r] = row < a.Lq ? a.delta[stat + row] : 0.f;
    // a row with no valid key has ds = 0 everywhere: it adds nothing to dq
    live[r] = row < a.Lq && lse[r] > DEAD;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int buf = kt & 1, k0 = kt * BL;
    const bool more = kt + 1 < kt_end;
    const int next_ok = more && tid < BL ? key_ok(k0 + BL + tid) : 0;
    mma3::cp_async_wait_all();
    __syncthreads();  // tile kt has landed; tile kt - 1 (the other buffer) is consumed
    if (more) {
      load_rows<T, DP, BL, NT>(sK + (buf ^ 1) * BL * RS, k, k0 + BL, a.Lk, a.ksl, a.D, a.vec_k);
      load_rows<T, DP, BL, NT>(sV + (buf ^ 1) * BL * RS, v, k0 + BL, a.Lk, a.vsl, a.D, a.vec_v);
      mma3::cp_async_commit();
      if (tid < BL) sOk[(buf ^ 1) * BL + tid] = next_ok;
    }
    const T* tK = sK + buf * BL * RS;
    const int* ok = sOk + buf * BL;

    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    gemm_xyt<T, DP, NJ>(s, sQ + 16 * w * RS, tK, g, t);
    gemm_xyt<T, DP, NJ>(dp, sO + 16 * w * RS, sV + buf * BL * RS, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = 8 * j + 2 * t + (e & 1);
        float ds = 0.f;
        if (live[r] && ok[col] &&
            !(a.causal && k0 + col > static_cast<long long>(a.q_offset) + row0 + 8 * r)) {
          const float p = expf(s[j][e] * a.scale - lse[r]);
          ds = p * (dp[j][e] - delta[r]) * a.scale;
        }
        s[j][e] = ds;
      }
    gemm_cy<T, DP, NJ, false>(acc, s, tK, g, t);
  }
  mma3::cp_async_wait_all();

  const long long row_elems = static_cast<long long>(a.H) * a.D;
  store_rows<T, DP>(static_cast<T*>(a.dq) + (static_cast<long long>(b) * a.Lq * a.H + h) * a.D,
                    acc, row0, row0 < a.Lq, row0 + 8 < a.Lq, a.D, row_elems, t);
}

// dk, dv: one block per (64-key tile, head, batch row)
template <typename T, int DP>
__global__ void __launch_bounds__(NT, DP <= 64 ? 3 : 1) flash_bwd_dkv_kernel(const Args a) {
  constexpr int RS = row_stride<T>(DP);
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BO * RS;
  T* sQ = sV + BO * RS;      // [2][BL][RS]
  T* sO = sQ + 2 * BL * RS;  // [2][BL][RS], dO
  float* sLse = reinterpret_cast<float*>(sO + 2 * BL * RS);  // [2][BL]
  float* sDelta = sLse + 2 * BL;                             // [2][BL]
  int* sProbe = reinterpret_cast<int*>(sDelta + 2 * BL);     // [NW]

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BO, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.osb + h * a.osh;
  const long long stat0 = (static_cast<long long>(b) * a.H + h) * a.Lq;
  const float* lse = a.lse + stat0;
  const float* delta = a.delta + stat0;
  const float inv_lk = 1.f / static_cast<float>(a.Lk);

  // this lane's two keys
  const int key0 = k0 + 16 * w + g;
  bool key_in[2], key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    key_in[r] = key < a.Lk;
    key_ok[r] = key_in[r] && (a.mask ? a.mask[b * a.msb + key] != 0 : true);
  }

  // q tiles from live_from on hold a query that may see a key of this block;
  // the tiles before are causally dead for all of them
  const int nqt = (a.Lq + BL - 1) / BL;
  int live_from = 0;
  if (a.causal) {
    const long long need = static_cast<long long>(k0) - a.q_offset;  // first row that sees key k0
    live_from = need <= 0 ? 0 : need > a.Lq - 1 ? nqt : static_cast<int>(need / BL);
  }
  // the first tile at or after qt that the block visits: causally live, or
  // holding a row with no valid key; dead tiles are probed a warp each
  auto next_tile = [&](int qt) -> int {
    for (int base = qt; base < live_from; base += NW) {
      const int cand = base + w, row = cand * BL + lane;
      const bool dead = cand < live_from && lane < BL && row < a.Lq && lse[row] <= DEAD;
      const int any = __any_sync(0xffffffffu, dead);
      __syncthreads();  // the previous probe is read
      if (lane == 0) sProbe[w] = any;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NW; ++i)
        if (sProbe[i]) return base + i;
    }
    return max(qt, live_from);
  };
  auto load_tile = [&](int qt, int buf) {
    const int q0 = qt * BL;
    load_rows<T, DP, BL, NT>(sQ + buf * BL * RS, q, q0, a.Lq, a.qsl, a.D, a.vec_q);
    load_rows<T, DP, BL, NT>(sO + buf * BL * RS, dout, q0, a.Lq, a.osl, a.D, a.vec_o);
    if (tid < 2 * BL) {
      const int i = tid % BL, row = q0 + i;
      const bool in = row < a.Lq;
      const float* src = tid < BL ? lse : delta;
      mma3::cp_async4((tid < BL ? sLse : sDelta) + buf * BL + i, in ? src + row : src, in);
    }
  };

  load_rows<T, DP, BO, NT>(sK, k, k0, a.Lk, a.ksl, a.D, a.vec_k);
  load_rows<T, DP, BO, NT>(sV, v, k0, a.Lk, a.vsl, a.D, a.vec_v);
  int cur = next_tile(0);
  if (cur < nqt) load_tile(cur, 0);
  mma3::cp_async_commit();

  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; cur < nqt; ++it) {
    const int buf = it & 1, q0 = cur * BL;
    const int nxt = next_tile(cur + 1);
    mma3::cp_async_wait_all();
    __syncthreads();  // tile cur has landed; the previous tile (other buffer) is consumed
    if (nxt < nqt) {
      load_tile(nxt, buf ^ 1);
      mma3::cp_async_commit();
    }
    const T* tQ = sQ + buf * BL * RS;
    const T* tO = sO + buf * BL * RS;
    const float* tLse = sLse + buf * BL;
    const float* tDelta = sDelta + buf * BL;

    float st[NJ][4], dpt[NJ][4];  // S^T, dP^T: [16 keys][32 query rows]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    gemm_xyt<T, DP, NJ>(st, sK + 16 * w * RS, tQ, g, t);
    gemm_xyt<T, DP, NJ>(dpt, sV + 16 * w * RS, tO, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qi = 8 * j + 2 * t + (e & 1), row = q0 + qi;
        const float l = tLse[qi];
        float p = 0.f, ds = 0.f;
        if (row < a.Lq && key_in[r]) {
          if (l <= DEAD) {
            p = inv_lk;  // no valid key in the row: uniform over all Lk keys
          } else if (key_ok[r] && !(a.causal && key0 + 8 * r >
                                                    static_cast<long long>(a.q_offset) + row)) {
            p = expf(st[j][e] * a.scale - l);
            ds = p * (dpt[j][e] - tDelta[qi]) * a.scale;
          }
        }
        dpt[j][e] = p;  // p^T, for dv
        st[j][e] = ds;  // ds^T, for dk
      }
    gemm_cy<T, DP, NJ, false>(acc_v, dpt, tO, g, t);
    gemm_cy<T, DP, NJ, false>(acc_k, st, tQ, g, t);
    cur = nxt;
  }
  mma3::cp_async_wait_all();

  const long long row_elems = static_cast<long long>(a.H) * a.D;
  const long long base = (static_cast<long long>(b) * a.Lk * a.H + h) * a.D;
  store_rows<T, DP>(static_cast<T*>(a.dk) + base, acc_k, key0, key_in[0], key_in[1], a.D,
                    row_elems, t);
  store_rows<T, DP>(static_cast<T*>(a.dv) + base, acc_v, key0, key_in[0], key_in[1], a.D,
                    row_elems, t);
}

// which = 0: the dq kernel, 1: the dk/dv kernel. attrs null: launch it;
// else fill attrs with its registers per thread, shared bytes per block,
// resident blocks per SM and local (spill) bytes per thread, and launch
// nothing
template <typename T, int DP>
int run(int which, const Args& a, int B, cudaStream_t stream, int* attrs) {
  static unsigned long long opted_in[2] = {0, 0};
  void (*kernel)(const Args) =
      which == 0 ? flash_bwd_dq_kernel<T, DP> : flash_bwd_dkv_kernel<T, DP>;
  const size_t bytes = which == 0 ? dq_smem_bytes<T, DP>() : dkv_smem_bytes<T, DP>();
  cudaError_t err = mma3::opt_in(kernel, bytes, opted_in[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attrs) return static_cast<int>(mma3::kernel_attrs(kernel, NT, bytes, attrs));
  const dim3 grid(((which == 0 ? a.Lq : a.Lk) + BO - 1) / BO, a.H, B);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_d(int which, const Args& a, int B, cudaStream_t stream, int* attrs) {
  if (a.D <= 16) return run<T, 16>(which, a, B, stream, attrs);
  if (a.D <= 32) return run<T, 32>(which, a, B, stream, attrs);
  if (a.D <= 64) return run<T, 64>(which, a, B, stream, attrs);
  return run<T, 128>(which, a, B, stream, attrs);
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
  const int elt = bf16 ? 2 : 4;
  const Args a{q, k, v, dout, static_cast<const uint8_t*>(mask), lse, delta, dq, dk, dv,
               Lq, Lk, H, D, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, osb, osl, osh,
               msb, scale, causal, q_offset,
               vec_rows(q, qsb, qsl, qsh, D, elt), vec_rows(k, ksb, ksl, ksh, D, elt),
               vec_rows(v, vsb, vsl, vsh, D, elt), vec_rows(dout, osb, osl, osh, D, elt)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run_d<__nv_bfloat16>(which, a, B, st, nullptr)
              : run_d<float>(which, a, B, st, nullptr);
}

// The build of one kernel: which = 0 dq, 1 dk/dv; bf16 and D select the
// instantiation as flash_attention_bwd does. Fills out[4] with registers
// per thread, shared bytes per block, resident blocks per SM (at 128
// threads) and local bytes per thread; returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_attrs(int which, int bf16, int D, int* out) {
  Args a{};
  a.D = D;
  return bf16 ? run_d<__nv_bfloat16>(which, a, 1, nullptr, out)
              : run_d<float>(which, a, 1, nullptr, out);
}
