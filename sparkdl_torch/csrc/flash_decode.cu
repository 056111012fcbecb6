// Flash decode (one query over a dense KV cache) as one CUDA kernel for
// Hopper (sm_90a).
//
// Replaces: sparkdl_tpu/ops/flash_decode.py::_kernel (the Pallas decode
// kernel, reached through flash_decode). It computes the same function:
//
//   o[b, 0, h] = softmax_j(q[b, 0, h] . ck[b, j, h] / sqrt(D)) . cv[b, j, h]
//                over the cache columns j in [start[b], idx]
//
// where idx is this query's position (the newest written column, a host
// int) and start[b] the row's first valid column (left-padded prompts;
// null = 0). A row with start[b] > idx has no valid column; the plain
// version then averages every column with equal weight (all its scores are
// the -1e30 sentinel), and so does this kernel. float32 or bfloat16
// operands, float32 scores and accumulation, output in q's type. The
// cache [B, L, H, D] is read in place by strides: no [B*H] fold, no
// transposed copy, no D->128 lane padding.
//
// Bound on this card (H100 SXM, 700 W): decoding reads every live cache
// column once, 2 * B * H * D * (idx + 1 - start) elements, and does two
// FMAs per element read, so bytes bound it by far: at B = 16, H = 12,
// D = 64, idx = 159, float32 that is 15.7 MB, 0.0047 ms at 3.35 TB/s.
//
// What the design does about it:
// - One block per (head, batch row), 8 warps. Warps stride over the live
//   columns four at a time, so each warp has four K rows and four V rows
//   in flight; a lane holds D/32 elements of q, of each row and of the
//   accumulator, and neighbouring lanes read neighbouring addresses.
// - Per-warp online softmax (running max and sum in registers, the four
//   dot products reduced with shuffles), then one combine of the eight
//   warps' (max, sum, accumulator) in shared memory.
// - Columns outside [start, idx] are never read: the work follows the
//   row's real length, not the buffer's.
// - Scalar loads and FMAs, no TMA: a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NW = 8;          // warps per block
constexpr int NT = NW * 32;    // threads per block
constexpr int U = 4;           // columns per warp step
constexpr float NEG = -1e30f;  // the masked-score sentinel

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q; const void* ck; const void* cv; const int* start; void* out;
  int L, H, D, idx;
  long long qsb, qsh, ksb, ksl, ksh, vsb, vsl, vsh;
  float scale;
};

// EPL = elements per lane: D <= 32 * EPL
template <typename T, int EPL>
__global__ void __launch_bounds__(NT) flash_decode_kernel(const Args a) {
  __shared__ float s_m[NW], s_l[NW];
  __shared__ float s_acc[NW][32 * EPL];

  const T* q = static_cast<const T*>(a.q);
  const T* ck = static_cast<const T*>(a.ck);
  const T* cv = static_cast<const T*>(a.cv);
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int lo = a.start ? max(a.start[b], 0) : 0;
  int hi = a.idx;
  const bool uniform = lo > hi;  // no valid column: equal weights over all L
  if (uniform) { lo = 0; hi = a.L - 1; }

  float qr[EPL], acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane * EPL + e;
    qr[e] = d < a.D ? to_f(q[b * a.qsb + h * a.qsh + d]) : 0.f;
    acc[e] = 0.f;
  }
  float m = NEG, l = 0.f;

  const T* kb = ck + b * a.ksb + h * a.ksh;
  const T* vb = cv + b * a.vsb + h * a.vsh;
  for (int p0 = lo + warp * U; p0 <= hi; p0 += NW * U) {
    float s[U], vv[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane * EPL + e;
        const bool live = p <= hi && d < a.D;
        const float kx = live ? to_f(kb[p * a.ksl + d]) : 0.f;
        vv[u][e] = live ? to_f(vb[p * a.vsl + d]) : 0.f;
        part = fmaf(qr[e], kx, part);
      }
      s[u] = part;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);

    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = p0 + u > hi ? -INFINITY : (uniform ? 0.f : s[u] * a.scale);
      mx = fmaxf(mx, s[u]);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - mx);
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
    }
    m = mx;
  }

  if (lane == 0) { s_m[warp] = m; s_l[warp] = l; }
#pragma unroll
  for (int e = 0; e < EPL; ++e) s_acc[warp][lane * EPL + e] = acc[e];
  __syncthreads();
  if (warp != 0) return;

  float mt = NEG;
#pragma unroll
  for (int w = 0; w < NW; ++w) mt = fmaxf(mt, s_m[w]);
  float lt = 0.f, out[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const float f = expf(s_m[w] - mt);  // 0 for a warp that saw no column
    lt += s_l[w] * f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = fmaf(s_acc[w][lane * EPL + e], f, out[e]);
  }
  T* o = static_cast<T*>(a.out) + (static_cast<long long>(b) * a.H + h) * a.D;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane * EPL + e;
    if (d < a.D) o[d] = from_f<T>(out[e] / lt);
  }
}

template <typename T, int EPL>
int launch(const Args& a, int B, cudaStream_t stream) {
  flash_decode_kernel<T, EPL><<<dim3(a.H, B), NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 1>(a, B, stream);
  if (a.D <= 64) return launch<T, 2>(a, B, stream);
  return launch<T, 4>(a, B, stream);
}

}  // namespace

// C entry, bound with ctypes (sparkdl_torch/ops/flash_decode.py).
// q [B, 1, H, D] (batch and head strides qsb, qsh), ck and cv [B, L, H, D]
// (strides in elements): float32 (bf16 = 0) or bfloat16 (bf16 = 1), the
// last dimension contiguous. start: int32 [B] contiguous, or null for 0.
// out: [B, 1, H, D] contiguous in the operands' type. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch (0 on success). The caller checks shapes: 1 <= D <= 128,
// 0 <= idx < L, B, H >= 1.
extern "C" int flash_decode(const void* q, const void* ck, const void* cv, const int* start,
                            void* out, int bf16, int B, int L, int H, int D, int idx,
                            long long qsb, long long qsh, long long ksb, long long ksl,
                            long long ksh, long long vsb, long long vsl, long long vsh,
                            float scale, void* stream) {
  const Args a{q, ck, cv, start, out, L, H, D, idx, qsb, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(a, B, st) : launch_d<float>(a, B, st);
}
