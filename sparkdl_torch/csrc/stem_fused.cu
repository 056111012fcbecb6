// InceptionV3 stem as one CUDA kernel for Hopper (sm_90a), on the tensor
// cores at float32 accuracy.
//
// Replaces: sparkdl_tpu/ops/stem_fused.py::_stem_kernel (the Pallas
// whole-stem kernel, reached through inception_stem_fused). It computes
// the same function, read for what it computes and not block by block:
//
//   conv1  3x3 stride 2 VALID, 3 -> 32    \
//   conv2  3x3 stride 1 VALID, 32 -> 32    > each  relu(conv(x) * s + b)
//   conv3  3x3 stride 1 SAME,  32 -> 64   /  (BatchNorm and the 'tf'
//   max-pool 3x3 stride 2 VALID               preprocess folded into s, b, k)
//
// on NHWC pixels [B, S, S, 3] (uint8 or float32, raw [0, 255]) into
// NHWC features [B, Rp, Rp, 64] (float32 or bfloat16), Rp = 73 at S = 299.
//
// Bound on this card (H100 SXM, 700 W). The stem does 616.6 M MAC per
// 299x299 image: 78.93 GFLOP at B = 64. It moves 68.7 MB in (f32 pixels)
// and 87.3 MB out (f32 features): 0.047 ms at 3.35 TB/s. So operations
// bound it: 0.478 ms on the tensor cores as 3xTF32 (three TF32 passes a
// product at 495 TFLOP/s), which this kernel uses; 1.178 ms on the CUDA
// cores' 67 TFLOP/s of float32 FMA, where the kernel's earlier body ran
// (4.38 ms).
//
// What the design does about it (measured with tools/stem_variants.py on
// an H100 80GB HBM3 at 700 W, B = 64, S = 299, as are the figures below):
// - One launch. Each block owns a tile of at most TR x TC = 7 x 11 pooled
//   outputs of one image and runs the whole chain for it in shared memory:
//   input pixels -> conv1 map -> conv2 map -> conv3, max-pooled as it is
//   produced. The 11.1 MB/image of float32 intermediates never reach
//   device memory; the price is the recomputed halo between tiles (23%
//   more MACs at this tile size), because blocks share nothing.
// - Every conv is an implicit GEMM on mma.sync m16n8k8 TF32 with the 3xTF32
//   split (mma_tf32x3.cuh): M = the tile's output pixels, N = Cout, K = the
//   9 taps x Cin. A fragments are read straight from the map in shared
//   memory at a per-lane pixel offset plus the tap's offset, with no im2col
//   buffer.
// - B fragments come from a copy of the conv's HWIO weights in shared
//   memory (rows at a stride of Cout + 4 floats, 4 mod 32: a warp's loads
//   fall in 32 different banks), staged with 16-byte cp.async: conv2's
//   while the input loads and conv1 runs, conv3's after conv2. Read
//   through the read-only cache instead, every m-tile fetches all of a
//   conv's weights from L2 again (~4 MB a block, counted from the
//   shapes), and the kernel takes 2.79 ms instead of 2.20.
// - A warp owns 16 pixels x all Cout channels, so each A value is split
//   once and feeds Cout / 8 n-tiles. Splitting each value once where it is
//   stored (big and small) would need twice the maps and the weights, which
//   already take 228 KB.
// - The 32-channel maps are stored at a pixel stride of CP = 40 floats
//   (8 mod 32). A k-step's 8 channels are numbered so that a lane's two A
//   positions t and t + 4 are channels 2t and 2t + 1 (an mma sums over k in
//   any order; B is read with the same numbering): one 8-byte load a pixel
//   row, and a half-warp's loads (pixels g, channels 2t) fall in 32
//   different banks. The epilogue's 8-byte stores likewise.
// - conv1 (K = 27, zero-padded to 32: 4 k-steps) runs on the tensor cores
//   too, reading its A values from the pixel tile through a per-lane table
//   of the 8 (tap, channel) offsets; 7% faster than float32 FMAs on the
//   CUDA cores. uint8 pixels are integers <= 255, exact in TF32: the small
//   half of A is zero, so two passes suffice.
// - Accumulation: a tap's 4 k-steps (12 mma) sum from zero and reach the
//   float32 accumulator in one add. The tensor cores round the running sum
//   they are handed by their own rule: all 36 chained through the
//   accumulator ran no faster and put the stem's error at 4.3e-6 instead of
//   1.0e-6.
// - Balance: a block's m-tiles are dealt to its 16 warps in turn; when the
//   last round would leave more than half the warps idle, its m-tiles are
//   cut into two N halves (5% faster).
// - Epilogues on the accumulator fragments: fmaf(acc, s, b) and ReLU; conv2
//   stores zero outside the image (conv3's SAME padding); conv3 is pooled
//   into shared memory by integer atomicMax, exact because every value is
//   a ReLU output (>= 0, where the float and int orders agree) and order-
//   independent, so the output is the same bits on every call.
// - Shared memory: region A holds the conv1 map (19 x 27 pixels x 40
//   floats = 82,080 bytes), then the pool accumulator (7 x 11 x 64 ints);
//   region B the input pixels (39 x 55 x 3 floats), then the conv2 map
//   (17 x 25 x 40 floats = 68,000 bytes); region W conv2's weights, then
//   conv3's (288 rows x 68 floats = 78,336 bytes): 228,416 bytes, one block
//   an SM. 16 warps hide latency better than 8 (2.20 against 2.39 ms),
//   within 128 registers and without spill.
// - Input pixels are read with 8 loads in flight a thread.
// - mma.sync, no wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int NW = 16;          // warps per block
constexpr int NT = 32 * NW;
constexpr int TR = 7, TC = 11;  // largest tile of pooled outputs (rows, cols)
constexpr int CP = 40;          // shared-memory pixel stride of a 32-channel map
// largest tile of each map of the chain: pool rows [u0, u0+nr) need conv3
// rows [2u0, 2u0+2nr], conv2 rows [2u0-1, 2u0+2nr+1] (SAME halo), conv1
// rows [2u0-1, 2u0+2nr+3] and input rows [4u0-2, 4u0+4nr+8]; columns alike
constexpr int R3M = 2 * TR + 1, C3M = 2 * TC + 1;
constexpr int R2M = R3M + 2, C2M = C3M + 2;
constexpr int R1M = R2M + 2, C1M = C2M + 2;
constexpr int RIM = 2 * R1M + 1, CIM = 2 * C1M + 1;
constexpr int A_FLOATS = cmax(R1M * C1M * CP, TR * TC * 64);
constexpr int B_FLOATS = cmax(RIM * CIM * 3, R2M * C2M * CP);
// conv2's, then conv3's weights: HWIO rows of Cout floats at a stride of
// Cout + 4 (4 mod 32: a warp's B loads, rows 2t and columns g, fall in 32
// different banks)
__host__ __device__ constexpr int wstride(int cout) { return cout + 4; }
constexpr int W_FLOATS = 9 * 32 * wstride(64);
constexpr int SMEM_BYTES = (A_FLOATS + B_FLOATS + W_FLOATS) * 4;
static_assert(SMEM_BYTES <= 232448, "stem tile exceeds Hopper's shared memory");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Frag {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  mma3::split_tf32_trunc(x, big, small);
}

// d += a * b as 3xTF32; EXACT: a is exact in TF32 (its small half is zero),
// so the small * big pass is left out
template <bool EXACT>
__device__ __forceinline__ void mma3x(float (&d)[4], const Frag& a, const FragB& b) {
  if constexpr (!EXACT) mma3::mma_tf32(d, a.small, b.big);
  mma3::mma_tf32(d, a.big, b.small);
  mma3::mma_tf32(d, a.big, b.big);
}

// conv1 -> shared memory as it is.
struct StoreMap {
  float* out;
  int cols;
  __device__ __forceinline__ void operator()(int r, int c, int co, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + (r * cols + c) * CP + co) = make_float2(v0, v1);
  }
};

// conv2 -> shared memory, zero outside the image: conv3's SAME padding.
struct StoreMasked {
  float* out;
  int cols, gy, gx, h;  // global row/col of local (0, 0); map height = width
  __device__ __forceinline__ void operator()(int r, int c, int co, float v0, float v1) const {
    const bool inside = static_cast<unsigned>(gy + r) < static_cast<unsigned>(h) &&
                        static_cast<unsigned>(gx + c) < static_cast<unsigned>(h);
    *reinterpret_cast<float2*>(out + (r * cols + c) * CP + co) =
        inside ? make_float2(v0, v1) : make_float2(0.f, 0.f);
  }
};

// conv3 -> running 3x3/2 max over the pooled outputs whose window holds
// (r, c): rows i with 2i <= r <= 2i + 2, columns alike.
struct PoolMax {
  int* pool;
  int nr, nc;
  __device__ __forceinline__ void operator()(int r, int c, int co, float v0, float v1) const {
    const int i_hi = r >> 1, i_lo = (r & 1) ? i_hi : i_hi - 1;
    const int j_hi = c >> 1, j_lo = (c & 1) ? j_hi : j_hi - 1;
    for (int i = max(i_lo, 0); i <= min(i_hi, nr - 1); ++i)
      for (int j = max(j_lo, 0); j <= min(j_hi, nc - 1); ++j) {
        int* p = pool + (i * nc + j) * 64 + co;
        atomicMax(p, __float_as_int(v0));
        atomicMax(p + 1, __float_as_int(v1));
      }
  }
};

// The epilogue of one warp's 16 x 8*NTL accumulators: pixels m0 + g and
// m0 + g + 8 (those < npix), channels n0 + 8j + 2t and + 1.
template <int NTL, class Epi>
__device__ __forceinline__ void epilogue(const float (&acc)[NTL][4], int m0, int n0, int npix,
                                         int cols, const float* __restrict__ scale,
                                         const float* __restrict__ shift, const Epi& epi, int g,
                                         int t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p = m0 + g + 8 * rr;
    if (p < npix) {
      const int r = p / cols, c = p - r * cols;
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const int co = n0 + 8 * j + 2 * t;
        const float v0 = fmaf(acc[j][2 * rr], __ldg(scale + co), __ldg(shift + co));
        const float v1 = fmaf(acc[j][2 * rr + 1], __ldg(scale + co + 1), __ldg(shift + co + 1));
        epi(r, c, co, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
}

// conv2 / conv3: 3x3 stride 1 over a 32-channel map in shared memory
// (in_cols pixels a row, stride CP), output map `cols` wide with npix
// pixels; w: the conv's HWIO weights in shared memory, rows at stride
// wstride(COUT). One warp: pixels [m0, m0 + 16) (past npix: recomputes the
// last, stores nothing) x channels [n0, n0 + 8 NTL). K = tap x channel, 36
// k-steps; each tap's 4 sum from zero before they reach acc.
template <int COUT, int NTL, class Epi>
__device__ __forceinline__ void conv3x3_item(const float* in, int in_cols, int cols, int npix,
                                             int m0, int n0, const float* w,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ shift, const Epi& epi,
                                             int g, int t) {
  const int p0 = min(m0 + g, npix - 1), p1 = min(m0 + g + 8, npix - 1);
  const int r0 = p0 / cols, r1 = p1 / cols;
  // A: row g at a0, row g + 8 at a1; position t = channel 2t, t + 4 = 2t + 1
  const float* a0 = in + (r0 * in_cols + p0 - r0 * cols) * CP + 2 * t;
  const float* a1 = in + (r1 * in_cols + p1 - r1 * cols) * CP + 2 * t;
  // B[k][n] = w[tap][8 ks + k'][n0 + n], k' numbered as A's channels
  constexpr int WS = wstride(COUT);
  const float* wl = w + 2 * t * WS + n0 + g;
  float acc[NTL][4];
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap - 3 * ky;
    const int off = (ky * in_cols + kx) * CP;
    const float* wt = wl + tap * 32 * WS;
    float part[NTL][4];  // this tap's 4 k-steps, from zero
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float2 x0 = *reinterpret_cast<const float2*>(a0 + off + 8 * ks);
      const float2 x1 = *reinterpret_cast<const float2*>(a1 + off + 8 * ks);
      Frag a;
      split(x0.x, a.big[0], a.small[0]);
      split(x1.x, a.big[1], a.small[1]);
      split(x0.y, a.big[2], a.small[2]);
      split(x1.y, a.big[3], a.small[3]);
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        FragB b;
        split(wt[8 * ks * WS + 8 * j], b.big[0], b.small[0]);
        split(wt[(8 * ks + 1) * WS + 8 * j], b.big[1], b.small[1]);
        mma3x<false>(part[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  epilogue<NTL>(acc, m0, n0, npix, cols, scale, shift, epi, g, t);
}

// conv1: 3x3 stride 2 over the input pixels [RI][CI][3] in shared memory,
// K = 27 zero-padded to 32 (4 k-steps, one run from zero). koff: this
// lane's 8 A offsets, k = 8 ks + t (koff[2 ks]) and 8 ks + t + 4
// (koff[2 ks + 1]), 0 past 27 (the weight there is 0).
template <int NTL, bool EXACT, class Epi>
__device__ __forceinline__ void conv1_item(const float* in, int in_cols, int cols, int npix,
                                           int m0, int n0, const int (&koff)[8],
                                           const float* __restrict__ w,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift, const Epi& epi,
                                           int g, int t) {
  const int p0 = min(m0 + g, npix - 1), p1 = min(m0 + g + 8, npix - 1);
  const int r0 = p0 / cols, r1 = p1 / cols;
  const float* a0 = in + (2 * r0 * in_cols + 2 * (p0 - r0 * cols)) * 3;
  const float* a1 = in + (2 * r1 * in_cols + 2 * (p1 - r1 * cols)) * 3;
  float acc[NTL][4];
#pragma unroll
  for (int j = 0; j < NTL; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    Frag a;
    split(a0[koff[2 * ks]], a.big[0], a.small[0]);
    split(a1[koff[2 * ks]], a.big[1], a.small[1]);
    split(a0[koff[2 * ks + 1]], a.big[2], a.small[2]);
    split(a1[koff[2 * ks + 1]], a.big[3], a.small[3]);
    const int k0 = 8 * ks + t, k1 = k0 + 4;
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      const int n = n0 + 8 * j + g;
      FragB b;
      split(k0 < 27 ? __ldg(w + k0 * 32 + n) : 0.f, b.big[0], b.small[0]);
      split(k1 < 27 ? __ldg(w + k1 * 32 + n) : 0.f, b.big[1], b.small[1]);
      mma3x<EXACT>(acc[j], a, b);
    }
  }
  epilogue<NTL>(acc, m0, n0, npix, cols, scale, shift, epi, g, t);
}

// HWIO weights [9 * 32][COUT] -> shared rows at stride wstride(COUT), as
// asynchronous 16-byte copies (committed, not waited for)
template <int COUT>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w) {
  constexpr int CPR = COUT / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 9 * 32 * CPR; i += NT) {
    const int k = i / CPR, c = (i - k * CPR) * 4;
    mma3::cp_async16(ws + k * wstride(COUT) + c, w + k * COUT + c, true);
  }
  mma3::cp_async_commit();
}

// a count of n-tiles as a type, for the items' generic lambdas
template <int N>
struct Int {
  static constexpr int n = N;
};

// One conv over a block's npix output pixels: 16-pixel m-tiles dealt to
// the warps in turn, item(m0, n0, Int<NTL>) running one. When the last
// round would leave more than half the warps idle, its m-tiles go as two
// N halves each.
template <int COUT, class Item>
__device__ __forceinline__ void conv_phase(int npix, const Item& item) {
  constexpr int NTL = COUT / 8;
  const int warp = threadIdx.x >> 5;
  const int mts = (npix + 15) >> 4;
  const int tail = mts % NW;
  const int whole = tail * 2 <= NW ? mts - tail : mts;
  for (int mt = warp; mt < whole; mt += NW) item(16 * mt, 0, Int<NTL>{});
  for (int u = warp; u < 2 * (mts - whole); u += NW)
    item(16 * (whole + (u >> 1)), (u & 1) * (COUT / 2), Int<NTL / 2>{});
}

// grid (column tiles, row tiles, batch). Tiles split the Rp x Rp pooled
// outputs evenly, each at most TR x TC.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(NT, 1)
stem_fused_kernel(const Tin* __restrict__ x, const float* __restrict__ k1,
                  const float* __restrict__ s1, const float* __restrict__ b1,
                  const float* __restrict__ k2, const float* __restrict__ s2,
                  const float* __restrict__ b2, const float* __restrict__ k3,
                  const float* __restrict__ s3, const float* __restrict__ b3,
                  Tout* __restrict__ out, int S, int H2, int Rp, int ntr, int ntc) {
  extern __shared__ __align__(16) float smem[];
  float* const reg_a = smem;             // conv1 map, then the pool accumulator
  float* const reg_b = smem + A_FLOATS;  // input pixels, then the conv2 map
  float* const reg_w = reg_b + B_FLOATS;  // conv2's, then conv3's weights
  constexpr bool EXACT = sizeof(Tin) == 1;  // uint8 pixels are exact in TF32

  const int b = blockIdx.z;
  const int u0 = blockIdx.y * Rp / ntr, nr = (blockIdx.y + 1) * Rp / ntr - u0;
  const int v0 = blockIdx.x * Rp / ntc, nc = (blockIdx.x + 1) * Rp / ntc - v0;
  const int R3 = 2 * nr + 1, C3 = 2 * nc + 1;
  const int R2 = R3 + 2, C2 = C3 + 2;
  const int R1 = R2 + 2, C1 = C2 + 2;
  const int RI = 2 * R1 + 1, CI = 2 * C1 + 1;
  const int gy = 2 * u0 - 1, gx = 2 * v0 - 1;  // global conv1/conv2 coords of local (0, 0)
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;

  // 1. input pixels [RI][CI][3] as float32, zero outside the image; conv2's
  //    weights on their way
  stage_weights<32>(reg_w, k2);
  const Tin* xb = x + static_cast<size_t>(b) * S * S * 3;
  constexpr int IN_U = 8;  // loads in flight a thread
  for (int i0 = threadIdx.x; i0 < RI * CI * 3; i0 += NT * IN_U) {
    float v[IN_U];
#pragma unroll
    for (int u = 0; u < IN_U; ++u) {
      const int i = i0 + u * NT;
      const int q = i / 3, ch = i - q * 3;
      const int yy = q / CI, xx = q - yy * CI;
      const int iy = 2 * gy + yy, ix = 2 * gx + xx;
      v[u] = i < RI * CI * 3 && static_cast<unsigned>(iy) < static_cast<unsigned>(S) &&
                     static_cast<unsigned>(ix) < static_cast<unsigned>(S)
                 ? to_f32(xb[(static_cast<size_t>(iy) * S + ix) * 3 + ch])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < IN_U; ++u)
      if (i0 + u * NT < RI * CI * 3) reg_b[i0 + u * NT] = v[u];
  }
  __syncthreads();

  // 2. conv1, 3x3 stride 2, 3 -> 32. Positions outside the image only
  //    feed conv2 positions that step 3 zeroes, so they need no mask.
  {
    int koff[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 8 * (i >> 1) + t + 4 * (i & 1);
      const int ky = k / 9, kx = (k / 3) % 3, ci = k % 3;
      koff[i] = k < 27 ? (ky * CI + kx) * 3 + ci : 0;
    }
    const StoreMap epi{reg_a, C1};
    conv_phase<32>(R1 * C1, [&](int m0, int n0, auto ntl) {
      conv1_item<decltype(ntl)::n, EXACT>(reg_b, CI, C1, R1 * C1, m0, n0, koff, k1, s1, b1, epi,
                                          g, t);
    });
  }
  mma3::cp_async_wait_all();
  __syncthreads();

  // 3. conv2, 3x3 VALID, 32 -> 32
  {
    const StoreMasked epi{reg_b, C2, gy, gx, H2};
    conv_phase<32>(R2 * C2, [&](int m0, int n0, auto ntl) {
      conv3x3_item<32, decltype(ntl)::n>(reg_a, C1, C2, R2 * C2, m0, n0, reg_w, s2, b2, epi, g,
                                         t);
    });
  }
  __syncthreads();

  // 4. conv3, 3x3 SAME, 32 -> 64, max-pooled into region A as produced
  stage_weights<64>(reg_w, k3);
  int* const pool = reinterpret_cast<int*>(reg_a);
  for (int i = threadIdx.x; i < nr * nc * 64; i += NT) pool[i] = 0;
  mma3::cp_async_wait_all();
  __syncthreads();
  {
    const PoolMax epi{pool, nr, nc};
    conv_phase<64>(R3 * C3, [&](int m0, int n0, auto ntl) {
      conv3x3_item<64, decltype(ntl)::n>(reg_b, C2, C3, R3 * C3, m0, n0, reg_w, s3, b3, epi, g,
                                         t);
    });
  }
  __syncthreads();

  // 5. pooled tile -> [B, Rp, Rp, 64]
  Tout* ob = out + static_cast<size_t>(b) * Rp * Rp * 64;
  for (int i = threadIdx.x; i < nr * nc * 64; i += NT) {
    const int q = i >> 6, co = i & 63;
    const int ii = q / nc, jj = q - ii * nc;
    store_out(ob + (static_cast<size_t>(u0 + ii) * Rp + v0 + jj) * 64 + co,
              __int_as_float(pool[i]));
  }
}

// attrs null: launch; else fill attrs with registers per thread, shared
// bytes per block, resident blocks per SM and local (spill) bytes per
// thread, and launch nothing
template <typename Tin, typename Tout>
int launch(const void* x, const float* k1, const float* s1, const float* b1, const float* k2,
           const float* s2, const float* b2, const float* k3, const float* s3, const float* b3,
           void* out, int B, int S, cudaStream_t stream, int* attrs) {
  static unsigned long long opted_in = 0;
  cudaError_t err = mma3::opt_in(stem_fused_kernel<Tin, Tout>, SMEM_BYTES, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attrs)
    return static_cast<int>(mma3::kernel_attrs(stem_fused_kernel<Tin, Tout>, NT, SMEM_BYTES,
                                               attrs));
  const int H1 = (S - 3) / 2 + 1, H2 = H1 - 2, Rp = (H2 - 3) / 2 + 1;
  const int ntr = (Rp + TR - 1) / TR, ntc = (Rp + TC - 1) / TC;
  const dim3 grid(ntc, ntr, B);
  stem_fused_kernel<Tin, Tout><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const Tin*>(x), k1, s1, b1, k2, s2, b2, k3, s3, b3, static_cast<Tout*>(out), S,
      H2, Rp, ntr, ntc);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int launch_attrs(int* attrs) {
  return launch<Tin, Tout>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr, attrs);
}

}  // namespace

// C entry, bound with ctypes (sparkdl_torch/ops/stem_fused.py). x: [B, S, S, 3]
// uint8 (in_u8 = 1) or float32; out: [B, Rp, Rp, 64] bfloat16 (out_bf16 = 1)
// or float32; k1..k3 HWIO, s/b per channel, all float32 and contiguous, on
// the device. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success). The caller checks
// shapes: S >= 11.
extern "C" int stem_fused(const void* x, int in_u8, const float* k1, const float* s1,
                          const float* b1, const float* k2, const float* s2, const float* b2,
                          const float* k3, const float* s3, const float* b3, void* out,
                          int out_bf16, int B, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_u8) {
    return out_bf16 ? launch<uint8_t, __nv_bfloat16>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out,
                                                     B, S, st, nullptr)
                    : launch<uint8_t, float>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out, B, S,
                                             st, nullptr);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out, B,
                                                 S, st, nullptr)
                  : launch<float, float>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out, B, S, st,
                                         nullptr);
}

// The build of the kernel for uint8 (in_u8 = 1) or float32 pixels and
// bfloat16 (out_bf16 = 1) or float32 features: fills out[4] with registers
// per thread, shared bytes per block, resident blocks per SM and local
// bytes per thread; returns a cudaError_t (0 on success).
extern "C" int stem_fused_attrs(int in_u8, int out_bf16, int* out) {
  if (in_u8)
    return out_bf16 ? launch_attrs<uint8_t, __nv_bfloat16>(out) : launch_attrs<uint8_t, float>(out);
  return out_bf16 ? launch_attrs<float, __nv_bfloat16>(out) : launch_attrs<float, float>(out);
}
