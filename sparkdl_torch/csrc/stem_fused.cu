// InceptionV3 stem as one CUDA kernel for Hopper (sm_90a).
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
// Accumulation is float32 throughout.
//
// Bound on this card (H100 SXM, 700 W). The stem does 616.6 M MAC per
// 299x299 image: 78.9 GFLOP at B = 64. It moves 68.7 MB in (f32 pixels)
// and 87.3 MB out (f32 features): 0.047 ms at 3.35 TB/s. So it is bound by
// operations: 1.18 ms at the 67 TFLOP/s of float32 FMA on the CUDA cores,
// which is what this kernel uses to stay float32-exact (0.16 ms would be
// the TF32 tensor-core floor, 495 TFLOP/s, at TF32's ~1e-3 precision).
//
// What the design does about it:
// - One launch. Each block owns a tile of at most 8 x 16 pooled outputs of
//   one image and runs the whole chain for it in shared memory: input
//   pixels -> conv1 map -> conv2 map -> conv3, max-pooled as it is
//   produced. The 11.1 MB/image of float32 intermediates never reach
//   device memory; the price is the recomputed halo between tiles (about
//   a fifth more FMAs at this tile size), because blocks share nothing.
// - Two shared-memory regions, reused across phases: A holds the conv1
//   map, then the pool accumulator; B holds the input pixels, then the
//   conv2 map. 190,344 bytes at the largest tile: one block per SM, so
//   the block is 512 threads (16 warps) to hide load latency; that caps
//   registers at 128 a thread (256 threads at 254 registers measured
//   ~14% slower on the H100).
// - Register tiles: a thread computes 8 output channels for up to 6
//   pixels, so each shared-memory load of an input feeds 8 FMAs and each
//   float4 pair of weights (read through the read-only cache) feeds up to
//   48. 32-channel maps are stored with a pixel stride of 33 floats so
//   neighbouring pixels fall in different banks.
// - conv3's SAME padding is the conv2 map zeroed outside the image; the
//   pool keeps a running max in shared memory with integer atomicMax,
//   exact because every value is a ReLU output (>= 0, where the float and
//   the int orders agree).
// - Scalar FMAs, no wgmma/TMA yet: a simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int NT = 512;         // threads per block (16 warps; registers capped at 128)
constexpr int TR = 8, TC = 16;  // largest tile of pooled outputs (rows, cols)
constexpr int CP = 33;          // shared-memory pixel stride of a 32-channel map
// largest tile of each map of the chain: pool rows [u0, u0+nr) need conv3
// rows [2u0, 2u0+2nr], conv2 rows [2u0-1, 2u0+2nr+1] (SAME halo), conv1
// rows [2u0-1, 2u0+2nr+3] and input rows [4u0-2, 4u0+4nr+8]; columns alike
constexpr int R3M = 2 * TR + 1, C3M = 2 * TC + 1;
constexpr int R2M = R3M + 2, C2M = C3M + 2;
constexpr int R1M = R2M + 2, C1M = C2M + 2;
constexpr int RIM = 2 * R1M + 1, CIM = 2 * C1M + 1;
constexpr int A_FLOATS = cmax(R1M * C1M * CP, TR * TC * 64);
constexpr int B_FLOATS = cmax(RIM * CIM * 3, R2M * C2M * CP);
constexpr int SMEM_BYTES = (A_FLOATS + B_FLOATS) * 4;
static_assert(SMEM_BYTES <= 232448, "stem tile exceeds Hopper's shared memory");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// conv1 -> shared memory as it is.
struct StoreMap {
  float* out;
  int cols;
  __device__ __forceinline__ void operator()(int r, int c, int co, float v) const {
    out[(r * cols + c) * CP + co] = v;
  }
};

// conv2 -> shared memory, zero outside the image: conv3's SAME padding.
struct StoreMasked {
  float* out;
  int cols, gy, gx, h;  // global row/col of local (0, 0); map height = width
  __device__ __forceinline__ void operator()(int r, int c, int co, float v) const {
    const bool inside = static_cast<unsigned>(gy + r) < static_cast<unsigned>(h) &&
                        static_cast<unsigned>(gx + c) < static_cast<unsigned>(h);
    out[(r * cols + c) * CP + co] = inside ? v : 0.f;
  }
};

// conv3 -> running 3x3/2 max over the pooled outputs whose window holds
// (r, c): rows i with 2i <= r <= 2i + 2, columns alike.
struct PoolMax {
  int* pool;
  int nr, nc;
  __device__ __forceinline__ void operator()(int r, int c, int co, float v) const {
    const int bits = __float_as_int(v);
    const int i_hi = r >> 1, i_lo = (r & 1) ? i_hi : i_hi - 1;
    const int j_hi = c >> 1, j_lo = (c & 1) ? j_hi : j_hi - 1;
    for (int i = max(i_lo, 0); i <= min(i_hi, nr - 1); ++i)
      for (int j = max(j_lo, 0); j <= min(j_hi, nc - 1); ++j)
        atomicMax(pool + (i * nc + j) * 64 + co, bits);
  }
};

// PX pixels x CPT channels of one 3x3 conv + folded BN + ReLU. The input
// map is in shared memory: output pixel (r, c), tap (ky, kx), channel ci
// reads in[(r*STRIDE + ky) * in_row + (c*STRIDE + kx) * PIX + ci]. Thread
// t computes channels [co0, co0 + CPT) of pixels pt + NPT * (k0 + j).
template <int CIN, int COUT, int STRIDE, int PIX, int CPT, int PX, class Epi>
__device__ __forceinline__ void conv_chunk(const float* in, int in_row, int cols, int npix,
                                           int k0, const float* __restrict__ w,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift, const Epi& epi) {
  constexpr int NCG = COUT / CPT;
  constexpr int NPT = NT / NCG;
  const int co0 = (threadIdx.x % NCG) * CPT;
  const int pt = threadIdx.x / NCG;
  int off[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int p = min(pt + NPT * (k0 + j), npix - 1);  // past the end: recompute the last, store nothing
    const int r = p / cols, c = p - r * cols;
    off[j] = r * STRIDE * in_row + c * STRIDE * PIX;
  }
  float acc[PX][CPT];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[j][q] = 0.f;

#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll 1
    for (int kx = 0; kx < 3; ++kx) {
      const float* wt = w + (ky * 3 + kx) * CIN * COUT + co0;  // HWIO
      const float* it = in + ky * in_row + kx * PIX;
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        float wv[CPT];
#pragma unroll
        for (int q = 0; q < CPT; q += 4) {
          const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + ci * COUT + q));
          wv[q] = w4.x;
          wv[q + 1] = w4.y;
          wv[q + 2] = w4.z;
          wv[q + 3] = w4.w;
        }
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const float a = it[off[j] + ci];
#pragma unroll
          for (int q = 0; q < CPT; ++q) acc[j][q] = fmaf(a, wv[q], acc[j][q]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int p = pt + NPT * (k0 + j);
    if (p < npix) {
      const int r = p / cols, c = p - r * cols;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const float v = fmaf(acc[j][q], __ldg(scale + co0 + q), __ldg(shift + co0 + q));
        epi(r, c, co0 + q, fmaxf(v, 0.f));
      }
    }
  }
}

// The whole [rows x cols] output map of one conv: every thread walks its
// K pixel slots in chunks of PX, then 2, then 1 (no chunk past the end).
template <int CIN, int COUT, int STRIDE, int PIX, int CPT, int PX, class Epi>
__device__ __forceinline__ void conv_tile(const float* in, int in_row, int rows, int cols,
                                          const float* __restrict__ w,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift, const Epi& epi) {
  constexpr int NPT = NT / (COUT / CPT);
  const int npix = rows * cols;
  const int K = (npix + NPT - 1) / NPT;
  int k0 = 0;
  for (; k0 + PX <= K; k0 += PX)
    conv_chunk<CIN, COUT, STRIDE, PIX, CPT, PX>(in, in_row, cols, npix, k0, w, scale, shift, epi);
  for (; k0 + 2 <= K; k0 += 2)
    conv_chunk<CIN, COUT, STRIDE, PIX, CPT, 2>(in, in_row, cols, npix, k0, w, scale, shift, epi);
  if (k0 < K)
    conv_chunk<CIN, COUT, STRIDE, PIX, CPT, 1>(in, in_row, cols, npix, k0, w, scale, shift, epi);
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

  const int b = blockIdx.z;
  const int u0 = blockIdx.y * Rp / ntr, nr = (blockIdx.y + 1) * Rp / ntr - u0;
  const int v0 = blockIdx.x * Rp / ntc, nc = (blockIdx.x + 1) * Rp / ntc - v0;
  const int R3 = 2 * nr + 1, C3 = 2 * nc + 1;
  const int R2 = R3 + 2, C2 = C3 + 2;
  const int R1 = R2 + 2, C1 = C2 + 2;
  const int RI = 2 * R1 + 1, CI = 2 * C1 + 1;
  const int gy = 2 * u0 - 1, gx = 2 * v0 - 1;  // global conv1/conv2 coords of local (0, 0)

  // 1. input pixels [RI][CI][3] as float32, zero outside the image
  const Tin* xb = x + static_cast<size_t>(b) * S * S * 3;
  for (int i = threadIdx.x; i < RI * CI * 3; i += NT) {
    const int t = i / 3, ch = i - t * 3;
    const int yy = t / CI, xx = t - yy * CI;
    const int iy = 2 * gy + yy, ix = 2 * gx + xx;
    float v = 0.f;
    if (static_cast<unsigned>(iy) < static_cast<unsigned>(S) &&
        static_cast<unsigned>(ix) < static_cast<unsigned>(S))
      v = to_f32(xb[(static_cast<size_t>(iy) * S + ix) * 3 + ch]);
    reg_b[i] = v;
  }
  __syncthreads();

  // 2. conv1, 3x3 stride 2, 3 -> 32. Positions outside the image only
  //    feed conv2 positions that step 3 zeroes, so they need no mask.
  conv_tile<3, 32, 2, 3, 8, 4>(reg_b, CI * 3, R1, C1, k1, s1, b1, StoreMap{reg_a, C1});
  __syncthreads();

  // 3. conv2, 3x3 VALID, 32 -> 32
  conv_tile<32, 32, 1, CP, 8, 5>(reg_a, C1 * CP, R2, C2, k2, s2, b2,
                                 StoreMasked{reg_b, C2, gy, gx, H2});
  __syncthreads();

  // 4. conv3, 3x3 SAME, 32 -> 64, max-pooled into region A as produced
  int* const pool = reinterpret_cast<int*>(reg_a);
  for (int i = threadIdx.x; i < nr * nc * 64; i += NT) pool[i] = 0;
  __syncthreads();
  conv_tile<32, 64, 1, CP, 8, 6>(reg_b, C2 * CP, R3, C3, k3, s3, b3, PoolMax{pool, nr, nc});
  __syncthreads();

  // 5. pooled tile -> [B, Rp, Rp, 64]
  Tout* ob = out + static_cast<size_t>(b) * Rp * Rp * 64;
  for (int i = threadIdx.x; i < nr * nc * 64; i += NT) {
    const int t = i >> 6, co = i & 63;
    const int ii = t / nc, jj = t - ii * nc;
    store_out(ob + (static_cast<size_t>(u0 + ii) * Rp + v0 + jj) * 64 + co,
              __int_as_float(pool[i]));
  }
}

template <typename Tin, typename Tout>
int launch(const void* x, const float* k1, const float* s1, const float* b1, const float* k2,
           const float* s2, const float* b2, const float* k3, const float* s3, const float* b3,
           void* out, int B, int S, cudaStream_t stream) {
  const int H1 = (S - 3) / 2 + 1, H2 = H1 - 2, Rp = (H2 - 3) / 2 + 1;
  const int ntr = (Rp + TR - 1) / TR, ntc = (Rp + TC - 1) / TC;
  cudaError_t err = cudaFuncSetAttribute(stem_fused_kernel<Tin, Tout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ntc, ntr, B);
  stem_fused_kernel<Tin, Tout><<<grid, NT, SMEM_BYTES, stream>>>(static_cast<const Tin*>(x), k1, s1, b1, k2, s2, b2, k3, s3, b3, static_cast<Tout*>(out), S, H2, Rp, ntr, ntc);
  return static_cast<int>(cudaGetLastError());
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
    return out_bf16 ? launch<uint8_t, __nv_bfloat16>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out, B, S, st)
                    : launch<uint8_t, float>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out, B, S, st);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out, B, S, st)
                  : launch<float, float>(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, out, B, S, st);
}
