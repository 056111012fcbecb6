// BatchNorm in training over NHWC activations viewed as [M, C] row-major,
// for Hopper (sm_90a): the batch moments, the normalize (with a second
// BatchNorm or a residual added, and ReLU), and its backward in closed form.
//
// Replaces no TPU kernel. The JAX package leaves BatchNorm to XLA, which
// fuses each one's elementwise work and reductions into a few passes. Eager
// PyTorch, even inside a CUDA graph, runs every multiply, add, ReLU, mean
// and each of their backwards as its own pass over the activation: about
// 41 passes over the 53 BatchNorm outputs of a ResNet50 train step.
// ops/bn_train.py binds these kernels; models/resnet_fused.py runs them.
//
// What it computes, per channel c over the M rows (y_j: the input of one or
// two BatchNorms, s_j and t_j their affine gamma*rsqrt(var + eps) and
// beta - mean*s, r a residual, act ReLU or the identity):
//
//   moments:  mean = sum(y) / M,  var = max(sum(y^2) / M - mean^2, 0)
//             (Flax's biased moments), the sums in float32
//   apply:    u = sum_j (y_j*s_j + t_j) + r,  z = act(u)
//             each product and sum rounded as PyTorch's separate ops round
//             them (no fused multiply-add), so z is the plain chain's bits
//   backward: g = dz * [u > 0] (u recomputed from the inputs; for the fused
//             GEMM's operand load, u = fmaf(y, s, t) as that kernel forms it)
//             S0 = sum(g),  S_j = sum(g * (y_j - mean_j))
//             dgamma_j = S_j * rsqrt(var_j + eps),  dbeta_j = S0
//             (or dscale_j = S_j + mean_j*S0, dshift_j = S0, for an affine
//             whose own gradient PyTorch takes on to gamma and beta)
//             dy_j = s_j*g - s_j*S0/M - (y_j - mean_j) * s_j*S_j / (M*(var_j + eps))
//             dr = g
//   The dy_j formula is the derivative of the whole normalize, the batch
//   moments' terms included, so nothing flows back through the moments.
//
// Bound on this card (H100 SXM, 700 W): bytes, at 3.35 TB/s; each kernel
// does a few operations an element. A float32 ResNet50 step at B = 64,
// 224 px holds 10.59 M BatchNorm outputs an image, 2.71 GB in all;
// chip_smoke.py sums each launch's bytes (every input read once, every
// output written once) into the bound.
//
// What the design does about it:
// - Every kernel walks the rows of a [M, C] tile with 16-byte loads and
//   stores (4 float32 or 8 bfloat16 values), a warp across 512 contiguous
//   bytes of a row, or across whole rows where C is narrower. A block
//   covers up to 128 (float32) or 256 (bfloat16) channels and a run of
//   rows, so a launch has about 512 blocks at every ResNet50 shape (3136
//   to 802816 rows, 64 to 2048 channels). Timed alone, over the step's
//   113 launches, 1024 blocks took 0.6% longer, 2048 5.3%, 4096 13.4%;
//   in the whole step 512 and 1024 differed by less than the runs' own
//   spread. At 1024 blocks, 128-thread blocks took 1.7% longer, one or
//   four rows loaded ahead instead of two stayed within 0.4%, and walking
//   the later passes' tiles backward (to meet the earlier pass's last
//   rows in L2) was 0.7% shorter alone but not in the step (chip_smoke.py
//   bn_step_ms, two rounds, on an H100 80GB HBM3 at 700 W).
//   The per-channel parameters of a block's channels sit in shared memory.
// - One read per input: the moments read y once; apply reads y_j and r
//   and writes z; the backward's reduce reads dz and y_j (and r where the
//   mask needs it), never the output z, and its second pass reads the same
//   and writes dy_j (and dr).
// - Reductions over M in two stages with a fixed order: each block sums
//   its rows per channel (its threads' sums added in order through shared
//   memory) into a [tiles, k, C] scratch, and a second kernel adds those
//   tiles in order and finishes the per-channel arithmetic. No atomics:
//   a step gives the same bits run to run, eagerly or as a CUDA graph.
// - bfloat16 values are widened to float32 on load; all arithmetic and
//   every sum is float32; outputs round once to the storage type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per block of the row kernels
constexpr int TARGET_BLOCKS = 512;   // blocks a row launch aims for (~4 an SM)
constexpr int UNROLL = 2;            // rows a thread loads before it computes
constexpr int RED_COLS = 32, RED_GROUPS = 32;  // the tile sums' block

// 16 bytes of T, as V floats
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int V = 4;
  using Raw = float4;
  __device__ static void widen(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  __device__ static Raw narrow(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  using Raw = uint4;
  __device__ static float2 half(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  __device__ static uint32_t pair(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static void widen(const Raw& r, float* f) {
    float2 v = half(r.x); f[0] = v.x; f[1] = v.y;
    v = half(r.y); f[2] = v.x; f[3] = v.y;
    v = half(r.z); f[4] = v.x; f[5] = v.y;
    v = half(r.w); f[6] = v.x; f[7] = v.y;
  }
  __device__ static Raw narrow(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
};

// How a row launch cuts [M, C]: blocks of `cw` channels (a slice) by `rt`
// rows (a tile); in a block, `tpr` threads across the slice, `rp` rows at once.
struct Tiling {
  int M, C;
  int cw, tpr, rp, rt;
  int slices, tiles;
};

Tiling make_tiling(int M, int C, int V) {
  Tiling t{};
  t.M = M;
  t.C = C;
  t.cw = C < 32 * V ? C : 32 * V;
  t.tpr = t.cw / V;
  t.rp = NT / t.tpr;
  t.slices = (C + t.cw - 1) / t.cw;
  int want = TARGET_BLOCKS / t.slices;
  if (want < 1) want = 1;
  const int rt = (M + want - 1) / want;
  t.rt = (rt + t.rp - 1) / t.rp * t.rp;
  t.tiles = (M + t.rt - 1) / t.rt;
  return t;
}

// This thread's place in its block: the first of its V channels, its row
// group, and the rows of its tile.
struct Place {
  int lc, r, c;  // lane across the slice, row group, first channel
  int row0, end;
  bool on;
};

__device__ __forceinline__ Place place(const Tiling& t, int V) {
  Place p;
  p.lc = threadIdx.x % t.tpr;
  p.r = threadIdx.x / t.tpr;
  p.c = blockIdx.x * t.cw + p.lc * V;
  const int first = blockIdx.y * t.rt;
  p.row0 = first + p.r;
  p.end = min(t.M, first + t.rt);
  p.on = p.r < t.rp && p.c < t.C;
  return p;
}

template <typename T>
__device__ __forceinline__ typename Pack<T>::Raw load(const void* base, long long at) {
  return reinterpret_cast<const typename Pack<T>::Raw*>(static_cast<const T*>(base) + at)[0];
}

template <typename T>
__device__ __forceinline__ void store(void* base, long long at, const float* f) {
  reinterpret_cast<typename Pack<T>::Raw*>(static_cast<T*>(base) + at)[0] = Pack<T>::narrow(f);
}

// `n` per-channel float arrays of the block's slice into shared memory
// (sh[i][cc] = src[i][slice start + cc]; zero past C)
__device__ __forceinline__ void slice_params(float* sh, const float* const* src, int n,
                                             const Tiling& t) {
  for (int i = threadIdx.x; i < n * t.cw; i += NT) {
    const int k = i / t.cw, cc = i % t.cw, c = blockIdx.x * t.cw + cc;
    sh[i] = c < t.C ? src[k][c] : 0.f;
  }
  __syncthreads();
}

// Each thread's NS x V sums -> partial[tile][NS][C], the block's row groups
// added in order
template <int NS, int V>
__device__ __forceinline__ void block_sums(const float (&acc)[NS][V], const Place& p,
                                           const Tiling& t, float* partial) {
  __shared__ float red[NS * NT * V];
  if (p.r < t.rp)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(s * t.rp + p.r) * t.cw + p.lc * V + e] = acc[s][e];
  __syncthreads();
  for (int i = threadIdx.x; i < NS * t.cw; i += NT) {
    const int s = i / t.cw, cc = i % t.cw, c = blockIdx.x * t.cw + cc;
    float tot = 0.f;
    for (int k = 0; k < t.rp; ++k) tot += red[(s * t.rp + k) * t.cw + cc];
    if (c < t.C) partial[(static_cast<long long>(blockIdx.y) * NS + s) * t.C + c] = tot;
  }
}

// The column sums of partial[tiles][NS][C] over the tiles, in a fixed
// order: RED_GROUPS strided sums a column, then those in order. True for
// the thread that holds channel c's sums in `tot`.
template <int NS>
__device__ __forceinline__ bool tile_sums(const float* partial, int tiles, int C, float (&tot)[NS],
                                          int& c) {
  __shared__ float red[NS][RED_GROUPS][RED_COLS];
  const int col = threadIdx.x % RED_COLS, g = threadIdx.x / RED_COLS;
  c = blockIdx.x * RED_COLS + col;
  float t[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) t[s] = 0.f;
  if (c < C)
    for (int i = g; i < tiles; i += RED_GROUPS)
#pragma unroll
      for (int s = 0; s < NS; ++s) t[s] += partial[(static_cast<long long>(i) * NS + s) * C + c];
#pragma unroll
  for (int s = 0; s < NS; ++s) red[s][g][col] = t[s];
  __syncthreads();
  if (g != 0 || c >= C) return false;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    float sum = 0.f;
    for (int i = 0; i < RED_GROUPS; ++i) sum += red[s][i][col];
    tot[s] = sum;
  }
  return true;
}

// ---- moments ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) bn_train_stats_kernel(const void* y, float* partial,
                                                            const Tiling t) {
  constexpr int V = Pack<T>::V;
  const Place p = place(t, V);
  float acc[2][V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[0][e] = acc[1][e] = 0.f;
  if (p.on)
    for (int row = p.row0; row < p.end; row += UNROLL * t.rp) {
      typename Pack<T>::Raw raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (row + u * t.rp < p.end)
          raw[u] = load<T>(y, static_cast<long long>(row + u * t.rp) * t.C + p.c);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (row + u * t.rp < p.end) {
          float v[V];
          Pack<T>::widen(raw[u], v);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[0][e] += v[e];
            acc[1][e] = fmaf(v[e], v[e], acc[1][e]);
          }
        }
    }
  block_sums<2, V>(acc, p, t, partial);
}

// out[0] = mean, out[1] = var, from the tiles' sums
__global__ void __launch_bounds__(RED_COLS * RED_GROUPS)
bn_train_moments_kernel(const float* partial, float* out, int tiles, int M, int C) {
  float tot[2];
  int c;
  if (!tile_sums<2>(partial, tiles, C, tot, c)) return;
  const float mean = tot[0] / static_cast<float>(M);
  const float ex2 = tot[1] / static_cast<float>(M);
  out[c] = mean;
  out[C + c] = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
}

// ---- apply and backward ----------------------------------------------------

struct Args {
  const void* y[2];      // the BatchNorms' inputs [M, C]; y[1] null for one
  const float* s[2];     // their affine [C]
  const float* t[2];
  const float* mean[2];  // their batch moments [C] (backward)
  const float* var[2];
  const void* r;   // residual [M, C] or null
  const void* dz;  // upstream gradient [M, C] (backward)
  void* out[2];    // apply: z in out[0]; backward: dy_j
  void* dr;        // backward: the residual's gradient, or null
  float* partial;  // backward: [tiles, 1 + J, C]
  float* coef;     // backward: [J, 2, C]: s_j*S0/M and s_j*S_j/(M*(var_j + eps)), negated
  float* grads;    // backward: [J, 2, C]: dgamma_j (or dscale_j), dbeta_j (or dshift_j)
  float eps;
  int relu, fma_mask, scale_grads;
  Tiling tl;
};

// u of element e, as the forward formed it (sh: the slice's parameters,
// rows s0, t0[, s1, t1] of `cw` each)
template <int J>
__device__ __forceinline__ float pre_act(const float (&y)[J], float r, bool has_r, const float* sh,
                                         int cw, int cc, bool fma_mask) {
  if (fma_mask) return fmaf(y[0], sh[cc], sh[cw + cc]);
  float u = __fadd_rn(__fmul_rn(y[0], sh[cc]), sh[cw + cc]);
  if (J == 2) u = __fadd_rn(u, __fadd_rn(__fmul_rn(y[J - 1], sh[2 * cw + cc]), sh[3 * cw + cc]));
  if (has_r) u = __fadd_rn(u, r);
  return u;
}

template <typename T, int J>
__global__ void __launch_bounds__(NT) bn_train_apply_kernel(const Args a) {
  constexpr int V = Pack<T>::V;
  __shared__ float sh[2 * J * 32 * V];  // s_j, t_j over the slice
  const Tiling& t = a.tl;
  const float* src[4] = {a.s[0], a.t[0], a.s[J - 1], a.t[J - 1]};
  slice_params(sh, src, 2 * J, t);
  const Place p = place(t, V);
  if (!p.on) return;
  const bool has_r = a.r != nullptr;
  const int cc0 = p.lc * V;
  for (int row = p.row0; row < p.end; row += UNROLL * t.rp) {
    typename Pack<T>::Raw ry[UNROLL][J], rr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (row + u * t.rp < p.end) {
        const long long at = static_cast<long long>(row + u * t.rp) * t.C + p.c;
#pragma unroll
        for (int j = 0; j < J; ++j) ry[u][j] = load<T>(a.y[j], at);
        if (has_r) rr[u] = load<T>(a.r, at);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (row + u * t.rp < p.end) {
        float yv[J][V], rv[V], z[V];
#pragma unroll
        for (int j = 0; j < J; ++j) Pack<T>::widen(ry[u][j], yv[j]);
        if (has_r) Pack<T>::widen(rr[u], rv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float ye[J];
#pragma unroll
          for (int j = 0; j < J; ++j) ye[j] = yv[j][e];
          const float v = pre_act<J>(ye, has_r ? rv[e] : 0.f, has_r, sh, t.cw, cc0 + e, false);
          z[e] = a.relu ? fmaxf(v, 0.f) : v;
        }
        store<T>(a.out[0], static_cast<long long>(row + u * t.rp) * t.C + p.c, z);
      }
  }
}

// one element's g = dz * [u > 0]
template <int J>
__device__ __forceinline__ float masked(float dz, const float (&y)[J], float r, bool has_r,
                                        const float* sh, int cw, int cc, const Args& a) {
  if (!a.relu) return dz;
  return pre_act<J>(y, r, has_r, sh, cw, cc, a.fma_mask != 0) > 0.f ? dz : 0.f;
}

// the rows of one thread's tile, loaded UNROLL at a time: dz, y_j and r
template <typename T, int J, typename F>
__device__ __forceinline__ void grad_rows(const Args& a, const Place& p, bool load_r, F&& f) {
  const Tiling& t = a.tl;
  constexpr int V = Pack<T>::V;
  for (int row = p.row0; row < p.end; row += UNROLL * t.rp) {
    typename Pack<T>::Raw rd[UNROLL], ry[UNROLL][J], rr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (row + u * t.rp < p.end) {
        const long long at = static_cast<long long>(row + u * t.rp) * t.C + p.c;
        rd[u] = load<T>(a.dz, at);
#pragma unroll
        for (int j = 0; j < J; ++j) ry[u][j] = load<T>(a.y[j], at);
        if (load_r) rr[u] = load<T>(a.r, at);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (row + u * t.rp < p.end) {
        float dv[V], yv[J][V], rv[V];
        Pack<T>::widen(rd[u], dv);
#pragma unroll
        for (int j = 0; j < J; ++j) Pack<T>::widen(ry[u][j], yv[j]);
        if (load_r) Pack<T>::widen(rr[u], rv);
        f(static_cast<long long>(row + u * t.rp) * t.C + p.c, dv, yv, rv);
      }
  }
}

// sh rows: s0, t0[, s1, t1], mean0[, mean1]
template <typename T, int J>
__global__ void __launch_bounds__(NT) bn_train_grad_reduce_kernel(const Args a) {
  constexpr int V = Pack<T>::V;
  __shared__ float sh[3 * J * 32 * V];
  const Tiling& t = a.tl;
  const float* order[6];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    order[2 * j] = a.s[j];
    order[2 * j + 1] = a.t[j];
    order[2 * J + j] = a.mean[j];
  }
  slice_params(sh, order, 3 * J, t);
  const Place p = place(t, V);
  float acc[1 + J][V];
#pragma unroll
  for (int s = 0; s <= J; ++s)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[s][e] = 0.f;
  const bool mask_r = a.r != nullptr && a.relu;  // the mask's u needs r
  const int cc0 = p.lc * V;
  const float* mu = sh + 2 * J * t.cw;
  if (p.on)
    grad_rows<T, J>(a, p, mask_r, [&](long long, const float* dv, const float (*yv)[V],
                                      const float* rv) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float ye[J];
#pragma unroll
        for (int j = 0; j < J; ++j) ye[j] = yv[j][e];
        const float g = masked<J>(dv[e], ye, mask_r ? rv[e] : 0.f, mask_r, sh, t.cw, cc0 + e, a);
        acc[0][e] += g;
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[1 + j][e] = fmaf(g, ye[j] - mu[j * t.cw + cc0 + e], acc[1 + j][e]);
      }
    });
  block_sums<1 + J, V>(acc, p, t, a.partial);
}

// The tiles' S0, S_j -> grads and the second pass's coefficients
template <int J>
__global__ void __launch_bounds__(RED_COLS * RED_GROUPS) bn_train_grad_sum_kernel(const Args a) {
  float tot[1 + J];
  int c;
  const int C = a.tl.C;
  if (!tile_sums<1 + J>(a.partial, a.tl.tiles, C, tot, c)) return;
  const float m = static_cast<float>(a.tl.M);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float s = a.s[j][c], mean = a.mean[j][c], ve = a.var[j][c] + a.eps;
    const float sj = tot[1 + j];
    a.grads[(2 * j) * C + c] = a.scale_grads ? fmaf(mean, tot[0], sj) : sj * rsqrtf(ve);
    a.grads[(2 * j + 1) * C + c] = tot[0];
    a.coef[(2 * j) * C + c] = -(s * tot[0]) / m;
    a.coef[(2 * j + 1) * C + c] = -(s * sj / ve) / m;
  }
}

// sh rows: s0, t0[, s1, t1], mean_j, c_j, k_j
template <typename T, int J>
__global__ void __launch_bounds__(NT) bn_train_grad_apply_kernel(const Args a) {
  constexpr int V = Pack<T>::V;
  __shared__ float sh[5 * J * 32 * V];
  const Tiling& t = a.tl;
  const int C = t.C;
  const float* order[10];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    order[2 * j] = a.s[j];
    order[2 * j + 1] = a.t[j];
    order[2 * J + j] = a.mean[j];
    order[3 * J + j] = a.coef + (2 * j) * C;
    order[4 * J + j] = a.coef + (2 * j + 1) * C;
  }
  slice_params(sh, order, 5 * J, t);
  const Place p = place(t, V);
  if (!p.on) return;
  const bool mask_r = a.r != nullptr && a.relu;
  const int cc0 = p.lc * V;
  const int cw = t.cw;
  grad_rows<T, J>(a, p, mask_r, [&](long long at, const float* dv, const float (*yv)[V],
                                    const float* rv) {
    float dy[J][V], g[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float ye[J];
#pragma unroll
      for (int j = 0; j < J; ++j) ye[j] = yv[j][e];
      const int cc = cc0 + e;
      g[e] = masked<J>(dv[e], ye, mask_r ? rv[e] : 0.f, mask_r, sh, cw, cc, a);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float s = sh[2 * j * cw + cc], mu = sh[(2 * J + j) * cw + cc];
        const float cj = sh[(3 * J + j) * cw + cc], kj = sh[(4 * J + j) * cw + cc];
        dy[j][e] = fmaf(kj, ye[j] - mu, fmaf(s, g[e], cj));
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) store<T>(a.out[j], at, dy[j]);
    if (a.dr) store<T>(a.dr, at, g);
  });
}

template <typename T, int J>
int apply(Args a, cudaStream_t stream) {
  a.tl = make_tiling(a.tl.M, a.tl.C, Pack<T>::V);
  bn_train_apply_kernel<T, J><<<dim3(a.tl.slices, a.tl.tiles), NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int J>
int backward(Args a, cudaStream_t stream) {
  a.tl = make_tiling(a.tl.M, a.tl.C, Pack<T>::V);
  const dim3 grid(a.tl.slices, a.tl.tiles);
  bn_train_grad_reduce_kernel<T, J><<<grid, NT, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_train_grad_sum_kernel<J>
      <<<(a.tl.C + RED_COLS - 1) / RED_COLS, RED_COLS * RED_GROUPS, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_train_grad_apply_kernel<T, J><<<grid, NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes (sparkdl_torch/ops/bn_train.py). Every
// [M, C] tensor is contiguous, 16-byte aligned, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1) alike, with C a multiple of 4 (float32) or 8
// (bfloat16); per-channel arrays are float32 [C]. Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after its launches
// (0 on success). The caller checks shapes: M, C >= 1.

// The rows of the scratch the moments and the backward take: tiles of M.
extern "C" int bn_train_tiles(int M, int C, int bf16) {
  return make_tiling(M, C, bf16 ? 8 : 4).tiles;
}

// out [2, C]: the batch mean and biased variance of y [M, C]; partial:
// float32 scratch [bn_train_tiles(M, C, bf16), 2, C].
extern "C" int bn_train_moments(const void* y, float* partial, float* out, int bf16, int M,
                                int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tiling t = make_tiling(M, C, bf16 ? 8 : 4);
  if (bf16)
    bn_train_stats_kernel<__nv_bfloat16><<<dim3(t.slices, t.tiles), NT, 0, st>>>(y, partial, t);
  else
    bn_train_stats_kernel<float><<<dim3(t.slices, t.tiles), NT, 0, st>>>(y, partial, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_train_moments_kernel<<<(C + RED_COLS - 1) / RED_COLS, RED_COLS * RED_GROUPS, 0, st>>>(
      partial, out, t.tiles, M, C);
  return static_cast<int>(cudaGetLastError());
}

// z = act(y0*s0 + t0 [+ y1*s1 + t1] [+ r]); y1 (with s1, t1) and r may be null.
extern "C" int bn_train_apply(const void* y0, const float* s0, const float* t0, const void* y1,
                              const float* s1, const float* t1, const void* r, void* z, int relu,
                              int bf16, int M, int C, void* stream) {
  Args a{};
  a.y[0] = y0; a.s[0] = s0; a.t[0] = t0;
  a.y[1] = y1; a.s[1] = s1; a.t[1] = t1;
  a.r = r;
  a.out[0] = z;
  a.relu = relu;
  a.tl.M = M;
  a.tl.C = C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return y1 ? apply<__nv_bfloat16, 2>(a, st) : apply<__nv_bfloat16, 1>(a, st);
  return y1 ? apply<float, 2>(a, st) : apply<float, 1>(a, st);
}

// The backward of bn_train_apply for upstream gradient dz: dy0 [, dy1]
// (y1 null for one BatchNorm), dr where r and dr are given (r alone: the
// mask needs it), grads [J, 2, C] (dgamma_j, dbeta_j; with scale_grads,
// dscale_j, dshift_j), coef [J, 2, C] and partial [bn_train_tiles(M, C,
// bf16), 1 + J, C] float32 scratch. fma_mask: u = fmaf(y0, s0, t0), as the
// fused GEMM's operand load forms it (one BatchNorm, no residual).
extern "C" int bn_train_backward(const void* dz, const void* y0, const float* s0, const float* t0,
                                 const float* mean0, const float* var0, void* dy0,
                                 const void* y1, const float* s1, const float* t1,
                                 const float* mean1, const float* var1, void* dy1, const void* r,
                                 void* dr, float eps, int relu, int fma_mask, int scale_grads,
                                 float* partial, float* coef, float* grads, int bf16, int M,
                                 int C, void* stream) {
  Args a{};
  a.y[0] = y0; a.s[0] = s0; a.t[0] = t0; a.mean[0] = mean0; a.var[0] = var0; a.out[0] = dy0;
  a.y[1] = y1; a.s[1] = s1; a.t[1] = t1; a.mean[1] = mean1; a.var[1] = var1; a.out[1] = dy1;
  a.r = r;
  a.dz = dz;
  a.dr = dr;
  a.partial = partial;
  a.coef = coef;
  a.grads = grads;
  a.eps = eps;
  a.relu = relu;
  a.fma_mask = fma_mask;
  a.scale_grads = scale_grads;
  a.tl.M = M;
  a.tl.C = C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return y1 ? backward<__nv_bfloat16, 2>(a, st) : backward<__nv_bfloat16, 1>(a, st);
  return y1 ? backward<float, 2>(a, st) : backward<float, 1>(a, st);
}
