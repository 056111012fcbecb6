#!/usr/bin/env python3
"""Variants of the stem kernel, built and measured on one GPU.

    python3 tools/stem_variants.py

Builds ``sparkdl_torch/csrc/stem_fused.cu`` as it stands and a few edited
copies (into ``sparkdl_torch/_build/variants/``, all ``nvcc`` started
together), then prints for each:

- the f32 stem's error against ``stem_reference`` relative to max|ref| at
  B = 64, S = 299 (chip_smoke.py's STEM_TOL), f32 and u8 pixels, and
  whether a second call gives the same bits;
- the 8-row featurizer error: the fused InceptionV3 forward with the
  kernel against the same forward with the plain stem (chip_smoke.py's
  NET_TOL);
- the kernel's device time per call at B = 64, S = 299, f32 pixels and
  features (CUDA-graph replay), in two rounds, the second in reverse
  order, for the variants and the cuts below.

The variants:

- ``as_is``;
- ``chain``: all 36 k-steps of conv2 and conv3 chained through the
  accumulator instead of each tap's 4 summed from zero;
- ``conv1_cuda_cores``: conv1 as float32 FMAs on the CUDA cores (a thread
  8 channels of one pixel) instead of on the tensor cores;
- ``small_rn``: the split's small half rounded to TF32 instead of left for
  the tensor cores to truncate;
- ``big_trunc``: the split's big half truncated (one op fewer) instead of
  rounded;
- ``no_half_tail``: the last round of m-tiles dealt whole, never cut into
  N halves;
- ``weights_global``: conv2's and conv3's B fragments read from the
  weights in device memory (through L1 and L2) instead of from their
  copy in shared memory;
- ``pass_major``: each k-step's B fragments split first, then the three
  passes each over all n-tiles (independent mma back to back), instead of
  the three passes of one n-tile after another;
- ``conv2_presplit``: conv2's weights split once as they are staged, stored
  as (big, small) pairs, instead of split at every B load;
- ``warps8``, ``warps12``: 8 or 12 warps a block instead of 16
  (registers capped at 255 or 168 instead of 128);
- ``tile5x15``, ``tile6x13``: 5 x 15 or 6 x 13 pooled tiles instead of
  7 x 11.

Then, for a breakdown of the time, cuts: copies that leave one part's
work out, timed only (their results are wrong): ``cut_input`` (the pixel
loads), ``cut_conv1_mma``, ``cut_conv2_mma`` (that conv's k-step loop),
``cut_pool_atomics`` and ``cut_conv3_staging`` (the copy of conv3's
weights). ``as_is`` minus a cut's time is what that part costs.

Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from sparkdl_torch.ops import _dispatch  # noqa: E402

SOURCE = "stem_fused"
CONV1_TC = (
    "    conv_phase<32>(R1 * C1, [&](int m0, int n0, auto ntl) {\n"
    "      conv1_item<decltype(ntl)::n, EXACT>(reg_b, CI, C1, R1 * C1, m0, n0, koff, k1, s1, b1, epi,\n"
    "                                          g, t);\n"
    "    });\n")
CONV1_CUDA_CORES = """\
    for (int i = threadIdx.x; i < R1 * C1 * 4; i += NT) {  // a pixel's 8 channels
      const int p = i >> 2, co = (i & 3) * 8;
      const int r = p / C1, c = p - r * C1;
      const float* a = reg_b + (2 * r * CI + 2 * c) * 3;
      float acc[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = 0.f;
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        const float v = a[(k / 9 * CI + k / 3 % 3) * 3 + k % 3];
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(k1 + k * 32 + co));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(k1 + k * 32 + co + 4));
        acc[0] = fmaf(v, w0.x, acc[0]); acc[1] = fmaf(v, w0.y, acc[1]);
        acc[2] = fmaf(v, w0.z, acc[2]); acc[3] = fmaf(v, w0.w, acc[3]);
        acc[4] = fmaf(v, w1.x, acc[4]); acc[5] = fmaf(v, w1.y, acc[5]);
        acc[6] = fmaf(v, w1.z, acc[6]); acc[7] = fmaf(v, w1.w, acc[7]);
      }
#pragma unroll
      for (int q = 0; q < 8; q += 2)
        epi(r, c, co + q, fmaxf(fmaf(acc[q], __ldg(s1 + co + q), __ldg(b1 + co + q)), 0.f),
            fmaxf(fmaf(acc[q + 1], __ldg(s1 + co + q + 1), __ldg(b1 + co + q + 1)), 0.f));
    }
"""
J_LOOP = """#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        FragB b;
        split(wt[8 * ks * WS + 8 * j], b.big[0], b.small[0]);
        split(wt[(8 * ks + 1) * WS + 8 * j], b.big[1], b.small[1]);
        mma3x<false>(part[j], a, b);
      }
"""
PASS_MAJOR = """      FragB b[NTL];
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        split(wt[8 * ks * WS + 8 * j], b[j].big[0], b[j].small[0]);
        split(wt[(8 * ks + 1) * WS + 8 * j], b[j].big[1], b[j].small[1]);
      }
#pragma unroll
      for (int j = 0; j < NTL; ++j) mma3::mma_tf32(part[j], a.small, b[j].big);
#pragma unroll
      for (int j = 0; j < NTL; ++j) mma3::mma_tf32(part[j], a.big, b[j].small);
#pragma unroll
      for (int j = 0; j < NTL; ++j) mma3::mma_tf32(part[j], a.big, b[j].big);
"""
PRESPLIT_J = """#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        FragB b;
        if constexpr (PS == 2) {
          const float2 q0 = *reinterpret_cast<const float2*>(wt + 8 * ks * WS + 16 * j);
          const float2 q1 = *reinterpret_cast<const float2*>(wt + (8 * ks + 1) * WS + 16 * j);
          b.big[0] = __float_as_uint(q0.x);
          b.small[0] = __float_as_uint(q0.y);
          b.big[1] = __float_as_uint(q1.x);
          b.small[1] = __float_as_uint(q1.y);
        } else {
          split(wt[8 * ks * WS + 8 * j], b.big[0], b.small[0]);
          split(wt[(8 * ks + 1) * WS + 8 * j], b.big[1], b.small[1]);
        }
        mma3x<false>(part[j], a, b);
      }
"""
STAGE_SPLIT = """__device__ __forceinline__ void stage_split32(float* ws, const float* __restrict__ w) {
  constexpr int U = 6;
  for (int i0 = threadIdx.x; i0 < 9 * 32 * 32; i0 += NT * U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = i0 + u * NT < 9 * 32 * 32 ? __ldg(w + i0 + u * NT) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      if (i < 9 * 32 * 32) {
        uint32_t big, small;
        split(v[u], big, small);
        *reinterpret_cast<float2*>(ws + (i >> 5) * 68 + 2 * (i & 31)) =
            make_float2(__uint_as_float(big), __uint_as_float(small));
      }
    }
  }
}

// One conv over a block's npix output pixels"""
VARIANTS = {
    "as_is": [],
    "chain": [("mma3x<false>(part[j], a, b);", "mma3x<false>(acc[j], a, b);")],
    "conv1_cuda_cores": [(CONV1_TC, CONV1_CUDA_CORES)],
    "small_rn": [("  mma3::split_tf32_trunc(x, big, small);\n", "  mma3::split_tf32(x, big, small);\n")],
    "big_trunc": [("  mma3::split_tf32_trunc(x, big, small);\n",
                   "  big = __float_as_uint(x) & 0xFFFFE000u;\n"
                   "  small = __float_as_uint(x - __uint_as_float(big));\n")],
    "no_half_tail": [("const int whole = tail * 2 <= NW ? mts - tail : mts;",
                      "const int whole = mts;")],
    "weights_global": [("constexpr int WS = wstride(COUT);", "constexpr int WS = COUT;"),
                       ("m0, n0, reg_w, s2, b2,", "m0, n0, k2, s2, b2,"),
                       ("m0, n0, reg_w, s3, b3,", "m0, n0, k3, s3, b3,")],
    "pass_major": [(J_LOOP, PASS_MAJOR)],
    "conv2_presplit": [
        ("  constexpr int WS = wstride(COUT);\n  const float* wl = w + 2 * t * WS + n0 + g;",
         "  constexpr int WS = COUT == 32 ? 68 : wstride(COUT);\n"
         "  constexpr int PS = COUT == 32 ? 2 : 1;\n"
         "  const float* wl = w + 2 * t * WS + PS * (n0 + g);"),
        (J_LOOP, PRESPLIT_J),
        ("// One conv over a block's npix output pixels", STAGE_SPLIT),
        ("  stage_weights<32>(reg_w, k2);\n", "  stage_split32(reg_w, k2);\n")],
    "warps8": [("constexpr int NW = 16;", "constexpr int NW = 8;")],
    "warps12": [("constexpr int NW = 16;", "constexpr int NW = 12;")],
    "tile5x15": [("constexpr int TR = 7, TC = 11;", "constexpr int TR = 5, TC = 15;")],
    "tile6x13": [("constexpr int TR = 7, TC = 11;", "constexpr int TR = 6, TC = 13;")],
}
# each cut leaves one part's work out (its results are wrong): as_is minus
# a cut's time is what that part costs
CUTS = {
    "cut_input": [("                 ? to_f32(xb[(static_cast<size_t>(iy) * S + ix) * 3 + ch])",
                   "                 ? 1.f")],
    "cut_conv1_mma": [("  for (int ks = 0; ks < 4; ++ks) {\n    Frag a;",
                       "  for (int ks = 0; ks < 0; ++ks) {\n    Frag a;")],
    "cut_conv2_mma": [("    for (int ks = 0; ks < 4; ++ks) {\n      const float2 x0",
                       "    for (int ks = 0; ks < 4 * (COUT == 64); ++ks) {\n      const float2 x0")],
    "cut_pool_atomics": [("        atomicMax(p, __float_as_int(v0));\n        atomicMax(p + 1, __float_as_int(v1));",
                          "        if (v0 == 1.2345f) *p = __float_as_int(v1);")],
    "cut_conv3_staging": [("  stage_weights<64>(reg_w, k3);\n", "")],
}


def build() -> dict:
    """{variant: ctypes library}, every nvcc started together."""
    csrc = os.path.join(ROOT, "sparkdl_torch", "csrc")
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    out_root = os.path.join(ROOT, "sparkdl_torch", "_build", "variants", SOURCE)
    shutil.rmtree(out_root, ignore_errors=True)
    srcs = {f: open(os.path.join(csrc, f)).read() for f in [f"{SOURCE}.cu"] + headers}
    procs = {}
    for name, edits in {**VARIANTS, **CUTS}.items():
        texts = dict(srcs)
        for old, new in edits:
            hits = [f for f, text in texts.items() if old in text]
            if len(hits) != 1:
                raise SystemExit(f"{name}: {old[:60]!r} is in {hits}, not one file")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        d = os.path.join(out_root, name)
        os.makedirs(d)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        lib = os.path.join(d, f"lib{name}.so")
        cmd = [_dispatch._nvcc(), *_dispatch.NVCC_FLAGS, "-o", lib,
               os.path.join(d, f"{SOURCE}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        usage = sorted({ln.split(":")[-1].strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln})
        print(f"[build] {name}: {'; '.join(usage)}", flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def use(lib) -> None:
    """Route the wrapper's launches of csrc/stem_fused.cu to this build."""
    _dispatch._LIBS[SOURCE] = lib


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stem_variants: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sparkdl_torch.models.inception_fused import (
        fused_inception_v3_features,
        prepare_fused_inception_v3,
    )
    from sparkdl_torch.models.registry import build_torch_model
    from sparkdl_torch.ops.fold import fold_tf_preprocess
    from sparkdl_torch.ops.stem_fused import (
        fold_stem_params,
        inception_stem_fused,
        stem_reference,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    libs = build()
    model = build_torch_model("InceptionV3", "random", include_top=False,
                              device="cuda", seed=0)
    state = fold_tf_preprocess(model.state_dict())
    folded = fold_stem_params(state)
    params = prepare_fused_inception_v3(state)
    rng = np.random.default_rng(1)
    x_u8 = torch.from_numpy(rng.integers(0, 256, (cs.BATCH, cs.SIZE, cs.SIZE, 3),
                                         dtype=np.uint8)).cuda()
    x_f32 = x_u8.float()
    want = stem_reference(x_f32, folded)
    rows = x_f32[:8]
    with torch.inference_mode():
        want_net = fused_inception_v3_features(params, rows, dtype=torch.float32, stem=stem_reference)
    for name in VARIANTS:
        use(libs[name])
        parts = []
        for label, x in (("f32", x_f32), ("u8", x_u8)):
            got = inception_stem_fused(x, folded, dtype=torch.float32)
            same = torch.equal(got, inception_stem_fused(x, folded, dtype=torch.float32))
            parts.append(f"{label} {cs._rel_err(got, want)[1]:.2e}"
                         + ("" if same else " REPEAT-DIFFERS"))
        with torch.inference_mode():
            net = fused_inception_v3_features(params, rows, dtype=torch.float32, stem=inception_stem_fused)
        print(f"[accuracy] {name}: stem rel err {', '.join(parts)} (tol {cs.STEM_TOL}); "
              f"8-row featurizer vs plain-stem forward {cs._rel_err(net, want_net)[1]:.2e} "
              f"(tol {cs.NET_TOL})", flush=True)
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            use(libs[name])
            ms = cs._device_ms(lambda: inception_stem_fused(x_f32, folded, dtype=torch.float32))
            print(f"[time] round {rnd} {name}: {ms:.4f} ms (B={cs.BATCH}, S={cs.SIZE}, "
                  f"f32, CUDA-graph replay; {card})", flush=True)
    _dispatch._LIBS.pop(SOURCE, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
