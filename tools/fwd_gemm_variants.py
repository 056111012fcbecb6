#!/usr/bin/env python3
"""Variants of the flash attention forward and the fused GEMM + BN-stats
kernels, built and measured on one GPU.

    python3 tools/fwd_gemm_variants.py

Builds ``sparkdl_torch/csrc/flash_attention.cu`` (one D = 64 instantiation
per type) and ``sparkdl_torch/csrc/fused_gemm_bn.cu`` as they stand and a
few edited copies of each (into ``sparkdl_torch/_build/variants/``, all
``nvcc`` started together), then prints for each:

- forward: BERT-base's worst first-step gradient error against
  ``attn_impl="full"`` (chip_smoke.py's [train_bert] check, tolerance 1e-4;
  tools/flash_bwd_variants.py's checker), the error against
  ``flash_attention_reference`` relative to
  max|ref| (output; lse on rows with a valid key), float32 and bfloat16, at
  chip_smoke.py's three attention cases (GPT-2 prefill, cached prefill with
  q_offset, L = 197), and the kernel's device time per call (torch.profiler)
  at the GPT-2 prefill and the BERT fine-tune shape, f32, in two rounds, the
  second in reverse order;
- GEMM: the worst error of y (relative to max|ref|) and of the batch
  mean/var against ``reference_conv1x1_bn_stats`` over the seven ResNet50
  shapes (K up to 2048), f32, and one step's 25 launches' device time
  (CUDA-graph replay), in two rounds.

The variants:

- forward ``as_is``; ``pv_chain``: P.V chains its k-steps through the
  output's accumulator (S still sums each from zero); ``blocks4``: a
  register budget for 4 blocks an SM at D <= 64 instead of 3; ``q_regs``:
  the warp's Q fragments (TF32-split) held in registers for the whole key
  loop instead of re-read from shared memory each tile; ``bl16``: 16-key
  loop tiles instead of 32;
- GEMM ``as_is``; ``run1``, ``run2``: one or two k-steps summed from
  zero before they reach the accumulator instead of a ring stage's four
  (float32; bfloat16 has two); ``chain``: every k-step chained through
  the accumulator; ``bm128``: 128-row blocks of 8 warps instead of 64-row
  blocks of 4; ``m_fast``: the grid's fastest axis walks M tiles instead
  of N tiles (neighbouring blocks then share no rows of x); ``small_rn``:
  the split's small half rounded to TF32 instead of left for the tensor
  cores to truncate; ``bm128_w64x32``, ``bm128_w32x64``: 128-row blocks of
  4 warps, each owning 64 x 32 or 32 x 64 outputs instead of 32 x 32;
  ``bk64``: 64-wide K slices (2 blocks an SM); ``stages4``: a 4-stage ring.

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

sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
from flash_bwd_variants import bert_checker  # noqa: E402
from sparkdl_torch.ops import _dispatch  # noqa: E402
from sparkdl_torch.ops import flash_attention as fa  # noqa: E402
from sparkdl_torch.ops import fused_gemm_bn as fg  # noqa: E402

FWD_D64_ONLY = [
    ("  if (a.D <= 16) return run<T, 16>(a, B, stream, attrs);\n"
     "  if (a.D <= 32) return run<T, 32>(a, B, stream, attrs);\n"
     "  if (a.D <= 64) return run<T, 64>(a, B, stream, attrs);\n"
     "  return run<T, 128>(a, B, stream, attrs);",
     "  return run<T, 64>(a, B, stream, attrs);"),
]
VARIANTS = {
    "flash_attention": (FWD_D64_ONLY, {
        "as_is": [],
        "pv_chain": [("gemm_cy<T, DP, NJ, true>(", "gemm_cy<T, DP, NJ, false>(")],
        "blocks4": [("__launch_bounds__(NT, DP <= 64 ? 3 : 2)",
                     "__launch_bounds__(NT, DP <= 64 ? 4 : 2)")],
        "q_regs": [("  fetch(0, 0);\n",
                    "  typename mma3::Op<T>::A qf[DP / mma3::Op<T>::K];\n  fetch(0, 0);\n"),
                   ("    gemm_xyt<T, DP, NJ>(s, sQ + 16 * w * RS, sK + buf * BL * RS, g, t);",
                    "    if (kt == 0)\n"
                    "#pragma unroll\n"
                    "      for (int ks = 0; ks < DP / mma3::Op<T>::K; ++ks)\n"
                    "        qf[ks] = mma3::Op<T>::load_a(sQ + 16 * w * RS, RS, ks, g, t);\n"
                    "#pragma unroll\n"
                    "    for (int ks = 0; ks < DP / mma3::Op<T>::K; ++ks)\n"
                    "#pragma unroll\n"
                    "      for (int j = 0; j < NJ; ++j)\n"
                    "        mma3::Op<T>::mma_rn(s[j], qf[ks], mma3::Op<T>::load_b_nk(\n"
                    "            sK + buf * BL * RS, RS, 8 * j, ks, g, t));")],
        "bl16": [("constexpr int BL = 32;", "constexpr int BL = 16;")],
    }),
    "fused_gemm_bn": ([], {
        "as_is": [],
        "run1": [("constexpr int RUN = KSTEPS;", "constexpr int RUN = 1;")],
        "run2": [("constexpr int RUN = KSTEPS;", "constexpr int RUN = 2;")],
        "chain": [("Op<T>::mma(part[i][j], af[i], bf)", "Op<T>::mma(acc[i][j], af[i], bf)")],
        "bm128": [("constexpr int BM = 64;", "constexpr int BM = 128;"),
                  ("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 2;")],
        "m_fast": [("const int mt = blockIdx.y, nt = blockIdx.x;",
                    "const int mt = blockIdx.x, nt = blockIdx.y;"),
                   ("<<<dim3((a.N + BN - 1) / BN, tiles),", "<<<dim3(tiles, (a.N + BN - 1) / BN),")],
        "small_rn": [("  small = __float_as_uint(x - __uint_as_float(big));",
                      "  small = tf32_rna(x - __uint_as_float(big));")],
        "bm128_w64x32": [("constexpr int BM = 64;", "constexpr int BM = 128;"),
                         ("constexpr int WM = 32, WN = 32;", "constexpr int WM = 64, WN = 32;"),
                         ("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 2;")],
        "bm128_w32x64": [("constexpr int BM = 64;", "constexpr int BM = 128;"),
                         ("constexpr int WM = 32, WN = 32;", "constexpr int WM = 32, WN = 64;"),
                         ("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 2;")],
        "bk64": [("constexpr int BK = 32;", "constexpr int BK = 64;"),
                 ("constexpr int MIN_BLOCKS = 4;", "constexpr int MIN_BLOCKS = 2;")],
        "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    }),
}


def build() -> dict:
    """{(source, variant): ctypes library}, every nvcc started together."""
    csrc = os.path.join(ROOT, "sparkdl_torch", "csrc")
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    out_root = os.path.join(ROOT, "sparkdl_torch", "_build", "variants")
    shutil.rmtree(out_root, ignore_errors=True)
    procs = {}
    for source, (base, variants) in VARIANTS.items():
        srcs = {f: open(os.path.join(csrc, f)).read() for f in [f"{source}.cu"] + headers}
        for name, edits in variants.items():
            texts = dict(srcs)
            for old, new in base + edits:
                hits = [f for f, text in texts.items() if old in text]
                if len(hits) != 1:
                    raise SystemExit(f"{source} {name}: {old[:60]!r} is in {hits}, not one file")
                texts[hits[0]] = texts[hits[0]].replace(old, new)
            d = os.path.join(out_root, source, name)
            os.makedirs(d)
            for f, text in texts.items():
                with open(os.path.join(d, f), "w") as out:
                    out.write(text)
            lib = os.path.join(d, f"lib{name}.so")
            cmd = [_dispatch._nvcc(), *_dispatch.NVCC_FLAGS, "-o", lib,
                   os.path.join(d, f"{source}.cu")]
            procs[source, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {key} failed:\n{log}")
        usage = sorted({ln.split(":")[-1].strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln})
        print(f"[build] {key[0]} {key[1]}: {'; '.join(usage)}", flush=True)
        libs[key] = ctypes.CDLL(lib)
    return libs


def use(source: str, lib) -> None:
    """Route the wrapper's launches of csrc/<source>.cu to this build."""
    _dispatch._LIBS[source] = lib


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()


def fwd_errors() -> str:
    rng = np.random.default_rng(4)
    parts = []
    for name, b, lq, lk, causal, q_offset in (
            ("gpt2_prefill", 16, 128, 128, True, 0),
            ("cached_prefill", 16, 64, 128, True, 64),
            ("L197", 8, 197, 197, False, 0)):
        q, k, v = _rand(rng, b, lq, 12, 64), _rand(rng, b, lk, 12, 64), _rand(rng, b, lk, 12, 64)
        mask = cs._left_padded_mask(rng, b, lk)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got, lse = fa.flash_attention(qd, kd, vd, mask, causal=causal, q_offset=q_offset,
                                          return_lse=True)
            ref, rlse = fa.flash_attention_reference(qd, kd, vd, mask, causal=causal,
                                                     q_offset=q_offset, return_lse=True)
            live = rlse > -1e29
            dead_ok = torch.equal(lse > -1e29, live)
            _, rel = cs._rel_err(got, ref)
            _, lrel = cs._rel_err(lse[live], rlse[live])
            parts.append(f"{name} {'f32' if dtype == torch.float32 else 'bf16'} "
                         f"{rel:.1e}/{lrel:.1e}{'' if dead_ok else ' DEAD-ROWS-DIFFER'}")
    return ", ".join(parts) + f" (tol f32 {cs.ATTN_TOL}, bf16 {cs.BF16_TOL}; lse {cs.ATTN_TOL})"


def fwd_timers():
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, 16, 128, 12, 64) for _ in range(3))
    gpt_mask = cs._left_padded_mask(rng, 16, 128)
    bq, bk, bv = (_rand(rng, 32, 128, 12, 64) for _ in range(3))
    bert_mask = cs._right_padded_mask(rng, 32, 128)
    return {
        "gpt2_prefill": lambda: fa.flash_attention(q, k, v, gpt_mask, causal=True),
        "bert": lambda: fa.flash_attention(bq, bk, bv, bert_mask, return_lse=True),
    }


def gemm_errors() -> str:
    rng = np.random.default_rng(8)
    worst = {"y": 0.0, "mean": 0.0, "var": 0.0}
    for m, k, n, _, prev in cs.RESNET_GEMMS:
        x = _rand(rng, m // 49, 7, 7, k)
        w = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
            np.float32)).cuda().t()
        bias = _rand(rng, n) * 0.1
        bn = None
        if prev:
            bn = (_rand(rng, k) * 0.2, torch.rand(k, device="cuda") + 0.5,
                  _rand(rng, k) * 0.5 + 1.0, _rand(rng, k) * 0.1, 1.001e-5)
        got = fg.conv1x1_bn_stats(x, w, bias, prev_bn=bn, relu_in=prev)
        want = fg.reference_conv1x1_bn_stats(x, w, bias, prev_bn=bn, relu_in=prev)
        for g, r, what in zip(got, want, ("y", "mean", "var")):
            worst[what] = max(worst[what], cs._rel_err(g, r)[1])
    return (", ".join(f"{w} {e:.2e}" for w, e in worst.items())
            + f" (tol y {cs.GEMM_TOL}, mean/var {cs.STATS_TOL}; 7 ResNet50 shapes, K <= 2048)")


def gemm_step_ms() -> float:
    rng = np.random.default_rng(2)
    total = 0.0
    for m, k, n, count, prev in cs.RESNET_GEMMS:
        x = _rand(rng, m, k)
        w = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
            np.float32)).cuda().t()
        bias = _rand(rng, n) * 0.1
        sc = sh = None
        if prev:
            sc, sh = torch.rand(k, device="cuda") + 0.5, _rand(rng, k) * 0.1
        total += count * cs._device_ms(lambda: fg.gemm_bn_stats(x, w, sc, sh, bias,
                                                                relu_in=prev))
    return total


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("fwd_gemm_variants: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}", flush=True)
    libs = build()
    fwd = [name for (src, name) in libs if src == "flash_attention"]
    gemm = [name for (src, name) in libs if src == "fused_gemm_bn"]
    worst_rel = bert_checker()
    for name in fwd:
        use("flash_attention", libs["flash_attention", name])
        print(f"[fwd accuracy] {name}: BERT first-step worst gradient rel {worst_rel():.2e} "
              f"(tol 1e-4); rel err out/lse {fwd_errors()}", flush=True)
    timers = fwd_timers()
    for rnd, names in enumerate((fwd, fwd[::-1])):
        for name in names:
            use("flash_attention", libs["flash_attention", name])
            ms = {shape: cs._one_ms(cs._kernel_times(fn, reps=20), "flash_fwd_kernel")
                  for shape, fn in timers.items()}
            print(f"[fwd time] round {rnd} {name}: " + ", ".join(
                f"{shape} {t:.4f} ms" for shape, t in ms.items())
                + f" (f32, D=64, H=12; B=16 L=128 causal, B=32 L=128; {card})", flush=True)
    for name in gemm:
        use("fused_gemm_bn", libs["fused_gemm_bn", name])
        print(f"[gemm accuracy] {name}: worst rel err {gemm_errors()}", flush=True)
    for rnd, names in enumerate((gemm, gemm[::-1])):
        for name in names:
            use("fused_gemm_bn", libs["fused_gemm_bn", name])
            print(f"[gemm time] round {rnd} {name}: one ResNet50 step's 25 launches "
                  f"{gemm_step_ms():.3f} ms (f32, CUDA-graph replay; {card})", flush=True)
    for source in VARIANTS:
        _dispatch._LIBS.pop(source, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
