#!/usr/bin/env python3
"""Variants of the flash attention backward kernels, built and timed on one GPU.

    python3 tools/flash_bwd_variants.py

Builds ``sparkdl_torch/csrc/flash_attention_bwd.cu`` as it stands and a few
edited copies of it (one D = 64 instantiation per type, into
``sparkdl_torch/_build/variants/``), then prints for each:

- BERT-base's worst first-step gradient error against ``attn_impl="full"``
  (chip_smoke.py's [train_bert] check: per tensor, relative to its largest
  value floored at 1e-3 of the largest of all; tolerance 1e-4);
- the kernels' dq/dk/dv error against the plain backward relative to
  max|ref|, float32, at L = 128, 197 and 512 (H = 12, D = 64, no mask);
- dq and dk/dv device time per call (torch.profiler) at the BERT-base
  fine-tune shape (B = 32, L = 128, H = 12, D = 64, float32, right-padded
  key mask), in two rounds, the second in reverse order.

The variants:

- ``as_is``: the source;
- ``chain_all``: S and dP chain their three TF32 passes through the
  accumulator too, as dq, dk and dv do;
- ``rn_all``: dq, dk and dv sum each k-step from zero too, as S and dP do;
- ``tile32``: 32-row loop tiles instead of 16.

Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import _kernel_times  # noqa: E402
from sparkdl_torch.ops import _dispatch  # noqa: E402
from sparkdl_torch.ops import flash_attention as fa  # noqa: E402

D64_ONLY = [
    ("  if (a.D <= 16) return run<T, 16>(which, a, B, stream, attrs);\n"
     "  if (a.D <= 32) return run<T, 32>(which, a, B, stream, attrs);\n"
     "  if (a.D <= 64) return run<T, 64>(which, a, B, stream, attrs);\n"
     "  return run<T, 128>(which, a, B, stream, attrs);",
     "  return run<T, 64>(which, a, B, stream, attrs);"),
]
VARIANTS = {
    "as_is": [],
    "chain_all": [("Op<T>::mma_rn(c[j], a, Op<T>::load_b_nk(",
                   "Op<T>::mma(c[j], a, Op<T>::load_b_nk(")],
    "rn_all": [("Op<T>::mma(acc[n], a, Op<T>::load_b_kn(",
                "Op<T>::mma_rn(acc[n], a, Op<T>::load_b_kn(")],
    "tile32": [("constexpr int BL = 16;", "constexpr int BL = 32;")],
}


def build() -> dict:
    csrc = os.path.join(ROOT, "sparkdl_torch", "csrc")
    files = ["flash_attention_bwd.cu"] + sorted(f for f in os.listdir(csrc)
                                                if f.endswith(".cuh"))
    srcs = {f: open(os.path.join(csrc, f)).read() for f in files}
    out_root = os.path.join(ROOT, "sparkdl_torch", "_build", "variants")
    shutil.rmtree(out_root, ignore_errors=True)
    procs = {}
    for name, edits in VARIANTS.items():
        texts = dict(srcs)
        for old, new in D64_ONLY + edits:
            hits = [f for f, text in texts.items() if old in text]
            if len(hits) != 1:
                raise SystemExit(f"variant {name}: {old[:60]!r} is in {hits}, not one file")
            texts[hits[0]] = texts[hits[0]].replace(old, new)
        d = os.path.join(out_root, name)
        os.makedirs(d)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        lib = os.path.join(d, f"lib{name}.so")
        cmd = [_dispatch._nvcc(), *_dispatch.NVCC_FLAGS, "-o", lib,
               os.path.join(d, "flash_attention_bwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        usage = sorted({ln.split(":")[-1].strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln})
        print(f"[build] {name}: {'; '.join(usage)}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def use(lib) -> None:
    """Route flash_attention_bwd's launches to this build."""
    _dispatch._LIBS["flash_attention_bwd"] = lib


def bert_checker():
    from sparkdl_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
        init_bert_,
    )

    cfg = BertConfig.base(attn_impl="flash")
    state = init_bert_(BertForSequenceClassification(cfg, num_labels=2, device="cpu"),
                       seed=0).state_dict()
    rng = np.random.default_rng(9)
    mask = torch.arange(128)[None] < torch.from_numpy(rng.integers(16, 129, 32))[:, None]
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 128))) * mask
    labels = torch.from_numpy(rng.integers(0, 2, 32))
    ids, mask, labels = ids.cuda(), mask.cuda(), labels.cuda()

    def grads(impl):
        m = BertForSequenceClassification(dataclasses.replace(cfg, attn_impl=impl),
                                          num_labels=2, device="cuda")
        m.load_state_dict(state)
        torch.nn.functional.cross_entropy(m(ids, mask), labels).backward()
        return {n: p.grad for n, p in m.named_parameters()}

    full = grads("full")
    floor = 1e-3 * max(float(g.abs().max()) for g in full.values())

    def worst_rel():
        flash = grads("flash")
        return max(float((flash[n] - g).abs().max()) / max(float(g.abs().max()), floor)
                   for n, g in full.items())

    return worst_rel


def kernel_err(b: int, length: int) -> str:
    r = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(r.standard_normal((b, length, 12, 64), dtype=np.float32))
                   .cuda() for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, None, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, None, o, lse, do)
    want = fa.flash_attention_bwd_reference(q, k, v, None, o, lse, do)
    return "/".join(f"{float((g - w).abs().max() / w.abs().max()):.1e}"
                    for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}")
    libs = build()
    worst_rel = bert_checker()
    for name, lib in libs.items():
        use(lib)
        print(f"[accuracy] {name}: BERT first-step worst gradient rel {worst_rel():.2e} "
              f"(tol 1e-4); kernels dq/dk/dv rel err L=128 {kernel_err(32, 128)}, "
              f"L=197 {kernel_err(8, 197)}, L=512 {kernel_err(2, 512)}", flush=True)
    r = np.random.default_rng(1)
    b, length = 32, 128
    q, k, v, do = (torch.from_numpy(r.standard_normal((b, length, 12, 64), dtype=np.float32))
                   .cuda() for _ in range(4))
    mask = (torch.arange(length)[None]
            < torch.from_numpy(r.integers(16, length + 1, b))[:, None]).cuda()
    o, lse = fa.flash_attention(q, k, v, mask, return_lse=True)
    order = list(libs)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            use(libs[name])
            t = _kernel_times(lambda: fa.flash_attention_bwd(q, k, v, mask, o, lse, do),
                              reps=20)
            dq = sum(ms for n, ms in t.items() if "flash_bwd_dq_kernel" in n)
            dkv = sum(ms for n, ms in t.items() if "flash_bwd_dkv_kernel" in n)
            print(f"[time] round {rnd} {name}: dq {dq:.4f} ms, dk/dv {dkv:.4f} ms, "
                  f"pair {dq + dkv:.4f} ms (B={b} L={length} H=12 D=64 f32; {card})",
                  flush=True)
    _dispatch._LIBS.pop("flash_attention_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
