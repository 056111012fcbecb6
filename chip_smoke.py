#!/usr/bin/env python3
"""Smoke run of sparkdl_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``sparkdl_torch/csrc/`` (into
``sparkdl_torch/_build/``), holds each kernel against its plain PyTorch
version at the shapes of the paths that run it, then drives the port's
four paths, each on random weights from a fixed seed, and checks that
each went through its kernels and agrees with a kernel-free run:

- ``DeepImageFeaturizer(modelName="InceptionV3")`` over a LocalDataFrame
  of 256 random 299x299 images (the stem kernel);
- ``DeepTextGenerator`` at GPT-2-small width over 64 random prompts
  (the flash attention and flash decode kernels);
- ``finetune_classifier`` over BERT-base, 20 batches of 32 x 128 tokens
  (the flash attention forward and its two backward kernels);
- the fused ResNet50 train step at 224 px, batch 64 (the fused 1x1-conv
  GEMM + BN-stats kernel).

Each phase prints one line; any failure raises and exits non-zero. The
last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

H100_F32_FLOPS = 67e12    # FP32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 tensor cores
H100_BYTES_S = 3.35e12    # HBM3

BATCH, SIZE = 64, 299
N_ROWS, N_PARTS = 256, 4
STEM_TOL = 1e-5   # f32 kernel vs f32 plain: only the summation order differs
NET_TOL = 1e-4    # after ~90 more f32 cuDNN convs on both sides

HEADS, HEAD_DIM = 12, 64            # GPT-2 small (and BERT/ViT base)
GEN_BATCH, GEN_LEN, GEN_NEW = 16, 128, 32
GEN_ROWS = 64
BERT_BATCH, BERT_LEN = 32, 197      # BERT/ViT base: ViT-B/16 has 197 tokens
ATTN_TOL = 1e-5        # f32 kernel vs f32 plain: only the summation order differs
BF16_TOL = 2.0 ** -6   # two bf16 steps: each side rounds P and the output itself
LOGIT_TOL = 1e-4       # 12 layers of f32 on both sides, attention sums reordered


BWD_TOL = 1e-4          # f32 backward kernels vs plain: sums over L reordered
BWD_BF16_TOL = 2.0 ** -5
GEMM_TOL, STATS_TOL, GEMM_BF16_TOL = 1e-5, 1e-4, 3e-2
BERT_STEPS, BERT_TRAIN_BATCH, BERT_TRAIN_LEN = 20, 32, 128
RESNET_BATCH, RESNET_SIZE, RESNET_STEPS = 64, 224, 10


def _zero_counts():
    """Set every kernel wrapper's launch count to 0."""
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from sparkdl_torch.ops.flash_decode import flash_decode
    from sparkdl_torch.ops.fused_gemm_bn import gemm_bn_stats
    from sparkdl_torch.ops.stem_fused import inception_stem_fused

    for fn in (inception_stem_fused, flash_attention, flash_decode, gemm_bn_stats):
        fn.launches = 0
    flash_attention_bwd.launches_dq = flash_attention_bwd.launches_dkv = 0


def _time_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median of per-call CUDA-event times."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def _device_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph and
    replayed ``reps`` times between CUDA events (median), so the host's
    per-call cost (Python, argument checks, launch) is not in the number.
    Inputs stay where the caller left them (hot in L2 when they fit)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return sorted(times)[len(times) // 2]


def _rel_err(got, want) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[card] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s), torch {torch.__version__} CUDA {torch.version.cuda}; "
          "TF32 off for cuDNN convs and matmuls (float32 throughout)")
    print(card)
    return card


def phase_build():
    from sparkdl_torch.ops import _dispatch

    t0 = time.perf_counter()
    built = _dispatch.build_all()
    secs = time.perf_counter() - t0
    for name, (s, log) in built.items():
        usage = sorted({ln.split(":")[-1].strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln})
        print(f"[build] {name}.cu in {s:.1f} s: {'; '.join(usage)}")
    for src in _dispatch.sources():
        _dispatch.load_library(src.stem)
    print(f"[build] {len(built)} built, {len(_dispatch.sources())} loaded, "
          f"{secs:.1f} s wall")


def phase_stem():
    import numpy as np
    import torch

    from sparkdl_torch.models.registry import build_torch_model
    from sparkdl_torch.ops.fold import fold_tf_preprocess
    from sparkdl_torch.ops.stem_fused import (
        fold_stem_params,
        inception_stem_fused,
        stem_out_size,
        stem_reference,
    )

    model = build_torch_model("InceptionV3", "random", include_top=False,
                              device="cuda", seed=0)
    folded = fold_stem_params(fold_tf_preprocess(model.state_dict()))
    rng = np.random.default_rng(1)
    x_u8 = torch.from_numpy(
        rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
    x_f32 = x_u8.float()
    want = stem_reference(x_f32, folded)
    errs = {}
    for label, x, dtype, tol in (("f32->f32", x_f32, torch.float32, STEM_TOL),
                                 ("u8->f32", x_u8, torch.float32, STEM_TOL),
                                 # both round to bf16: one bf16 step apart at most
                                 ("u8->bf16", x_u8, torch.bfloat16, 2.0 ** -7)):
        got = inception_stem_fused(x, folded, dtype=dtype)
        torch.cuda.synchronize()
        ref = want if dtype == torch.float32 else want.to(dtype)
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"stem {label}: bad output {tuple(got.shape)}")
        errs[label] = _rel_err(got, ref)
        if errs[label][1] > tol:
            raise AssertionError(f"stem {label}: rel err {errs[label][1]:.3e} > {tol}")

    ms = _time_ms(lambda: inception_stem_fused(x_f32, folded))
    plain_ms = _time_ms(lambda: stem_reference(x_f32, folded))
    h1 = (SIZE - 3) // 2 + 1
    h2 = h1 - 2
    macs = BATCH * (h1 * h1 * 27 * 32 + h2 * h2 * 288 * 32 + h2 * h2 * 288 * 64)
    rp = stem_out_size(SIZE)
    nbytes = (x_f32.numel() * 4 + sum(p.numel() * 4 for p in folded.values())
              + BATCH * rp * rp * 64 * 4)
    ops_ms = 2 * macs / H100_F32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print("[stem] B=%d S=%d: rel err %s (tol %g); kernel %.3f ms, plain %.3f ms, "
          "bound %.3f ms (%s: %.2f GFLOP at 67 TFLOP/s f32; %.1f MB at 3.35 TB/s "
          "= %.3f ms; TF32 floor %.3f ms); library_ms null: no single PyTorch "
          "call computes the stem" % (
              BATCH, SIZE, ", ".join(f"{k} {v[1]:.2e}" for k, v in errs.items()),
              STEM_TOL, ms, plain_ms, bound_ms,
              "operations" if ops_ms >= bytes_ms else "bytes", 2 * macs / 1e9,
              nbytes / 1e6, bytes_ms, 2 * macs / H100_TF32_FLOPS * 1e3))
    return {
        "name": "inception_stem_fused", "route": "cuda",
        "source": "sparkdl_torch/csrc/stem_fused.cu",
        "replaces": "sparkdl_tpu/ops/stem_fused.py:242",
        "launches": None, "max_abs_err": errs["f32->f32"][0], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def _png_dir(root: str, rng) -> int:
    """A few PNGs (one not at the model's size) and one corrupt file."""
    from PIL import Image

    shapes = [(SIZE, SIZE)] * 4 + [(150, 200)]
    for i, (h, w) in enumerate(shapes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype="uint8")).save(
            os.path.join(root, f"img{i}.png"))
    with open(os.path.join(root, "corrupt.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n this is not an image")
    return len(shapes)


def phase_main_path(stem_entry: dict):
    import numpy as np
    import torch

    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame, readImagesWithCustomFn
    from sparkdl_torch.image import (
        PIL_decode_bytes,
        imageArrayToStructBGR,
        undefined_image,
    )
    from sparkdl_torch.models.inception_fused import (
        fused_inception_v3_features,
        prepare_fused_inception_v3,
    )
    from sparkdl_torch.ops.fold import fold_tf_preprocess
    from sparkdl_torch.ops.stem_fused import inception_stem_fused, stem_reference
    from sparkdl_torch.transformers.named_image import _load_named_model

    rng = np.random.default_rng(2)
    featurizer = DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="InceptionV3",
        weights="random", batchSize=BATCH)

    # files -> readImagesWithCustomFn -> featurizer: the corrupt file is an
    # undefined row and comes out None
    with tempfile.TemporaryDirectory() as root:
        n_png = _png_dir(root, rng)
        files = readImagesWithCustomFn(root, PIL_decode_bytes, numPartition=2)
        rows = featurizer.transform(files).collect()
    bad = [r for r in rows if r["filePath"].endswith("corrupt.png")]
    good = [r for r in rows if not r["filePath"].endswith("corrupt.png")]
    if len(good) != n_png or len(bad) != 1 or bad[0]["features"] is not None:
        raise AssertionError("PNG rows: corrupt file not an undefined None row")
    for r in good:
        f = r["features"]
        if f is None or f.shape != (2048,) or not np.isfinite(f).all():
            raise AssertionError(f"PNG row {r['filePath']}: bad features")
    print(f"[files] {n_png} PNGs + 1 corrupt via readImagesWithCustomFn: "
          f"{n_png} x 2048 finite features, corrupt row None")

    # the DataFrame: 256 random images + one undefined row, 4 partitions
    images = rng.integers(0, 256, (N_ROWS, SIZE, SIZE, 3), dtype=np.uint8)
    rows_in = [{"id": i, "image": imageArrayToStructBGR(images[i])}
               for i in range(N_ROWS)]
    rows_in.insert(N_ROWS // 3, {"id": -1, "image": undefined_image("none")})
    df = LocalDataFrame.from_rows(rows_in, N_PARTS)
    n_batches = sum(r["n"] for r in df.mapPartitions(
        lambda part: [{"n": math.ceil(sum(r["id"] >= 0 for r in part) / BATCH)}]
    ).collect())

    featurizer.transform(df).collect()  # warm-up: model, runner, cuDNN plans
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out = featurizer.transform(df).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = inception_stem_fused.launches

    by_id = {r["id"]: r["features"] for r in out}
    if len(out) != N_ROWS + 1 or by_id[-1] is not None:
        raise AssertionError("undefined row did not come out None")
    feats = np.stack([by_id[i] for i in range(N_ROWS)])
    if feats.shape != (N_ROWS, 2048) or not np.isfinite(feats).all():
        raise AssertionError(f"features: bad shape or values {feats.shape}")
    if launches != n_batches:
        raise AssertionError(
            f"stem kernel launched {launches} times for {n_batches} batches")

    # 8 rows against the same forward with the plain stem
    module = _load_named_model("InceptionV3", "random", False, "cuda")
    params = prepare_fused_inception_v3(fold_tf_preprocess(module.state_dict()))
    pick = [0, 1, 63, 64, 100, 150, 200, 255]
    x = torch.from_numpy(images[pick].astype(np.float32)).cuda()  # RGB as fed
    with torch.inference_mode():
        want = fused_inception_v3_features(params, x, stem=stem_reference)
    abs_err, rel = _rel_err(torch.from_numpy(feats[pick]), want.cpu())
    if rel > NET_TOL:
        raise AssertionError(f"featurizer vs plain-stem forward: rel err {rel:.3e}")

    # where the transform's time goes: the forward alone on a device batch
    x = torch.from_numpy(images[:BATCH].astype(np.float32)).cuda()
    with torch.inference_mode():
        fwd = {name: _time_ms(lambda s=s: fused_inception_v3_features(
                   params, x, stem=s), warmup=2, reps=10)
               for name, s in (("kernel", inception_stem_fused),
                               ("plain", stem_reference))}
    print(f"[forward] fused InceptionV3 forward, B={BATCH} already on the device: "
          f"{fwd['kernel']:.2f} ms with the stem kernel "
          f"({BATCH / fwd['kernel'] * 1e3:.0f} images/s), {fwd['plain']:.2f} ms "
          f"with the plain stem; the transform takes {secs / n_batches * 1e3:.1f} ms "
          f"per batch, the rest of it on the host (decode, staging, copies)")
    print(f"[main] DeepImageFeaturizer(InceptionV3) over {N_ROWS}+1 rows in "
          f"{N_PARTS} partitions, batchSize {BATCH}: {N_ROWS / secs:.1f} images/s "
          f"(steady state after a warm-up transform, host decode included); "
          f"inception_stem_fused launches {launches} = batches {n_batches}; "
          f"8 rows vs plain-stem forward rel err {rel:.2e} (tol {NET_TOL}); "
          f"mean |feature| {np.abs(feats).mean():.3e}")
    stem_entry["launches"] = launches
    return N_ROWS / secs


def _left_padded_mask(rng, b: int, length: int):
    """bool [B, L] on the card: each row's real keys are a suffix of
    random length 8..L (the generator's left-padded prompts)."""
    import torch

    lens = torch.from_numpy(rng.integers(8, length + 1, b))
    return (torch.arange(length)[None, :] >= (length - lens)[:, None]).cuda()


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    ops_ms = flops / H100_F32_FLOPS * 1e3
    bytes_ms = nbytes / H100_BYTES_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_flash_attention(card: str) -> dict:
    """The kernel against flash_attention_reference on the card, f32 and
    bf16 (output and lse), at the GPT-2 prefill, the cached prefill and
    the BERT/ViT shapes; timed in f32 against its bound and against
    scaled_dot_product_attention on the same inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from sparkdl_torch.ops.flash_attention import (
        _keep_mask,
        flash_attention,
        flash_attention_reference,
    )

    rng = np.random.default_rng(4)
    cases = (  # name, B, Lq, Lk, causal, q_offset
        ("gpt2_prefill", GEN_BATCH, GEN_LEN, GEN_LEN, True, 0),
        ("cached_prefill", GEN_BATCH, GEN_LEN // 2, GEN_LEN, True, GEN_LEN // 2),
        ("bert_vit", BERT_BATCH, BERT_LEN, BERT_LEN, False, 0),
    )
    entry, report = None, []
    for name, b, lq, lk, causal, q_offset in cases:
        q = torch.from_numpy(rng.standard_normal(
            (b, lq, HEADS, HEAD_DIM), dtype=np.float32)).cuda()
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, lk, HEADS, HEAD_DIM), dtype=np.float32)).cuda() for _ in "kv")
        mask = _left_padded_mask(rng, b, lk)
        kw = dict(causal=causal, q_offset=q_offset)
        errs = {}
        for dtype, tol in ((torch.float32, ATTN_TOL), (torch.bfloat16, BF16_TOL)):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got, lse = flash_attention(qd, kd, vd, mask, return_lse=True, **kw)
            torch.cuda.synchronize()
            ref, rlse = flash_attention_reference(qd, kd, vd, mask,
                                                  return_lse=True, **kw)
            if got.shape != ref.shape or not torch.isfinite(got.float()).all():
                raise AssertionError(f"flash_attention {name} {dtype}: bad output")
            live = rlse > -1e29  # rows with at least one valid key
            if not torch.equal(lse > -1e29, live):
                raise AssertionError(f"flash_attention {name} {dtype}: lse rows")
            abs_err, rel = _rel_err(got, ref)
            _, lse_rel = _rel_err(lse[live], rlse[live])
            if rel > tol or lse_rel > ATTN_TOL:
                raise AssertionError(
                    f"flash_attention {name} {dtype}: rel err {rel:.3e} "
                    f"(tol {tol}), lse {lse_rel:.3e} (tol {ATTN_TOL})")
            errs[dtype] = (abs_err, rel, lse_rel)

        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        keep = _keep_mask(b, lq, lk, mask, causal, q_offset, q.device)
        ms = _device_ms(lambda: flash_attention(q, k, v, mask, **kw))
        host_ms = _time_ms(lambda: flash_attention(q, k, v, mask, **kw))
        plain_ms = _device_ms(lambda: flash_attention_reference(q, k, v, mask, **kw))
        library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep))
        n_keys = (sum(min(q_offset + i + 1, lk) for i in range(lq)) if causal
                  else lq * lk)
        flops = 4.0 * b * HEADS * HEAD_DIM * n_keys  # QK and PV, 2 per MAC
        nbytes = 4.0 * HEADS * HEAD_DIM * b * (2 * lq + 2 * lk) + b * lk
        bound_ms, bound_by = _bound(flops, nbytes)
        report.append(
            f"{name} B={b} Lq={lq} Lk={lk}{' causal' if causal else ''}"
            f"{f' q_offset={q_offset}' if q_offset else ''}: rel err f32 "
            f"{errs[torch.float32][1]:.2e} (lse {errs[torch.float32][2]:.2e}), "
            f"bf16 {errs[torch.bfloat16][1]:.2e}; kernel {ms:.4f} ms ({host_ms:.4f} "
            f"per call from the host), plain {plain_ms:.4f}, sdpa "
            f"{library_ms:.4f}, bound {bound_ms:.4f} "
            f"({bound_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB)")
        if entry is None:  # the main path's shape: the GPT-2 prefill
            entry = {
                "name": "flash_attention", "route": "cuda",
                "source": "sparkdl_torch/csrc/flash_attention.cu",
                "replaces": "sparkdl_tpu/ops/flash_attention.py:80",
                "launches": None, "max_abs_err": errs[torch.float32][0],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
            }
    print(f"[flash_attention] H={HEADS} D={HEAD_DIM}, tol f32 {ATTN_TOL} "
          f"bf16 {BF16_TOL} x max|ref|; device ms per call from CUDA-graph "
          f"replays; {card}: " + "; ".join(report))
    return entry


def phase_flash_decode(card: str) -> dict:
    """The kernel against reference_decode on the card at the decode
    shape of the generate path (cache of 160 columns), ragged start,
    idx in {0, 63, 159}, f32 and bf16; timed at idx 159 in f32 against
    its byte bound and against scaled_dot_product_attention."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from sparkdl_torch.ops.flash_decode import flash_decode, reference_decode

    rng = np.random.default_rng(5)
    b, length = GEN_BATCH, GEN_LEN + GEN_NEW
    q = torch.from_numpy(rng.standard_normal(
        (b, 1, HEADS, HEAD_DIM), dtype=np.float32)).cuda()
    ck, cv = (torch.from_numpy(rng.standard_normal(
        (b, length, HEADS, HEAD_DIM), dtype=np.float32)).cuda() for _ in "kv")
    start = torch.from_numpy(
        rng.integers(0, GEN_LEN - 8, b).astype(np.int32)).cuda()
    errs = {}
    for idx in (0, GEN_LEN // 2 - 1, length - 1):
        for dtype, tol in ((torch.float32, ATTN_TOL), (torch.bfloat16, BF16_TOL)):
            qd, kd, vd = (t.to(dtype) for t in (q, ck, cv))
            got = flash_decode(qd, kd, vd, idx, start=start)
            torch.cuda.synchronize()
            ref = reference_decode(qd, kd, vd, idx, start)
            if got.shape != ref.shape or not torch.isfinite(got.float()).all():
                raise AssertionError(f"flash_decode idx={idx} {dtype}: bad output")
            errs[idx, dtype] = _rel_err(got, ref)
            if errs[idx, dtype][1] > tol:
                raise AssertionError(
                    f"flash_decode idx={idx} {dtype}: rel err "
                    f"{errs[idx, dtype][1]:.3e} > {tol}")

    idx = length - 1
    cols = torch.arange(length, device=q.device)
    keep = ((cols[None, :] >= start[:, None]) & (cols[None, :] <= idx))[:, None, None]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, ck, cv))
    ms = _device_ms(lambda: flash_decode(q, ck, cv, idx, start=start))
    host_ms = _time_ms(lambda: flash_decode(q, ck, cv, idx, start=start))
    plain_ms = _device_ms(lambda: reference_decode(q, ck, cv, idx, start))
    library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep))
    live = int((idx + 1 - start.clamp(max=idx + 1)).sum())
    nbytes = 4.0 * HEADS * HEAD_DIM * (2 * live + 2 * b) + 4 * b
    bound_ms, bound_by = _bound(4.0 * HEADS * HEAD_DIM * live, nbytes)
    print(f"[flash_decode] B={b} L={length} H={HEADS} D={HEAD_DIM}, ragged "
          f"start: rel err " + ", ".join(
              f"idx {i} {'f32' if d == torch.float32 else 'bf16'} {e[1]:.2e}"
              for (i, d), e in errs.items())
          + f" (tol f32 {ATTN_TOL}, bf16 {BF16_TOL}); at idx {idx} f32: kernel "
          f"{ms:.4f} ms ({host_ms:.4f} per call from the host), plain "
          f"{plain_ms:.4f}, sdpa {library_ms:.4f}, bound "
          f"{bound_ms:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB of live cache "
          f"at 3.35 TB/s); {card}")
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "sparkdl_torch/csrc/flash_decode.cu",
        "replaces": "sparkdl_tpu/ops/flash_decode.py:37",
        "launches": None, "max_abs_err": errs[idx, torch.float32][0], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def _generate_ms(module, ids, mask, new_tokens: int) -> float:
    """Median ms of one ``generate`` call, prefill included."""
    from sparkdl_torch.models.gpt import generate

    return _time_ms(lambda: generate(module, ids, new_tokens, attention_mask=mask),
                    warmup=1, reps=5)


def _device_split(module, ids, profile_steps: int = 0):
    """Device ms of one cached prefill forward over ``ids`` [B, L] and of
    one decode forward after it (CUDA-graph replays, so without the
    host's per-op cost; each replayed call writes the same cache
    columns), and with ``profile_steps`` a torch.profiler breakdown by
    kernel of that many decode forwards driven from the host, as
    generate drives them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparkdl_torch.models.gpt import first_valid_column, init_cache

    b, lp = ids.shape
    dev = ids.device
    cache = init_cache(module.config, b, lp + GEN_NEW, device=dev)
    key_valid = torch.ones((b, lp + GEN_NEW), dtype=torch.bool, device=dev)
    cache["start"] = first_valid_column(key_valid)
    positions = torch.arange(lp, device=dev).expand(b, lp)
    tok, step_pos = ids[:, -1:], torch.full((b, 1), lp, device=dev)

    def prefill():
        return module(ids, cache={**cache, "idx": 0}, positions=positions,
                      attention_mask=key_valid)

    def decode():
        return module(tok, cache={**cache, "idx": lp}, positions=step_pos,
                      attention_mask=key_valid)

    with torch.inference_mode():
        prefill_ms, decode_ms = _device_ms(prefill, calls=4), _device_ms(decode)
        if not profile_steps:
            return prefill_ms, decode_ms, ""
        prefill()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(profile_steps):
                decode()
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        by_name[e.key] = by_name.get(e.key, 0.0) + us
    total = sum(by_name.values())
    if not total:
        return prefill_ms, decode_ms, "the profiler recorded no device time"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return prefill_ms, decode_ms, (
        f"device {total / profile_steps / 1e3:.3f} ms/step in {len(by_name)} "
        "kernels; " + "; ".join(f"{name[:60]} {us / total:.0%}" for name, us in top))


def phase_generate(card: str, attn_entry: dict, decode_entry: dict) -> float:
    """DeepTextGenerator at GPT-2-small width through both attention
    kernels, against the same transformer and weights with
    attn_impl="full" (no kernel) on the card."""
    import dataclasses

    import numpy as np
    import torch

    from sparkdl_torch import DeepTextGenerator, LocalDataFrame
    from sparkdl_torch.models.gpt import (
        GPTConfig,
        GPTLMHeadModel,
        init_cache,
        init_gpt_,
    )
    from sparkdl_torch.ops.flash_attention import flash_attention
    from sparkdl_torch.ops.flash_decode import flash_decode
    from sparkdl_torch.transformers.text_generator import _model

    # GPT-2 small: GPTConfig's own widths with the learned position table
    cfg = GPTConfig(positions="learned", attn_impl="flash", flash_decode=True)
    full = dataclasses.replace(cfg, attn_impl="full", flash_decode=False)
    t0 = time.perf_counter()
    state = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(8, GEN_LEN + 1, GEN_ROWS)]
    rows = [{"id": i, "prompt": p} for i, p in enumerate(prompts)]
    rows.insert(GEN_ROWS // 3, {"id": -1, "prompt": []})  # bad row -> None
    df = LocalDataFrame.from_rows(rows, N_PARTS)
    groups = sum(r["n"] for r in df.mapPartitions(
        lambda part: [{"n": math.ceil(sum(r["id"] >= 0 for r in part) / GEN_BATCH)}]
    ).collect())

    def transformer(c):
        return DeepTextGenerator(inputCol="prompt", outputCol="gen", model=(c, state),
                                 batchSize=GEN_BATCH, maxLength=GEN_LEN,
                                 maxNewTokens=GEN_NEW)

    gen = transformer(cfg)
    gen.transform(df).collect()  # warm-up: module to the card, cuBLAS
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out = gen.transform(df).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_attn, n_decode = flash_attention.launches, flash_decode.launches
    layers = cfg.num_layers
    if n_attn != layers * groups or n_decode != layers * (GEN_NEW - 1) * groups:
        raise AssertionError(
            f"launches: flash_attention {n_attn} (want {layers * groups}), "
            f"flash_decode {n_decode} (want {layers * (GEN_NEW - 1) * groups}) "
            f"for {groups} groups")

    by_id = {r["id"]: r["gen"] for r in out}
    if len(out) != GEN_ROWS + 1 or by_id[-1] is not None:
        raise AssertionError("bad row did not come out None")
    toks = np.array([by_id[i] for i in range(GEN_ROWS)])
    if toks.shape != (GEN_ROWS, GEN_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids: bad shape or range {toks.shape}")

    gen_full = transformer(full)
    t0 = time.perf_counter()
    out_full = gen_full.transform(df).collect()
    torch.cuda.synchronize()
    secs_full = time.perf_counter() - t0
    want = {r["id"]: r["gen"] for r in out_full}
    same = sum(by_id[i] == want[i] for i in range(GEN_ROWS))
    if same != GEN_ROWS or want[-1] is not None:
        raise AssertionError(
            f"greedy tokens differ from attn_impl='full' in {GEN_ROWS - same} rows")

    # first-step logits of 4 left-padded rows, kernels vs dense, on the card
    mod, mod_full = _model(cfg, state, "cuda"), _model(full, state, "cuda")
    pick = [prompts[i] for i in (0, 1, 2, 3)]
    lp = max(map(len, pick))
    ids = torch.zeros((4, lp), dtype=torch.long)
    mask = torch.zeros((4, lp), dtype=torch.bool)
    for i, p in enumerate(pick):
        ids[i, lp - len(p):] = torch.tensor(p)
        mask[i, lp - len(p):] = True
    ids, mask = ids.cuda(), mask.cuda()
    positions = (mask.cumsum(1) - 1).clamp_min(0)
    logits = {}
    with torch.inference_mode():
        for name, m in (("flash", mod), ("full", mod_full)):
            cache = init_cache(m.config, 4, lp, device="cuda")
            logits[name] = m(ids, cache=cache, positions=positions,
                             attention_mask=mask)[0][:, -1]
    _, logit_rel = _rel_err(logits["flash"], logits["full"])
    if not torch.isfinite(logits["flash"]).all() or logit_rel > LOGIT_TOL:
        raise AssertionError(f"first-step logits vs full: rel err {logit_rel:.3e}")

    # where a group's time goes: one full group of the longest bucket
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (GEN_BATCH, GEN_LEN))).cuda()
    mask = torch.ones_like(ids, dtype=torch.bool)
    times = {}
    for name, m in (("flash", mod), ("full", mod_full)):
        prefill = _generate_ms(m, ids, mask, 1)
        whole = _generate_ms(m, ids, mask, GEN_NEW)
        times[name] = (prefill, (whole - prefill) / (GEN_NEW - 1),
                       *_device_split(m, ids, profile_steps=5 * (m is mod)))
    tokens_s = GEN_ROWS * GEN_NEW / secs
    print(f"[generate] DeepTextGenerator GPT-2 small ({layers}x{cfg.hidden_size}, "
          f"vocab {cfg.vocab_size}, learned positions, float32, random init seed 0 "
          f"in {init_s:.1f} s) over "
          f"{GEN_ROWS}+1 prompts of 8..{GEN_LEN} tokens in {N_PARTS} partitions, "
          f"batchSize {GEN_BATCH}, {GEN_NEW} new tokens greedy; {card}: "
          f"{tokens_s:.1f} tokens/s with the kernels, "
          f"{GEN_ROWS * GEN_NEW / secs_full:.1f} with attn_impl='full' (steady "
          f"state, host included); one group B={GEN_BATCH} L={GEN_LEN}, as "
          f"generate runs it (device alone, CUDA-graph replay): prefill "
          f"{times['flash'][0]:.2f} ms ({times['flash'][2]:.2f}), decode "
          f"{times['flash'][1]:.3f} ms/step ({times['flash'][3]:.3f}); full: "
          f"{times['full'][0]:.2f} ms ({times['full'][2]:.2f}), "
          f"{times['full'][1]:.3f} ms/step ({times['full'][3]:.3f}); "
          f"launches flash_attention {n_attn} = {layers} x {groups} groups, "
          f"flash_decode {n_decode} = {layers} x {GEN_NEW - 1} x {groups}; tokens "
          f"equal to 'full' in "
          f"{same}/{GEN_ROWS} rows; first-step logits rel err {logit_rel:.2e} "
          f"(tol {LOGIT_TOL}); bad row None")
    print(f"[generate] profile of a decode forward with the kernels, B={GEN_BATCH} "
          f"at position {GEN_LEN}: {times['flash'][4]}")
    attn_entry["launches"] = n_attn
    decode_entry["launches"] = n_decode
    return tokens_s


def _kernel_times(fn, reps: int = 10) -> dict:
    """Device time per call of ``fn`` by kernel name (torch.profiler, CUDA
    activity), over ``reps`` calls after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / reps / 1e3
    return by_name


def _one_ms(times: dict, needle: str) -> float:
    hits = [ms for name, ms in times.items() if needle in name]
    if len(hits) != 1:
        raise AssertionError(f"profiler: {len(hits)} kernels named *{needle}*: "
                             f"{sorted(times)[:12]}")
    return hits[0]


def _breakdown(times: dict, groups: dict, top: int = 4) -> str:
    """'total ms; group share, ...; top kernels' from _kernel_times."""
    total = sum(times.values())
    if not total:
        return "the profiler recorded no device time"
    shares = {g: sum(ms for n, ms in times.items() if any(k in n for k in keys))
              for g, keys in groups.items()}
    head = sorted(times.items(), key=lambda kv: -kv[1])[:top]
    return (f"device {total:.2f} ms in {len(times)} kernels; "
            + ", ".join(f"{g} {ms / total:.0%} ({ms:.2f} ms)" for g, ms in shares.items())
            + "; top: " + "; ".join(f"{n[:50]} {ms / total:.0%}" for n, ms in head))


def _right_padded_mask(rng, b: int, length: int, lo: int = 16):
    """bool [B, L] on the card: row i keeps its first lens[i] columns,
    lens random in lo..L (BERT's right-padded batches)."""
    import torch

    lens = torch.from_numpy(rng.integers(lo, length + 1, b))
    return (torch.arange(length)[None, :] < lens[:, None]).cuda()


def phase_flash_attention_bwd(card: str) -> tuple[dict, dict, dict]:
    """Both backward kernels against flash_attention_bwd_reference on the
    card, f32 and bf16, at the BERT-base fine-tune shape (right-padded key
    mask, one batch row with no valid key) and the GPT-2 prefill shape
    (causal, left-padded: its pad rows see no valid key); timed at the
    BERT shape in f32 against the bound, the plain backward and the
    backward of scaled_dot_product_attention. Returns the dq and dk/dv
    entries and the forward kernel's time at the BERT training shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from sparkdl_torch.ops.flash_attention import (
        _keep_mask,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    rng = np.random.default_rng(7)
    b, length = BERT_TRAIN_BATCH, BERT_TRAIN_LEN
    bert_mask = _right_padded_mask(rng, b, length)
    dead_mask = bert_mask.clone()
    dead_mask[-1] = False  # a batch row with no valid key at all
    cases = (("bert", b, length, False, dead_mask),
             ("gpt2_prefill", GEN_BATCH, GEN_LEN, True,
              _left_padded_mask(rng, GEN_BATCH, GEN_LEN)))
    report, errs = [], {}
    for name, bb, ll, causal, mask in cases:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (bb, ll, HEADS, HEAD_DIM), dtype=np.float32)).cuda() for _ in "qkvo")
        for dtype, tol in ((torch.float32, BWD_TOL), (torch.bfloat16, BWD_BF16_TOL)):
            qd, kd, vd, dod = (t.to(dtype) for t in (q, k, v, do))
            o, lse = flash_attention(qd, kd, vd, mask, causal=causal, return_lse=True)
            got = flash_attention_bwd(qd, kd, vd, mask, o, lse, dod, causal=causal)
            torch.cuda.synchronize()
            want = flash_attention_bwd_reference(qd, kd, vd, mask, o, lse, dod,
                                                 causal=causal)
            rels = []
            for g, w, n in zip(got, want, ("dq", "dk", "dv")):
                if g.shape != w.shape or not torch.isfinite(g.float()).all():
                    raise AssertionError(f"flash_attention_bwd {name} {dtype} {n}: bad output")
                abs_err, rel = _rel_err(g, w)
                if rel > tol:
                    raise AssertionError(f"flash_attention_bwd {name} {dtype} {n}: "
                                         f"rel err {rel:.3e} > {tol}")
                rels.append(rel)
                errs[name, dtype, n] = abs_err
            # through autograd: flash_attention's backward is the kernels
            qq, kk, vv = (t.detach().clone().requires_grad_() for t in (qd, kd, vd))
            flash_attention(qq, kk, vv, mask, causal=causal).backward(dod)
            for g, w in zip((qq.grad, kk.grad, vv.grad), got):
                if not torch.equal(g, w):
                    raise AssertionError(f"{name} {dtype}: autograd != flash_attention_bwd")
            dead = int((lse <= -1e29).sum())
            report.append(f"{name} {'f32' if dtype == torch.float32 else 'bf16'} "
                          f"dq/dk/dv {'/'.join(f'{r:.1e}' for r in rels)} "
                          f"({dead} rows without a valid key)")

    # timing: the BERT training shape, float32, every row with a valid key
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, length, HEADS, HEAD_DIM), dtype=np.float32)).cuda() for _ in "qkvo")
    o, lse = flash_attention(q, k, v, bert_mask, return_lse=True)
    times = _kernel_times(lambda: flash_attention_bwd(q, k, v, bert_mask, o, lse, do))
    dq_ms, dkv_ms = _one_ms(times, "flash_bwd_dq_kernel"), _one_ms(times, "flash_bwd_dkv_kernel")
    whole_ms = _device_ms(lambda: flash_attention_bwd(q, k, v, bert_mask, o, lse, do))
    plain_ms = _device_ms(lambda: flash_attention_bwd_reference(
        q, k, v, bert_mask, o, lse, do))
    fwd_ms = _device_ms(lambda: flash_attention(q, k, v, bert_mask))
    fwd_plain_ms = _device_ms(lambda: flash_attention_reference(q, k, v, bert_mask))
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    keep = _keep_mask(b, length, length, bert_mask, False, 0, q.device)
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
    dot = do.transpose(1, 2).contiguous()
    library_ms = sum(_kernel_times(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), dot, retain_graph=True)).values())
    fwd_library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), attn_mask=keep))
    prod = 2.0 * b * HEADS * length * length * HEAD_DIM  # one L x L x D product
    tensor = 4.0 * b * length * HEADS * HEAD_DIM
    rows = 2 * 4.0 * b * HEADS * length  # lse and delta
    dq_bound, dq_by = _bound(3 * prod, 4 * tensor + rows + tensor)
    dkv_bound, dkv_by = _bound(4 * prod, 4 * tensor + rows + 2 * tensor)
    fwd_bound, _ = _bound(2 * prod, 4 * tensor + b * length)
    print(f"[flash_attention_bwd] H={HEADS} D={HEAD_DIM}, tol f32 {BWD_TOL} bf16 "
          f"{BWD_BF16_TOL} x max|ref|; {card}: " + "; ".join(report)
          + f"; BERT B={b} L={length} f32 (device ms per call, profiler): dq kernel "
          f"{dq_ms:.4f} (bound {dq_bound:.4f}, {dq_by}), dk/dv kernel {dkv_ms:.4f} "
          f"(bound {dkv_bound:.4f}, {dkv_by}); the two kernels {dq_ms + dkv_ms:.4f} "
          f"= {(dq_ms + dkv_ms) / plain_ms:.2f}x the plain backward (dq, dk, dv "
          f"together); whole backward with delta "
          f"{whole_ms:.4f} (CUDA-graph replay), plain {plain_ms:.4f}, SDPA backward "
          f"{library_ms:.4f} (its kernels' device time, profiler); forward kernel at "
          f"this shape {fwd_ms:.4f}, plain {fwd_plain_ms:.4f}, SDPA {fwd_library_ms:.4f}, "
          f"bound {fwd_bound:.4f}")
    # plain_ms and library_ms time dq, dk and dv together (no plain or library
    # call computes one of them alone): hold them against pair_ms, not ms
    common = {"route": "cuda", "source": "sparkdl_torch/csrc/flash_attention_bwd.cu",
              "launches": None, "plain_ms": plain_ms, "library_ms": library_ms,
              "plain_and_library_cover": "dq+dk+dv", "pair_ms": dq_ms + dkv_ms}
    dq = {"name": "flash_attention_bwd_dq", **common,
          "replaces": "sparkdl_tpu/ops/flash_attention.py:189",
          "max_abs_err": errs["bert", torch.float32, "dq"], "ms": dq_ms,
          "bound_ms": dq_bound, "bound_by": dq_by}
    dkv = {"name": "flash_attention_bwd_dkv", **common,
           "replaces": "sparkdl_tpu/ops/flash_attention.py:223",
           "max_abs_err": max(errs["bert", torch.float32, "dk"],
                              errs["bert", torch.float32, "dv"]),
           "ms": dkv_ms, "bound_ms": dkv_bound, "bound_by": dkv_by}
    return dq, dkv, {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                     "library_ms": fwd_library_ms, "bound_ms": fwd_bound}


# (M, K, N, launches in one step) of the fused ResNet50 step at B=64, 224 px:
# per stage the closing 1x1s (K = filters, prev BN + ReLU fused) and the
# stride-1 opening 1x1s of blocks 2.. (K = 4 x filters, no prologue)
RESNET_GEMMS = (
    (64 * 56 * 56, 256, 64, 2, False),
    (64 * 28 * 28, 128, 512, 4, True), (64 * 28 * 28, 512, 128, 3, False),
    (64 * 14 * 14, 256, 1024, 6, True), (64 * 14 * 14, 1024, 256, 5, False),
    (64 * 7 * 7, 512, 2048, 3, True), (64 * 7 * 7, 2048, 512, 2, False),
)


def phase_fused_gemm_bn(card: str) -> dict:
    """The kernel against reference_conv1x1_bn_stats at the shapes the
    fused ResNet50 step launches (M = 64 x 56^2 .. 64 x 7^2; 64 x 7^2 is
    not a multiple of the 128-row tile), prev BN with ReLU on and off, f32
    and bf16, plus an odd M; timed in f32 against its bound, its plain
    version and the bare torch.matmul."""
    import numpy as np
    import torch

    from sparkdl_torch.ops.fused_gemm_bn import (
        conv1x1_bn_stats,
        gemm_bn_stats,
        gemm_bn_stats_reference,
        reference_conv1x1_bn_stats,
    )

    rng = np.random.default_rng(8)

    def make(m, k, n, prev):
        x = torch.from_numpy(rng.standard_normal((m // 49, 7, 7, k), dtype=np.float32)
                             if m % 49 == 0 else
                             rng.standard_normal((1, 1, m, k), dtype=np.float32)).cuda()
        w = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
            np.float32)).cuda().t()  # the module's [Cout, Cin] weight, transposed
        bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1).cuda()
        bn = None
        if prev:
            bn = tuple(torch.from_numpy(a.astype(np.float32)).cuda() for a in (
                rng.standard_normal(k) * 0.2, rng.random(k) + 0.5,
                rng.standard_normal(k) * 0.5 + 1.0, rng.standard_normal(k) * 0.1)) + (1.001e-5,)
        return x, w, bias, bn

    checks = [(m, k, n, prev, prev) for m, k, n, _, prev in RESNET_GEMMS]
    checks += [(64 * 28 * 28, 128, 512, True, False), (1000, 256, 64, True, True)]
    worst, report = {}, []
    for m, k, n, prev, relu in checks:
        x, w, bias, bn = make(m, k, n, prev)
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd = x.to(dtype), w.to(dtype)
            got = conv1x1_bn_stats(xd, wd, bias, prev_bn=bn, relu_in=relu)
            torch.cuda.synchronize()
            want = reference_conv1x1_bn_stats(xd, wd, bias, prev_bn=bn, relu_in=relu)
            tols = ((GEMM_TOL, STATS_TOL, STATS_TOL) if dtype == torch.float32
                    else (GEMM_BF16_TOL,) * 3)
            for g, r, tol, what in zip(got, want, tols, ("y", "mean", "var")):
                if g.shape != r.shape or not torch.isfinite(g.float()).all():
                    raise AssertionError(f"fused_gemm_bn {m}x{k}->{n} {dtype} {what}: bad")
                abs_err, rel = _rel_err(g, r)
                if rel > tol:
                    raise AssertionError(f"fused_gemm_bn {m}x{k}->{n} prev {prev} relu "
                                         f"{relu} {dtype} {what}: rel err {rel:.3e} > {tol}")
                key = ("f32" if dtype == torch.float32 else "bf16", what)
                worst[key] = max(worst.get(key, (0.0, 0.0)), (rel, abs_err))

    ms = plain_ms = bound_ms = ops_ms = bytes_ms = 0.0
    for m, k, n, count, prev in RESNET_GEMMS:
        x, w, bias, bn = make(m, k, n, prev)
        x2 = x.reshape(m, k)
        sc = sh = None
        if bn:
            sc = (bn[2] * torch.rsqrt(bn[1] + bn[4])).contiguous()
            sh = (bn[3] - bn[0] * sc).contiguous()
        t_k = _device_ms(lambda: gemm_bn_stats(x2, w, sc, sh, bias, relu_in=prev))
        t_p = _device_ms(lambda: gemm_bn_stats_reference(x2, w, sc, sh, bias,
                                                         relu_in=prev))
        t_mm = _device_ms(lambda: x2 @ w)
        nbytes = 4.0 * (m * k + k * n + m * n + 2 * n + (2 * k if prev else 0))
        b_ms, b_by = _bound(2.0 * m * k * n, nbytes)
        ms, plain_ms, bound_ms = ms + count * t_k, plain_ms + count * t_p, bound_ms + count * b_ms
        ops_ms += count * (2.0 * m * k * n / H100_F32_FLOPS * 1e3)
        bytes_ms += count * (nbytes / H100_BYTES_S * 1e3)
        report.append(f"{m}x{k}->{n} x{count}: kernel {t_k:.4f}, plain {t_p:.4f}, "
                      f"matmul {t_mm:.4f}, bound {b_ms:.4f} ({b_by})")
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[fused_gemm_bn] tol f32 y {GEMM_TOL}, mean/var {STATS_TOL}, bf16 "
          f"{GEMM_BF16_TOL} x max|ref|; worst rel err " + ", ".join(
              f"{d} {w} {e[0]:.1e}" for (d, w), e in sorted(worst.items()))
          + f" over {len(checks)} shapes (prev BN + ReLU on/off, M 1000 and "
          f"3136 not tile multiples); {card}; f32 device ms per call (CUDA-graph "
          f"replay): " + "; ".join(report)
          + f"; one step's 25 launches: kernel {ms:.3f} ms, plain {plain_ms:.3f}, "
          f"bound {bound_ms:.3f}; library_ms null: no single PyTorch call computes "
          "the GEMM with the BN stats (torch.matmul above is for information)")
    return {"name": "gemm_bn_stats", "route": "cuda",
            "source": "sparkdl_torch/csrc/fused_gemm_bn.cu",
            "replaces": "sparkdl_tpu/ops/fused_gemm_bn.py:67", "launches": None,
            "max_abs_err": worst["f32", "y"][1], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_train_bert(card: str, dq_entry: dict, dkv_entry: dict, fwd: dict) -> float:
    """finetune_classifier over BERT-base at full width through the flash
    kernels, against the same weights and batches with attn_impl="full"."""
    import dataclasses

    import numpy as np
    import torch

    from sparkdl_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
        init_bert_,
    )
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from sparkdl_torch.train import finetune_classifier
    from sparkdl_torch.train.finetune import classification_train_step

    cfg = BertConfig.base(attn_impl="flash")
    t0 = time.perf_counter()
    state = init_bert_(BertForSequenceClassification(cfg, num_labels=2, device="cpu"),
                       seed=0).state_dict()
    init_s = time.perf_counter() - t0

    def model(attn_impl):
        m = BertForSequenceClassification(dataclasses.replace(cfg, attn_impl=attn_impl),
                                          num_labels=2, device="cuda")
        m.load_state_dict(state)
        return m

    rng = np.random.default_rng(9)
    b, length = BERT_TRAIN_BATCH, BERT_TRAIN_LEN
    batches = []
    for _ in range(BERT_STEPS):
        mask = _right_padded_mask(rng, b, length).cpu().numpy()
        batches.append({
            "input_ids": rng.integers(0, cfg.vocab_size, (b, length)) * mask,
            "attention_mask": mask, "labels": rng.integers(0, 2, b)})

    # first-step loss and gradients, flash against full
    grads, first = {}, {}
    for impl in ("flash", "full"):
        m = model(impl)
        batch = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
        logits = m(batch["input_ids"], batch["attention_mask"])
        loss = torch.nn.functional.cross_entropy(logits, batch["labels"])
        loss.backward()
        first[impl] = float(loss.detach())
        grads[impl] = {n: p.grad for n, p in m.named_parameters()}
        del m, logits, loss
    loss_rel = abs(first["flash"] - first["full"]) / abs(first["full"])
    floor = 1e-3 * max(float(g.abs().max()) for g in grads["full"].values())
    grad_rel = max(float((grads["flash"][n] - g).abs().max())
                   / max(float(g.abs().max()), floor) for n, g in grads["full"].items())
    if not np.isfinite(first["flash"]) or loss_rel > 1e-5 or grad_rel > 1e-4:
        raise AssertionError(f"BERT first step vs full: loss rel {loss_rel:.3e} "
                             f"(tol 1e-5), worst gradient rel {grad_rel:.3e} (tol 1e-4)")
    del grads

    flash_model, full_model = model("flash"), model("full")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    _, history = finetune_classifier(flash_model, batches, learning_rate=2e-5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = (flash_attention.launches, flash_attention_bwd.launches_dq,
              flash_attention_bwd.launches_dkv)
    want = cfg.num_hidden_layers * BERT_STEPS
    if counts != (want, want, want):
        raise AssertionError(f"BERT launches forward/dq/dkv {counts}, want {want} each "
                             f"({cfg.num_hidden_layers} a step)")
    _, history_full = finetune_classifier(full_model, batches, learning_rate=2e-5)
    losses = np.array([h["loss"] for h in history])
    want_losses = np.array([h["loss"] for h in history_full])
    hist_rel = float(np.abs(losses - want_losses).max() / np.abs(want_losses).max())
    if not np.isfinite(losses).all() or hist_rel > 1e-3:
        raise AssertionError(f"BERT loss history vs full: rel {hist_rel:.3e} (tol 1e-3)")

    step_ms = float(np.median([h["step_time_s"] for h in history[1:]])) * 1e3
    full_ms = float(np.median([h["step_time_s"] for h in history_full[1:]])) * 1e3
    step = classification_train_step(flash_model, torch.optim.AdamW(
        flash_model.parameters(), lr=2e-5, eps=1e-8))
    batch = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
    times = _kernel_times(lambda: step(batch), reps=1)
    prof_line = _breakdown(times, {
        "flash fwd": ("flash_fwd_kernel",), "flash bwd": ("flash_bwd_",),
        "GEMMs": ("gemm", "sgemm", "cutlass", "Kernel2")})
    print(f"[train_bert] finetune_classifier BERT-base ({cfg.num_hidden_layers}x"
          f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, MLP "
          f"{cfg.intermediate_size}, vocab {cfg.vocab_size}), float32, random init seed "
          f"0 in {init_s:.1f} s, 2 labels, attn_impl='flash', AdamW 2e-5; "
          f"{BERT_STEPS} batches of B={b} L={length}, right-padded lengths 16..{length}; "
          f"{card}: {BERT_STEPS * b / secs:.1f} examples/s over the run, step "
          f"{step_ms:.2f} ms (median, host-driven; 'full' {full_ms:.2f} ms); launches "
          f"forward/dq/dkv {counts[0]}/{counts[1]}/{counts[2]} = "
          f"{cfg.num_hidden_layers} a step x {BERT_STEPS}; vs attn_impl='full': "
          f"first-step loss rel {loss_rel:.1e} (tol 1e-5), worst gradient rel "
          f"{grad_rel:.1e} (tol 1e-4, scale floored at 1e-3 of the largest), loss "
          f"history rel {hist_rel:.1e} (tol 1e-3); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"[train_bert] profile of one step with the kernels: {prof_line}")
    dq_entry["launches"], dkv_entry["launches"] = counts[1], counts[2]
    fwd["bert_launches"] = counts[0]
    return BERT_STEPS * b / secs


def phase_train_resnet(card: str, gemm_entry: dict) -> float:
    """The fused ResNet50 train step (bench_train.py's recipe) at 224 px,
    batch 64, against make_vision_train_step over the plain module."""
    import copy

    import numpy as np
    import torch

    from sparkdl_torch.models.common import init_zoo_
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.ops.fused_gemm_bn import gemm_bn_stats
    from sparkdl_torch.train.vision import (
        make_resnet50_fused_train_step,
        make_vision_train_step,
    )

    base = init_zoo_(ResNet50(num_classes=1000), seed=0)  # built on the card
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.random((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                                    dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).cuda()

    def fresh(fused):
        m = copy.deepcopy(base)
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        step = (make_resnet50_fused_train_step(m, opt, num_classes=1000,
                                               dtype=torch.float32)
                if fused else make_vision_train_step(m, opt))
        return m, step

    # fused against plain from the same start: losses, stats after step 1
    runs = {}
    for fused in (True, False):
        m, step = fresh(fused)
        losses = [float(step(x, y))]
        stats = {n: (b.running_mean.clone(), b.running_var.clone())
                 for n, b in m.named_modules() if isinstance(b, torch.nn.BatchNorm2d)}
        losses += [float(step(x, y)) for _ in range(2)]
        runs[fused] = (losses, stats)
    (lf, sf), (lp, sp) = runs[True], runs[False]
    loss_rel = abs(lf[0] - lp[0]) / abs(lp[0])
    stat_err = max(float(((a - b).abs() - 1e-3 * b.abs()).max())
                   for n in sp for a, b in zip(sf[n], sp[n]))
    track = max(abs(f - p) / abs(p) for f, p in zip(lf, lp))
    if not np.isfinite(lf).all() or loss_rel > 1e-3 or stat_err > 1e-4 or track > 0.15:
        raise AssertionError(
            f"fused vs plain ResNet50 step: first loss rel {loss_rel:.3e} (tol 1e-3), "
            f"stats |a-b| - 1e-3|b| {stat_err:.3e} (tol 1e-4), losses {lf} vs {lp}")

    module, step = fresh(True)
    step(x, y)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = gemm_bn_stats.launches
    if launches != 25 * RESNET_STEPS:
        raise AssertionError(f"gemm_bn_stats launched {launches} times in "
                             f"{RESNET_STEPS} steps, want 25 a step")
    losses = [float(t) for t in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"ResNet50 losses not finite: {losses}")
    plain_module, plain_step = fresh(False)
    plain_step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        plain_step(x, y)
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0

    groups = {"fused 1x1 kernel": ("gemm_bn_kernel", "stats_reduce_kernel"),
              "cuDNN convs": ("cudnn", "conv", "implicit", "wgrad", "dgrad", "xmma",
                              "sm90", "sm80")}
    lines = []
    for name, fn in (("fused", lambda: step(x, y)), ("plain", lambda: plain_step(x, y))):
        lines.append(f"{name}: {_breakdown(_kernel_times(fn, reps=1), groups)}")
    print(f"[train_resnet] make_resnet50_fused_train_step ResNet50 {RESNET_SIZE} px, "
          f"B={RESNET_BATCH}, 1000 classes, float32, SGD 0.1 momentum 0.9, random init "
          f"seed 0; {card}: {RESNET_BATCH * RESNET_STEPS / secs:.1f} images/s, step "
          f"{secs / RESNET_STEPS * 1e3:.2f} ms over {RESNET_STEPS} steps after a warm-up "
          f"(plain step {plain_secs / RESNET_STEPS * 1e3:.2f} ms, "
          f"{RESNET_BATCH * RESNET_STEPS / plain_secs:.1f} images/s); gemm_bn_stats "
          f"launches {launches} = 25 x {RESNET_STEPS}; vs the plain step: first loss "
          f"rel {loss_rel:.1e} (tol 1e-3), BN stats after step 1 within atol 1e-4 + "
          f"rtol 1e-3 (worst excess {stat_err:.1e}), 3 losses {', '.join(f'{v:.4f}' for v in lf)} "
          f"vs {', '.join(f'{v:.4f}' for v in lp)} (worst {track:.1%}, tol 15%); "
          f"losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    print("[train_resnet] profile of one step: " + " | ".join(lines))
    gemm_entry["launches"] = launches
    return RESNET_BATCH * RESNET_STEPS / secs


def main() -> int:
    import torch

    card = phase_card()
    import sparkdl_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_build()
    stem = phase_stem()
    attn = phase_flash_attention(card)
    decode = phase_flash_decode(card)
    dq, dkv, bert_fwd = phase_flash_attention_bwd(card)
    gemm = phase_fused_gemm_bn(card)
    images_s = phase_main_path(stem)
    tokens_s = phase_generate(card, attn, decode)
    examples_s = phase_train_bert(card, dq, dkv, bert_fwd)
    train_images_s = phase_train_resnet(card, gemm)
    kernels = [stem, attn, dq, dkv, decode, gemm]
    print(f"[summary] {card}: featurizer {images_s:.1f} images/s; generator "
          f"{tokens_s:.1f} tokens/s; BERT-base fine-tune {examples_s:.1f} examples/s; "
          f"ResNet50 training {train_images_s:.1f} images/s; flash_attention at the "
          f"BERT training shape {bert_fwd['ms']:.4f} ms (plain {bert_fwd['plain_ms']:.4f}, "
          f"SDPA {bert_fwd['library_ms']:.4f}, bound {bert_fwd['bound_ms']:.4f}), "
          f"{bert_fwd['bert_launches']} launches in [train_bert]; kernel ms vs bound ms: "
          + ", ".join(f"{k['name']} {k['ms']:.4f} vs {k['bound_ms']:.4f}" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
