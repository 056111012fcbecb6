#!/usr/bin/env python3
"""Smoke run of sparkdl_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``sparkdl_torch/csrc/`` (into
``sparkdl_torch/_build/``), holds each kernel against its plain PyTorch
version at the shapes of the paths that run it, then drives the port's
paths, each on random weights from a fixed seed, and checks that each
went through its kernels and agrees with a kernel-free run:

- ``DeepImageFeaturizer(modelName="InceptionV3")`` over a LocalDataFrame
  of 256 random 299x299 images (the stem kernel);
- ``DeepTextGenerator`` at GPT-2-small width over 64 random prompts
  (the flash attention and flash decode kernels), each bucket's whole
  ``generate`` one CUDA graph;
- ``finetune_classifier`` over BERT-base, 20 batches of 32 x 128 tokens
  (the flash attention forward and its two backward kernels), one CUDA
  graph a step and, with ``chain_steps=4``, one of four steps;
- the same BERT-base fine-tune through ``TorchRunner(np=-1)`` (one NCCL
  worker process) and ``resumable_finetune`` under a ZeRO
  ``DataParallelPartitioner``, checkpointed every 4 steps, recovering
  from an injected fault bitwise;
- model parallelism (``parallel/``): a mixture-of-experts GPT-2 small
  (6 MoE layers of 8 experts) generating through the flash forward and
  flash decode, one CUDA graph a generate; the ring's fold at L=4096;
  ``sp_prefill`` over a one-rank NCCL group (``TorchRunner(np=-1)``),
  each held to the dense path (and, with two or more cards,
  ``tools/parallel4_probe.py``'s multi-rank checks);
- data-parallel inference in one process: the featurizer with
  ``data_parallel=None`` (the stem kernel), a runner over two replicas
  on the one card and ``DeepTextGenerator`` over the same two placements
  (the flash forward and decode), each held to the one-card run (and,
  with two or more cards, the same over the cards);
- the fused ResNet50 train step at 224 px, batch 64 (the fused 1x1-conv
  GEMM + BN-stats kernel and the BatchNorm kernels of ``ops/bn_train.py``,
  each of those held to its plain version at every BatchNorm launch of
  the step first), one CUDA graph a step;
- ``DeepImageFeaturizer``/``DeepImagePredictor`` over ResNet50, Xception,
  VGG16, VGG19 and ViT-B/16 (cuDNN/cuBLAS: no kernel of the port), each
  held against the same module on the CPU;
- ViT-B/16 with ``attn_impl="flash"`` (the flash attention forward at
  L=197) against ``"full"``;
- ``DeepTextFeaturizer`` over BERT-base (the flash attention forward with
  a key mask, under no grad, inside the runner's CUDA graphs) against
  ``attn_impl="full"``, every pooling;
- ``hpo.fmin`` over two BERT-base fine-tuning trials (the flash forward
  and backward kernels);
- the serving core: ``ContinuousGPTEngine`` at GPT-2-small width (no
  kernel: the per-slot steps are the dense masked path) and
  ``ServingEngine`` over the InceptionV3 featurizer's runner (the stem
  kernel), then the same traffic over a ``ReplicaPool`` of two such
  runners on the one card, with injected executor failures;
- TF-graph ingestion's run half with no TF: ResNet50's frozen tf.keras
  graph, written in code, through ``TFImageTransformer`` (held to the
  Keras graph module over the same weights), an MLP graph through
  ``TFTransformer`` and an If/While graph (cuDNN/cuBLAS: no kernel of
  the port);
- tiered KV: three-turn sessions parked to host and disk between turns,
  exported to and imported by a second engine, held bitwise to an engine
  that never parks, for float32, bfloat16 and int8 pools;
- the continuous engine's sequence-parallel prefill: ``sp=2`` (both
  shards on the one card; the cards in ``tools/parallel4_probe.py``)
  against ``sp=1`` over two bursts of eight 512..960-token prompts, with
  injected ``sp.permute``/``sp.gather`` faults (no kernel: the chunks are
  the dense masked path);
- the serving fabric: a ``Router`` over two in-process hosts on the card
  (continuous engines at GPT-2-small width), held bitwise to one engine,
  with affinity, injected ``host.submit`` faults, a ``drain_host``
  mid-burst and a ``HostServer`` answered over localhost HTTP;
- disaggregated prefill/decode: ``PrefillWorker`` -> ``KVHandoff`` ->
  ``DecodeWorker`` through a ``PhaseRouter``, held bitwise to the
  colocated engine for float32 and int8 pools in plain, chained and
  speculative decode, with injected handoff faults (no kernel in either:
  the dense masked path);
- the fleet's autoscaler: a started ``AutoScaler`` over a ``ReplicaPool``
  of featurizer runners (one scale-up warmed over every bucket, one
  drain-safe scale-down, answers bitwise the featurizer's), over a
  continuous engine's KV pool, over the fabric's hosts and the split
  tiers' (``tier_autoscalers``), each with a counted fault; then the
  fleet scraper's stitched trace of a split request, in process and over
  ``FleetServer``;
- ``observability.profiling.trace`` around one featurizer batch.

The graphed paths are held bitwise to their eager form (the training
ones under deterministic algorithms). Each phase prints its lines; any
failure, a failed capture included, raises and exits non-zero. The
last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

H100_F32_FLOPS = 67e12    # FP32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 tensor cores
H100_BYTES_S = 3.35e12    # HBM3

BATCH, SIZE = 64, 299
N_ROWS, N_PARTS = 256, 4
STEM_TOL = 1e-5   # f32 kernel vs f32 plain: only the summation order differs
STEM_BF16_TOL = 2.0 ** -7  # both sides round to bf16: one bf16 step apart at most
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
BN_TOL, BN_BWD_TOL = 1e-5, 1e-4  # bn_train's kernels vs plain, x max|ref|
BN_BF16_STEP = 2.0 ** -8  # a bf16 gradient: one rounding of the f32 value
BN_EPS = 1.001e-5  # ResNet50's
BERT_STEPS, BERT_TRAIN_BATCH, BERT_TRAIN_LEN = 20, 32, 128
RESNET_BATCH, RESNET_SIZE, RESNET_STEPS = 64, 224, 10


def _zero_counts():
    """Set every kernel wrapper's launch count to 0."""
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from sparkdl_torch.ops.flash_decode import flash_decode
    from sparkdl_torch.ops.bn_train import batch_moments, bn_train_apply, bn_train_backward
    from sparkdl_torch.ops.fused_gemm_bn import gemm_bn_stats
    from sparkdl_torch.ops.stem_fused import inception_stem_fused

    for fn in (inception_stem_fused, flash_attention, flash_decode, gemm_bn_stats,
               batch_moments, bn_train_apply, bn_train_backward):
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


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms for a bitwise comparison of two
    runs (cuDNN's and the embedding's default backward sum with atomics,
    in an order that changes from run to run); ops without a deterministic
    version warn. The cuBLAS workspace is fixed in main()."""
    import torch
    import torch.utils.deterministic as det

    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
        det.fill_uninitialized_memory = saved[3]


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


STEM_EDGE_SIZES = (11, 59, 75, 150, 299)  # ragged tiles: Rp 1, 13, 17, 35, 73
STEM_EDGE_BATCHES = (1, 3, 64)


def _stem_builds() -> str:
    """The stem kernel's builds (_builds): u8/f32 pixels x f32/bf16 out."""
    return _builds("stem_fused", "stem_fused_attrs", [
        (f"{tin}->{tout}", [(f"stem_fused_kernelI{min_}{mout}E", (u8, bf16))])
        for u8, tin, min_ in ((1, "u8", "h"), (0, "f32", "f"))
        for bf16, tout, mout in ((0, "f32", "f"), (1, "bf16", "13__nv_bfloat16"))])


def _stem_check(x_u8, folded, errs) -> None:
    """The kernel against stem_reference on one batch: f32 and u8 pixels to
    f32 features within STEM_TOL, u8 and f32 pixels to bf16 (the featurizer
    feeds u8, the bf16 zoo f32) within 2^-7 (both sides round to bf16: one
    bf16 step apart at most), each the same bits on a second call. Records
    the worst relative error per label in ``errs``."""
    import torch

    from sparkdl_torch.ops.stem_fused import inception_stem_fused, stem_reference

    b, s = x_u8.shape[0], x_u8.shape[1]
    x_f32 = x_u8.float()
    want = stem_reference(x_f32, folded)
    for label, x, dtype, tol in (("f32->f32", x_f32, torch.float32, STEM_TOL),
                                 ("u8->f32", x_u8, torch.float32, STEM_TOL),
                                 ("u8->bf16", x_u8, torch.bfloat16, STEM_BF16_TOL),
                                 ("f32->bf16", x_f32, torch.bfloat16, STEM_BF16_TOL)):
        got = inception_stem_fused(x, folded, dtype=dtype)
        again = inception_stem_fused(x, folded, dtype=dtype)
        torch.cuda.synchronize()
        ref = want if dtype == torch.float32 else want.to(dtype)
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"stem {label} B={b} S={s}: bad output {tuple(got.shape)}")
        if not torch.equal(got, again):
            raise AssertionError(f"stem {label} B={b} S={s}: two calls differ")
        err = _rel_err(got, ref)
        if err[1] > tol:
            raise AssertionError(f"stem {label} B={b} S={s}: rel err {err[1]:.3e} > {tol}")
        if err[1] >= errs.get(label, (0.0, -1.0))[1]:
            errs[label] = err


def phase_stem():
    """The stem kernel's builds (_stem_builds), then the kernel against
    stem_reference at every S of STEM_EDGE_SIZES and B of STEM_EDGE_BATCHES
    (_stem_check), then timed at B=64, S=299 against its plain version and
    its bound (3xTF32 on the tensor cores, the CUDA-core f32 bound beside
    it)."""
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

    print(f"[stem] builds: {_stem_builds()}")
    model = build_torch_model("InceptionV3", "random", include_top=False,
                              device="cuda", seed=0)
    folded = fold_stem_params(fold_tf_preprocess(model.state_dict()))
    rng = np.random.default_rng(1)
    edge_errs = {}
    for s in STEM_EDGE_SIZES:
        for b in STEM_EDGE_BATCHES:
            if (b, s) == (BATCH, SIZE):
                continue
            x = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)).cuda()
            _stem_check(x, folded, edge_errs)
    print(f"[stem] S {'/'.join(map(str, STEM_EDGE_SIZES))} x B "
          f"{'/'.join(map(str, STEM_EDGE_BATCHES))}: worst rel err "
          + ", ".join(f"{k} {v[1]:.2e}" for k, v in edge_errs.items())
          + f" (tol {STEM_TOL}, bf16 {STEM_BF16_TOL}); every result the same bits on a "
          "second call")
    x_u8 = torch.from_numpy(
        rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)).cuda()
    x_f32 = x_u8.float()
    errs = {}
    _stem_check(x_u8, folded, errs)

    ms = _time_ms(lambda: inception_stem_fused(x_f32, folded, dtype=torch.float32))
    plain_ms = _time_ms(lambda: stem_reference(x_f32, folded))
    h1 = (SIZE - 3) // 2 + 1
    h2 = h1 - 2
    macs = BATCH * (h1 * h1 * 27 * 32 + h2 * h2 * 288 * 32 + h2 * h2 * 288 * 64)
    rp = stem_out_size(SIZE)
    nbytes = (x_f32.numel() * 4 + sum(p.numel() * 4 for p in folded.values())
              + BATCH * rp * rp * 64 * 4)
    # on the tensor cores as 3xTF32: three TF32 passes a product
    bound_ms, bound_by = _bound(3 * 2 * macs, nbytes, H100_TF32_FLOPS)
    core_ms = _bound(2 * macs, nbytes)[0]
    print("[stem] B=%d S=%d: rel err %s (tol %g); kernel %.3f ms, plain %.3f ms, "
          "bound %.3f ms (%s: %.2f GFLOP as 3xTF32 at 495 TFLOP/s; %.1f MB at "
          "3.35 TB/s = %.3f ms; CUDA-core f32 bound %.3f ms at 67 TFLOP/s); "
          "library_ms null: no single PyTorch call computes the stem" % (
              BATCH, SIZE, ", ".join(f"{k} {v[1]:.2e}" for k, v in errs.items()),
              STEM_TOL, ms, plain_ms, bound_ms, bound_by, 2 * macs / 1e9,
              nbytes / 1e6, nbytes / H100_BYTES_S * 1e3, core_ms))
    return {
        "name": "inception_stem_fused", "route": "cuda",
        "source": "sparkdl_torch/csrc/stem_fused.cu",
        "replaces": "sparkdl_tpu/ops/stem_fused.py:242",
        "launches": None, "max_abs_err": errs["f32->f32"][0], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "cuda_core_bound_ms": core_ms,
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


@contextlib.contextmanager
def _runner_settings(**settings):
    """Inside the block the featurizer's runners carry ``settings``
    (BatchedRunner fields: prefetch, chain_k, async_fetch): one runner
    per cached runner and settings, so graphs and rings are reused
    across the block's transforms as a user's would be."""
    import dataclasses

    from sparkdl_torch.transformers import named_image

    orig = named_image._named_model_runner
    made = {}

    def runner(*key):
        if key not in made:
            made[key] = dataclasses.replace(orig(*key), **settings)
        return made[key]

    named_image._named_model_runner = runner
    try:
        yield made
    finally:
        named_image._named_model_runner = orig


SERIAL = dict(prefetch=0, chain_k=1, async_fetch=False)
SPLIT_SPANS = (("extract", "partition.extract"), ("pack", "batch.pack"),
               ("slot copy", "ring.copy"), ("H2D", "batch.h2d"), ("enqueue", "dispatch.chain"),
               ("D2H", "batch.d2h"), ("fetch wait", "fetch.wait"),
               ("unpad", "batch.unpad"))
TIME_REPS = 5
CHAIN_BATCH, CHAIN_K = 16, 4  # the forced chain: four batches of 16 a replay


def _host_split(featurizer, df, n_batches: int, runners) -> str:
    """One transform with tracing on: host ms per batch in each span of
    the feed (extract and pack on the host; slot copy the ring's copy of
    a packed batch into its slot; H2D the put, its copy waited for; enqueue the dispatch's launches; D2H the blocking readback, which
    waits for the device; fetch wait the async readback's; unpad), and
    the device ms per batch from the chainer's CUDA events. ``runners()``
    gives the runners the transform used."""
    import torch

    from sparkdl_torch.observability import tracing
    from sparkdl_torch.observability.registry import registry

    def device_s():
        for r in runners():
            r._chainer._harvest()  # fold in the last dispatches' events
        fam = registry().get("sparkdl_dispatch_seconds")
        v = fam.snapshot_values().get('path="batch"') if fam else None
        return (v["sum"], v["count"]) if v else (0.0, 0)

    tracing.clear_trace()
    tracing.enable_tracing()
    before = device_s()
    try:
        t0 = time.perf_counter()
        featurizer.transform(df).collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tracing.disable_tracing()
    after = device_s()
    dev_ms = (after[0] - before[0]) / max(after[1] - before[1], 1) * 1e3
    totals = {}
    for ev in tracing.trace_events():
        totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"] / 1e3
    parts = [f"{label} {totals[name] / n_batches:.2f}"
             for label, name in SPLIT_SPANS if name in totals]
    return (f"{wall / n_batches * 1e3:.1f} ms a batch of {n_batches}: "
            + ", ".join(parts) + f"; device (CUDA events) {dev_ms:.2f}")


def phase_main_path(stem_entry: dict, card: str):
    import numpy as np
    import torch

    from sparkdl_torch import (
        DeepImageFeaturizer,
        LocalDataFrame,
        readImages,
        readImagesWithCustomFn,
    )
    from sparkdl_torch.image import (
        PIL_decode_bytes,
        imageArrayToStructBGR,
        undefined_image,
    )
    from sparkdl_torch.models.inception_fused import (
        fused_inception_v3_features,
        prepare_fused_inception_v3,
    )
    from sparkdl_torch.native import _lib
    from sparkdl_torch.native.bridge import FEED_STATS
    from sparkdl_torch.ops.fold import fold_tf_preprocess
    from sparkdl_torch.ops.stem_fused import inception_stem_fused, stem_reference
    from sparkdl_torch.transformers.named_image import _load_named_model

    # the host libraries: the staging ring must build, the decoder may not
    # (libjpeg/libpng headers); each built from csrc/ into _build/
    if not _lib.available():
        raise AssertionError(f"sdl_bridge did not build: {_lib.BRIDGE.build_error}")
    decoder = _lib.decode_available()
    print(f"[feed] sdl_bridge built ({os.path.basename(_lib.BRIDGE.path())}); "
          f"sdl_decode {'built' if decoder else 'NOT built: ' + str(_lib.DECODE.build_error)[:300]}")

    rng = np.random.default_rng(2)
    featurizer = DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="InceptionV3",
        weights="random", batchSize=BATCH)

    # files -> readImagesWithCustomFn -> featurizer: the corrupt file is an
    # undefined row and comes out None
    with tempfile.TemporaryDirectory() as root:
        n_png = _png_dir(root, rng)
        files = readImagesWithCustomFn(root, PIL_decode_bytes, numPartition=2)
        native_files = readImages(root, numPartition=2)
        rows = featurizer.transform(files).collect()
    if decoder:
        pil = files.collect()
        nat = native_files.collect()
        if pil != nat:
            raise AssertionError("readImages (native decoder) structs differ from PIL's")
        print(f"[feed] readImages through sdl_decode: {len(nat)} structs bitwise "
              "equal to PIL's (corrupt file undefined in both)")
    else:
        print("[feed] sdl_decode not built: readImages defers to PIL (no native "
              "decode checked in this run)")
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
    df1 = LocalDataFrame.from_rows(rows_in, 1)

    def batches(frame, batch):
        return sum(r["n"] for r in frame.mapPartitions(
            lambda part: [{"n": math.ceil(sum(r["id"] >= 0 for r in part) / batch)}]
        ).collect())

    def features(out):
        by_id = {r["id"]: r["features"] for r in out}
        if len(out) != N_ROWS + 1 or by_id[-1] is not None:
            raise AssertionError("undefined row did not come out None")
        feats = np.stack([by_id[i] for i in range(N_ROWS)])
        if feats.shape != (N_ROWS, 2048) or not np.isfinite(feats).all():
            raise AssertionError(f"features: bad shape or values {feats.shape}")
        return feats

    def counted(f, frame):
        """One transform with every launch count at 0 before it: features,
        seconds, stem launches, ring batches."""
        torch.cuda.synchronize()
        _zero_counts()
        ring0 = FEED_STATS["ring_batches"]
        t0 = time.perf_counter()
        out = f.transform(frame).collect()
        torch.cuda.synchronize()
        return (features(out), time.perf_counter() - t0,
                inception_stem_fused.launches, FEED_STATS["ring_batches"] - ring0)

    n_batches = batches(df, BATCH)
    featurizer.transform(df).collect()  # warm-up: model, graphs, cuDNN plans
    # the main path: the default runner (ring, async fetch, auto chain,
    # CUDA graphs), every launch count at 0 just before it
    feats, secs, launches, ring_batches = counted(featurizer, df)
    if launches != n_batches:
        raise AssertionError(
            f"stem kernel launched {launches} times for {n_batches} batches")
    if ring_batches != n_batches:
        raise AssertionError(
            f"the staging ring carried {ring_batches} of {n_batches} batches")
    from sparkdl_torch.transformers.named_image import _named_model_runner

    runner = _named_model_runner("InceptionV3", "random", False, "features", BATCH, "cuda")
    chainer = runner._chainer
    graphs = sorted((dict(k[0][1])["img"][0][0], k[1]) for k in chainer.graph_keys)

    # bitwise: the serial runner (no staging ahead, eager steps, blocking
    # readback) gives the same bits
    with _runner_settings(**SERIAL):
        featurizer.transform(df).collect()  # warm-up
        serial, serial_secs, serial_launches, _ = counted(featurizer, df)
    if serial_launches != n_batches:
        raise AssertionError(f"serial: {serial_launches} stem launches for {n_batches}")
    if not np.array_equal(feats, serial):
        raise AssertionError(
            "pipelined features differ from the serial runner's: max abs diff "
            f"{np.abs(feats - serial).max():.3e}")

    # a forced chain: chain_k=4 at batch 16 (four batches a graph replay)
    small = DeepImageFeaturizer(
        inputCol="image", outputCol="features", modelName="InceptionV3",
        weights="random", batchSize=CHAIN_BATCH)
    n16 = batches(df, CHAIN_BATCH)
    with _runner_settings(chain_k=CHAIN_K) as made:
        small.transform(df).collect()  # warm-up: captures the K=4 graph
        chained, _, chained_launches, _ = counted(small, df)
        chain_graphs = sorted((dict(k[0][1])["img"][0][0], k[1])
                              for r in made.values() for k in r._chainer.graph_keys)
    with _runner_settings(chain_k=1):
        unchained, _, _, _ = counted(small, df)
    if chained_launches != n16:
        raise AssertionError(
            f"chain_k={CHAIN_K}: {chained_launches} stem launches for {n16} batches")
    if not np.array_equal(chained, unchained):
        raise AssertionError(
            f"chain_k={CHAIN_K} features differ from chain_k=1: max abs diff "
            f"{np.abs(chained - unchained).max():.3e}")
    if (CHAIN_BATCH, CHAIN_K) not in chain_graphs:
        raise AssertionError(f"chain_k={CHAIN_K} captured no such graph: {chain_graphs}")
    print(f"[feed] bitwise: default runner (ring, async fetch, auto chain K="
          f"{chainer.target_chain_len()}, graphs (bucket, K) {graphs}) == serial "
          f"runner ({SERIAL}) over {N_ROWS}+1 rows; chain_k={CHAIN_K} at batch "
          f"{CHAIN_BATCH} (graphs "
          f"{chain_graphs}, stem launches {chained_launches} = batches {n16}) == "
          f"chain_k=1; ring carried {ring_batches} of {n_batches} batches; ring "
          f"streams {FEED_STATS['ring_streams']}, reused {FEED_STATS['ring_reused']}, "
          f"slots page-locked {FEED_STATS['pinned_slots']}, fallback streams "
          f"{FEED_STATS['fallback_streams']}")
    if FEED_STATS["fallback_streams"]:
        raise AssertionError("a stream took the pure-Python prefetcher on the card")

    # 8 rows against the same forward with the plain stem
    module = _load_named_model("InceptionV3", "random", False, "cuda")
    params = prepare_fused_inception_v3(fold_tf_preprocess(module.state_dict()))
    pick = [i % N_ROWS for i in (0, 1, 63, 64, 100, 150, 200, 255)]
    x = torch.from_numpy(images[pick].astype(np.float32)).cuda()  # RGB as fed
    with torch.inference_mode():
        want = fused_inception_v3_features(params, x, dtype=torch.float32,
                                           stem=stem_reference)
    abs_err, rel = _rel_err(torch.from_numpy(feats[pick]), want.cpu())
    if rel > NET_TOL:
        raise AssertionError(f"featurizer vs plain-stem forward: rel err {rel:.3e}")

    # where the transform's time goes: the forward alone on a device batch
    x = torch.from_numpy(images[:BATCH].astype(np.float32)).cuda()
    with torch.inference_mode():
        fwd = {name: _time_ms(lambda s=s: fused_inception_v3_features(
                   params, x, dtype=torch.float32, stem=s), warmup=2, reps=10)
               for name, s in (("kernel", inception_stem_fused),
                               ("plain", stem_reference))}
    print(f"[forward] fused InceptionV3 forward, B={BATCH} already on the device: "
          f"{fwd['kernel']:.2f} ms with the stem kernel "
          f"({BATCH / fwd['kernel'] * 1e3:.0f} images/s), {fwd['plain']:.2f} ms "
          f"with the plain stem; {card}")

    # time, repeated: serial and pipelined in turns, after a warm-up of each,
    # over the 4-partition frame (one batch a partition) and one partition
    n1 = batches(df1, BATCH)
    featurizer.transform(df1).collect()
    with _runner_settings(**SERIAL):
        featurizer.transform(df1).collect()
    rates = {}
    for _ in range(TIME_REPS):
        for frame, label in ((df, "4 partitions"), (df1, "1 partition")):
            for setting in ("serial", "pipelined"):
                ctx = (_runner_settings(**SERIAL) if setting == "serial"
                       else contextlib.nullcontext())
                with ctx:
                    _, t, _, _ = counted(featurizer, frame)
                rates.setdefault((label, setting), []).append(N_ROWS / t)
    for (label, setting), r in rates.items():
        print(f"[feed] {label}, {setting}: median {statistics.median(r):.1f} "
              f"images/s (min {min(r):.1f}, max {max(r):.1f}, {TIME_REPS} "
              f"transforms in turns); {card}")

    # where the host time goes, per batch, serial then pipelined
    for setting in ("serial", "pipelined"):
        for frame, label, nb in ((df, "4 partitions", n_batches),
                                 (df1, "1 partition", n1)):
            if setting == "serial":
                with _runner_settings(**SERIAL) as made:
                    line = _host_split(featurizer, frame, nb,
                                       lambda: list(made.values()))
            else:
                line = _host_split(featurizer, frame, nb, lambda: [runner])
            print(f"[feed] {setting}, {label}, ms: {line}; {card}")

    print(f"[main] DeepImageFeaturizer(InceptionV3) over {N_ROWS}+1 rows in "
          f"{N_PARTS} partitions, batchSize {BATCH}: {N_ROWS / secs:.1f} images/s "
          f"(default runner, steady state after a warm-up transform, host decode "
          f"included; serial runner {N_ROWS / serial_secs:.1f}); "
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


def _bound(flops: float, nbytes: float, peak: float = H100_F32_FLOPS) -> tuple[float, str]:
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / H100_BYTES_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def _attention_work(b: int, lq: int, lk: int, mask, causal: bool = False,
                    q_offset: int = 0, heads: int = HEADS,
                    head_dim: int = HEAD_DIM) -> tuple[float, float]:
    """(flops, bytes) that an f32 attention forward needs on this run's
    mask: QK and PV (2 per MAC) over the (query, key) pairs a row may
    attend, and Q and O, the K and V rows of the keys some query attends,
    and the mask, each moved once."""
    from sparkdl_torch.ops.flash_attention import _keep_mask

    device = "cpu" if mask is None else mask.device
    keep = _keep_mask(b, lq, lk, mask, causal, q_offset, device)[:, 0]
    pairs, keys = int(keep.sum()), int(keep.any(dim=1).sum())
    flops = 4.0 * heads * head_dim * pairs
    nbytes = (4.0 * heads * head_dim * (2 * b * lq + 2 * keys)
              + (0 if mask is None else b * lk))
    return flops, nbytes


def phase_flash_attention(card: str) -> dict:
    """The kernel against flash_attention_reference on the card, f32 and
    bf16 (output and lse), at the GPT-2 prefill, the cached prefill and
    the BERT/ViT shapes; timed in f32 against its bound (3xTF32 on the
    tensor cores, the CUDA-core f32 bound beside it) and against
    scaled_dot_product_attention on the same inputs. Prints the kernel's
    builds (_fwd_builds)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from sparkdl_torch.ops.flash_attention import (
        _keep_mask,
        flash_attention,
        flash_attention_reference,
    )

    builds = _fwd_builds()
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
        flops, nbytes = _attention_work(b, lq, lk, mask, causal, q_offset)
        # on the tensor cores as 3xTF32 (three TF32 passes a product); the
        # CUDA cores' f32 bound beside it
        bound_ms, bound_by = _bound(3 * flops, nbytes, H100_TF32_FLOPS)
        core_ms, core_by = _bound(flops, nbytes)
        report.append(
            f"{name} B={b} Lq={lq} Lk={lk}{' causal' if causal else ''}"
            f"{f' q_offset={q_offset}' if q_offset else ''}: rel err f32 "
            f"{errs[torch.float32][1]:.2e} (lse {errs[torch.float32][2]:.2e}), "
            f"bf16 {errs[torch.bfloat16][1]:.2e}; kernel {ms:.4f} ms ({host_ms:.4f} "
            f"per call from the host), plain {plain_ms:.4f}, sdpa "
            f"{library_ms:.4f} (kernel/sdpa {ms / library_ms:.2f}), bound {bound_ms:.4f} "
            f"({bound_by}; {flops / 1e9:.3f} GFLOP, 3xTF32 at 495 TFLOP/s "
            f"{3 * flops / H100_TF32_FLOPS * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB), "
            f"CUDA-core bound {core_ms:.4f} ({core_by})")
        if entry is None:  # the main path's shape: the GPT-2 prefill
            entry = {
                "name": "flash_attention", "route": "cuda",
                "source": "sparkdl_torch/csrc/flash_attention.cu",
                "replaces": "sparkdl_tpu/ops/flash_attention.py:80",
                "launches": None, "max_abs_err": errs[torch.float32][0],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "cuda_core_bound_ms": core_ms,
            }
    print(f"[flash_attention] builds: {builds}")
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


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host wall ms of ``fn()`` to the device's completion (what the
    host waits for), after one call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _launch_names(launches: dict) -> str:
    """'flash_attention 12, flash_decode 372' from a graph's launch delta."""
    return ", ".join(f"{fn.__name__}{'' if name == 'launches' else '.' + name[9:]} {n}"
                     for (fn, name), n in sorted(launches.items(),
                                                 key=lambda kv: kv[0][0].__name__))


def phase_generate(card: str, attn_entry: dict, decode_entry: dict) -> float:
    """DeepTextGenerator at GPT-2-small width through both attention
    kernels, each bucket's whole generate one CUDA graph: its tokens
    against eager generate over the same buckets (bitwise) and against
    attn_impl="full" (no kernel), a sampled bucket's replay against eager
    generate with the same seed, and where a group's time goes, eager
    and graphed."""
    import dataclasses

    import numpy as np
    import torch

    from sparkdl_torch import DeepTextGenerator, LocalDataFrame
    from sparkdl_torch.models.gpt import (
        GPTConfig,
        GPTLMHeadModel,
        generate,
        init_cache,
        init_gpt_,
    )
    from sparkdl_torch.ops.flash_attention import flash_attention
    from sparkdl_torch.ops.flash_decode import flash_decode
    from sparkdl_torch.runtime.batching import default_buckets
    from sparkdl_torch.transformers.text_generator import (
        GENERATE_GRAPHS,
        _group_generator,
        _model,
        graphed_generate,
        left_pad_group,
    )

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
    # the groups DeepTextGenerator decodes: each partition's valid prompts,
    # batchSize at a time, left-padded into their (rows, prompt_len) bucket
    row_buckets = default_buckets(GEN_BATCH, min_bucket=4)
    len_buckets = default_buckets(GEN_LEN, min_bucket=8)
    parts = df.mapPartitions(lambda part: [
        {"rows": [(r["id"], r["prompt"]) for r in part if r["id"] >= 0]}]).collect()
    groups = []
    for part in parts:
        for i in range(0, len(part["rows"]), GEN_BATCH):
            chunk = part["rows"][i:i + GEN_BATCH]
            ids, mask = left_pad_group([p for _, p in chunk], row_buckets, len_buckets)
            groups.append(([n for n, _ in chunk], torch.from_numpy(ids).cuda(),
                           torch.from_numpy(mask).cuda()))
    n_groups = len(groups)
    buckets = sorted({tuple(ids.shape) for _, ids, _ in groups})

    def transformer(c, **kw):
        return DeepTextGenerator(inputCol="prompt", outputCol="gen", model=(c, state),
                                 batchSize=GEN_BATCH, maxLength=GEN_LEN,
                                 maxNewTokens=GEN_NEW, **kw)

    gen = transformer(cfg)
    GENERATE_GRAPHS.clear()
    captures0 = GENERATE_GRAPHS.captures
    t0 = time.perf_counter()
    gen.transform(df).collect()  # first use of each bucket: eager, then captured
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    captured = GENERATE_GRAPHS.captures - captures0
    if captured != len(buckets):
        raise AssertionError(f"{captured} graphs captured for {len(buckets)} buckets")
    _zero_counts()
    t0 = time.perf_counter()
    out = gen.transform(df).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_attn, n_decode = flash_attention.launches, flash_decode.launches
    if GENERATE_GRAPHS.captures != captures0 + captured:
        raise AssertionError("the second transform captured again instead of replaying")
    layers = cfg.num_layers
    if n_attn != layers * n_groups or n_decode != layers * (GEN_NEW - 1) * n_groups:
        raise AssertionError(
            f"launches: flash_attention {n_attn} (want {layers * n_groups}), "
            f"flash_decode {n_decode} (want {layers * (GEN_NEW - 1) * n_groups}) "
            f"for {n_groups} groups")
    graph_stats = [(k[0][1][0][0], g) for k, g in zip(GENERATE_GRAPHS.keys(),
                                                      GENERATE_GRAPHS.graphs())]

    by_id = {r["id"]: r["gen"] for r in out}
    if len(out) != GEN_ROWS + 1 or by_id[-1] is not None:
        raise AssertionError("bad row did not come out None")
    toks = np.array([by_id[i] for i in range(GEN_ROWS)])
    if toks.shape != (GEN_ROWS, GEN_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids: bad shape or range {toks.shape}")

    # the same groups through eager generate (one launch an op) and through
    # the graphs (replays): the same tokens, bitwise
    mod, mod_full = _model(cfg, state, "cuda"), _model(full, state, "cuda")
    runs = {}
    for name, fn in (("eager", lambda ids, mask: generate(mod, ids, GEN_NEW,
                                                          attention_mask=mask)),
                     ("graphed", lambda ids, mask: graphed_generate(mod, ids, mask,
                                                                    GEN_NEW))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(ids, mask) for _, ids, mask in groups]
        torch.cuda.synchronize()
        runs[name] = (outs, time.perf_counter() - t0)
    if GENERATE_GRAPHS.captures != captures0 + captured:
        raise AssertionError("graphed_generate captured again instead of replaying")
    same_groups = sum(torch.equal(a, b) for a, b in zip(*(runs[n][0] for n in runs)))
    eager_rows = {n: o[j, -GEN_NEW:].tolist() for (ns, ids, _), o in zip(groups, runs["eager"][0])
                  for j, n in enumerate(ns)}
    same_rows = sum(by_id[i] == eager_rows[i] for i in range(GEN_ROWS))
    if same_groups != n_groups or same_rows != GEN_ROWS:
        raise AssertionError(f"graphed tokens differ from eager generate: {n_groups - same_groups} "
                             f"groups, {GEN_ROWS - same_rows} transformer rows")

    gen_full = transformer(full)
    gen_full.transform(df).collect()  # its own buckets' graphs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_full = gen_full.transform(df).collect()
    torch.cuda.synchronize()
    secs_full = time.perf_counter() - t0
    want = {r["id"]: r["gen"] for r in out_full}
    same = sum(by_id[i] == want[i] for i in range(GEN_ROWS))
    if same != GEN_ROWS or want[-1] is not None:
        raise AssertionError(
            f"greedy tokens differ from attn_impl='full' in {GEN_ROWS - same} rows")

    # a sampled bucket: the first transform runs it eagerly and captures
    # it, the second replays it; both equal eager generate from the seed
    sample_kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    sdf = LocalDataFrame.from_rows(
        [{"id": i, "prompt": p} for i, p in enumerate(prompts[:GEN_BATCH])], 1)
    sampler = transformer(cfg, temperature=0.8, topK=40, topP=0.95, seed=3)
    c0 = GENERATE_GRAPHS.captures
    sampled = [{r["id"]: r["gen"] for r in sampler.transform(sdf).collect()}
               for _ in range(2)]
    ids, mask = left_pad_group(prompts[:GEN_BATCH], row_buckets, len_buckets)
    want_s = generate(mod, torch.from_numpy(ids).cuda(), GEN_NEW,
                      attention_mask=torch.from_numpy(mask).cuda(),
                      generator=_group_generator(3, 0, mod.wte.weight.device),
                      **sample_kw)[:, -GEN_NEW:]
    want_s = {i: want_s[i].tolist() for i in range(GEN_BATCH)}
    if GENERATE_GRAPHS.captures != c0 + 1 or sampled[0] != want_s or sampled[1] != want_s:
        raise AssertionError(
            f"sampled bucket: {GENERATE_GRAPHS.captures - c0} captures (want 1); eager "
            f"pass equal {sampled[0] == want_s}, replay equal {sampled[1] == want_s}")
    greedy_share = float(np.mean([a == b for i in range(GEN_BATCH)
                                  for a, b in zip(want_s[i], by_id[i])]))

    # first-step logits of 4 left-padded rows, kernels vs dense, on the card
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

    # where a group's time goes: one full group of the longest bucket, eager
    # (CUDA events around the host-driven call; device alone by replaying
    # one forward) and graphed (host wall to completion; CUDA events)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (GEN_BATCH, GEN_LEN))).cuda()
    mask = torch.ones_like(ids, dtype=torch.bool)
    times = {}
    for name, m in (("flash", mod), ("full", mod_full)):
        prefill = _generate_ms(m, ids, mask, 1)
        whole = _generate_ms(m, ids, mask, GEN_NEW)
        times[name] = (prefill, (whole - prefill) / (GEN_NEW - 1),
                       *_device_split(m, ids, profile_steps=5 * (m is mod)))
    graphed = {}
    for new in (1, GEN_NEW):
        call = lambda new=new: graphed_generate(mod, ids, mask, new)  # noqa: E731
        graphed[new] = (_wall_ms(call), _time_ms(call, warmup=1, reps=5))
    g_host = (graphed[GEN_NEW][0] - graphed[1][0]) / (GEN_NEW - 1)
    g_dev = (graphed[GEN_NEW][1] - graphed[1][1]) / (GEN_NEW - 1)
    big = [g for shape, g in zip(GENERATE_GRAPHS.keys(), GENERATE_GRAPHS.graphs())
           if shape[0][1][0][0] == (GEN_BATCH, GEN_LEN)
           and shape[1][:3] == (cfg, GEN_NEW, 0.0)][0]
    tokens_s = GEN_ROWS * GEN_NEW / secs
    eager_tok_s = GEN_ROWS * GEN_NEW / runs["eager"][1]
    graphed_tok_s = GEN_ROWS * GEN_NEW / runs["graphed"][1]
    print(f"[generate] DeepTextGenerator GPT-2 small ({layers}x{cfg.hidden_size}, "
          f"vocab {cfg.vocab_size}, learned positions, float32, random init seed 0 "
          f"in {init_s:.1f} s) over "
          f"{GEN_ROWS}+1 prompts of 8..{GEN_LEN} tokens in {N_PARTS} partitions, "
          f"batchSize {GEN_BATCH}, {GEN_NEW} new tokens greedy, each bucket's whole "
          f"generate one CUDA graph; {card}: {tokens_s:.1f} tokens/s with the kernels "
          f"(replays, host and DataFrame included; {first_s:.2f} s for the first "
          f"transform, which ran each bucket eagerly and captured it), "
          f"{GEN_ROWS * GEN_NEW / secs_full:.1f} with attn_impl='full'; launches "
          f"flash_attention {n_attn} = {layers} x {n_groups} groups, flash_decode "
          f"{n_decode} = {layers} x {GEN_NEW - 1} x {n_groups}; tokens equal to eager "
          f"generate in {same_rows}/{GEN_ROWS} rows and {same_groups}/{n_groups} groups "
          f"(bitwise), equal to 'full' in {same}/{GEN_ROWS} rows; first-step logits rel "
          f"err {logit_rel:.2e} (tol {LOGIT_TOL}); bad row None")
    print(f"[generate] graphs: {captured} captured for the {len(buckets)} buckets (rows, "
          f"prompt_len) " + ", ".join(
              f"{shape[0]}x{shape[1]}: capture {g.capture_s * 1e3:.0f} ms, pool "
              f"{g.pool_bytes / 2**20:.0f} MB" for shape, g in graph_stats)
          + f"; per replay of a group: {_launch_names(big.launches)}; B={GEN_BATCH} "
          f"{GEN_LEN}+{GEN_NEW}: capture {big.capture_s * 1e3:.0f} ms, pool "
          f"{big.pool_bytes / 2**20:.0f} MB")
    print(f"[generate] one group B={GEN_BATCH} L={GEN_LEN}: eager prefill "
          f"{times['flash'][0]:.2f} ms host-driven ({times['flash'][2]:.2f} device), "
          f"decode {times['flash'][1]:.3f} ms/step host-driven ({times['flash'][3]:.3f} "
          f"device: one forward replayed); graphed whole generate "
          f"{graphed[GEN_NEW][0]:.2f} ms host wall, {graphed[GEN_NEW][1]:.2f} ms CUDA "
          f"events (1 token: {graphed[1][0]:.2f}, {graphed[1][1]:.2f}), decode "
          f"{g_host:.3f} ms/step host-driven, {g_dev:.3f} device; 'full' eager "
          f"{times['full'][0]:.2f} ms ({times['full'][2]:.2f}), {times['full'][1]:.3f} "
          f"ms/step ({times['full'][3]:.3f}); over the {n_groups} groups without the "
          f"DataFrame: eager {eager_tok_s:.1f} tokens/s, graphed {graphed_tok_s:.1f}")
    print(f"[generate] sampled bucket (temperature 0.8, top-k 40, top-p 0.95, seed 3, "
          f"{GEN_BATCH} prompts): 1 graph captured, the eager first pass and the replay "
          f"both equal to eager generate from the same seed ({GEN_BATCH * GEN_NEW} "
          f"tokens, {greedy_share:.0%} of them equal to the greedy ones)")
    print(f"[generate] profile of a decode forward with the kernels, B={GEN_BATCH} "
          f"at position {GEN_LEN}: {times['flash'][4]}")
    attn_entry["launches"] = n_attn
    decode_entry["launches"] = n_decode
    GENERATE_GRAPHS.clear()
    torch.cuda.empty_cache()
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


# [flash_attention_bwd] cases at the edges of the backward kernels' tiling and
# loads: (name, B, Lq, Lk, D, causal, q_offset, mask, packed). L=197 is the
# ViT-B/16 length; D=32 and D=128 run causal with q_offset=3 and Lq < Lk; at
# D=30 rows start off 16-byte boundaries (the kernels' scalar load path), and
# q, k, v are strided views of one packed [B, L, H, 3D] tensor. "dead": a
# right-padded key mask whose last batch row has no valid key.
BWD_EDGE_CASES = (
    ("vit_L197", 4, BERT_LEN, BERT_LEN, HEAD_DIM, False, 0, None, False),
    ("d32_causal_qoff3", 4, 125, 131, 32, True, 3, "dead", False),
    ("d128_causal_qoff3", 4, 125, 131, 128, True, 3, "dead", False),
    ("d30_unaligned", 4, 77, 77, 30, False, 0, "dead", True),
)


def _check_bwd(name, q, k, v, do, mask, causal, q_offset, dtype, tol, errs) -> str:
    """Both backward kernels against flash_attention_bwd_reference (rel err
    within tol x max|ref|), bitwise equal across two calls and to the
    gradients autograd takes through flash_attention; one report item."""
    import torch

    from sparkdl_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )

    qd, kd, vd, dod = (t.to(dtype) for t in (q, k, v, do))
    o, lse = flash_attention(qd, kd, vd, mask, causal=causal, q_offset=q_offset,
                             return_lse=True)
    got = flash_attention_bwd(qd, kd, vd, mask, o, lse, dod, causal=causal,
                              q_offset=q_offset)
    again = flash_attention_bwd(qd, kd, vd, mask, o, lse, dod, causal=causal,
                                q_offset=q_offset)
    torch.cuda.synchronize()
    want = flash_attention_bwd_reference(qd, kd, vd, mask, o, lse, dod, causal=causal,
                                         q_offset=q_offset)
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
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{name} {dtype}: two calls differ (not deterministic)")
    # through autograd: flash_attention's backward is the kernels
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (qd, kd, vd))
    flash_attention(qq, kk, vv, mask, causal=causal, q_offset=q_offset).backward(dod)
    for g, w in zip((qq.grad, kk.grad, vv.grad), got):
        if not torch.equal(g, w):
            raise AssertionError(f"{name} {dtype}: autograd != flash_attention_bwd")
    dead = int((lse <= -1e29).sum())
    return (f"{name} {'f32' if dtype == torch.float32 else 'bf16'} "
            f"dq/dk/dv {'/'.join(f'{r:.1e}' for r in rels)} ({dead} rows without a valid key)")


def _sass_hmma(name: str) -> dict:
    """HMMA (tensor-core) instructions per function in the SASS of the
    built library of csrc/<name>.cu (cuobjdump -sass)."""
    from sparkdl_torch.ops import _dispatch

    lib = _dispatch.library_path(name)
    tool = os.path.join(os.path.dirname(_dispatch._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    hmma, func = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            func = line.split("Function : ", 1)[1].strip()
            hmma[func] = 0
        elif func is not None and "HMMA" in line:
            hmma[func] += 1
    return hmma


def _builds(name: str, attrs_fn: str, rows) -> str:
    """One library's kernel builds: for each (label, [(mangled name
    fragment, attrs args), ...]) the HMMA count of each instantiation in
    its SASS, asserted > 0, and registers/shared bytes per block/resident
    blocks per SM/spill bytes from cudaFuncGetAttributes (the library's
    ``attrs_fn(*args, int out[4])``)."""
    import ctypes

    from sparkdl_torch.ops import _dispatch

    hmma = _sass_hmma(name)
    attrs = getattr(_dispatch.load_library(name), attrs_fn)
    attrs.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    parts = []
    for label, insts in rows:
        counts, builds = [], []
        for needle, args in insts:
            hits = [n for f, n in hmma.items() if needle in f]
            if len(hits) != 1 or hits[0] <= 0:
                raise AssertionError(f"{needle}: HMMA counts {hits} in the SASS of "
                                     f"{name} (want one kernel, > 0)")
            attrs.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
            rc = attrs(*args, out)
            if rc != 0:
                raise RuntimeError(f"{attrs_fn}{args}: cudaError {rc}")
            counts.append(str(hits[0]))
            builds.append(f"{out[0]}/{out[1]}/{out[2]}/{out[3]}")
        parts.append(f"{label} HMMA {'/'.join(counts)}, regs/smem B/blocks per SM/spill B "
                     f"{' '.join(builds)}")
    return "; ".join(parts)


_TYPES = ((0, "f32", "f"), (1, "bf16", "13__nv_bfloat16"))  # attrs flag, label, mangled


def _fwd_builds() -> str:
    """The forward kernel's builds (_builds), D 16/32/64/128, f32 and bf16."""
    return _builds("flash_attention", "flash_attention_fwd_attrs", [
        (f"fwd {tname}", [(f"flash_fwd_kernelI{mangled}Li{dp}E", (bf16, dp))
                          for dp in (16, 32, 64, 128)])
        for bf16, tname, mangled in _TYPES]) + " (D 16/32/64/128)"


def _bwd_builds() -> str:
    """Each backward kernel's builds (_builds), D 16/32/64/128, f32 and bf16."""
    return _builds("flash_attention_bwd", "flash_attention_bwd_attrs", [
        (f"{kname} {tname}", [(f"flash_bwd_{kname}_kernelI{mangled}Li{dp}E", (which, bf16, dp))
                              for dp in (16, 32, 64, 128)])
        for which, kname in ((0, "dq"), (1, "dkv")) for bf16, tname, mangled in _TYPES]
    ) + " (D 16/32/64/128)"


def _gemm_builds() -> str:
    """The GEMM kernel's builds (_builds), f32 and bf16."""
    return _builds("fused_gemm_bn", "gemm_bn_stats_attrs", [
        (f"gemm {tname}", [(f"gemm_bn_kernelI{mangled}E", (bf16,))])
        for bf16, tname, mangled in _TYPES])


def phase_flash_attention_bwd(card: str) -> tuple[dict, dict, dict]:
    """Both backward kernels against flash_attention_bwd_reference on the
    card, f32 and bf16, at the BERT-base fine-tune shape (right-padded key
    mask, one batch row with no valid key), the GPT-2 prefill shape
    (causal, left-padded: its pad rows see no valid key) and the edge
    cases of BWD_EDGE_CASES; each bitwise equal across two calls and to
    autograd. Prints the kernels' builds (_bwd_builds). Timed at the BERT
    shape in f32 against both bounds (CUDA-core f32 and 3xTF32 tensor
    cores against bytes), the plain backward and the backward of
    scaled_dot_product_attention. Returns the dq and dk/dv entries and the
    forward kernel's time at the BERT training shape."""
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

    builds = _bwd_builds()
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
            report.append(_check_bwd(name, q, k, v, do, mask, causal, 0, dtype, tol, errs))
    for name, bb, lq, lk, d, causal, q_offset, mask_kind, packed in BWD_EDGE_CASES:
        mask = None
        if mask_kind == "dead":
            mask = _right_padded_mask(rng, bb, lk, lo=8)
            mask[-1] = False
        if packed:
            x = torch.from_numpy(rng.standard_normal((bb, lq, HEADS, 3 * d),
                                                     dtype=np.float32)).cuda()
            q, k, v = x[..., :d], x[..., d:2 * d], x[..., 2 * d:]
        else:
            q = torch.from_numpy(rng.standard_normal((bb, lq, HEADS, d), dtype=np.float32)).cuda()
            k, v = (torch.from_numpy(rng.standard_normal(
                (bb, lk, HEADS, d), dtype=np.float32)).cuda() for _ in "kv")
        do = torch.from_numpy(rng.standard_normal((bb, lq, HEADS, d), dtype=np.float32)).cuda()
        for dtype, tol in ((torch.float32, BWD_TOL), (torch.bfloat16, BWD_BF16_TOL)):
            report.append(_check_bwd(name, q, k, v, do, mask, causal, q_offset, dtype, tol,
                                     errs))

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
    sdpa_times = _kernel_times(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), dot, retain_graph=True))
    library_ms = sum(sdpa_times.values())
    sdpa_kernel = max(sdpa_times, key=sdpa_times.get).split("(")[0]
    fwd_library_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), attn_mask=keep))
    # the work this mask needs: products over the (query, key) pairs a row
    # attends; K and V read for the keys some query attends, every other
    # tensor moved once (dk and dv are written for every key)
    fwd_flops, fwd_bytes = _attention_work(b, length, length, bert_mask)
    prod = fwd_flops / 2  # one Lq x (attended keys) x D product
    tensor = 4.0 * b * length * HEADS * HEAD_DIM
    kv_read = fwd_bytes - 2 * tensor - b * length  # the attended keys' K and V
    rows = 2 * 4.0 * b * HEADS * length  # lse and delta
    dq_bytes = 2 * tensor + kv_read + rows + tensor
    dkv_bytes = 2 * tensor + kv_read + rows + 2 * tensor
    # on the CUDA cores in float32, and on the tensor cores as 3xTF32 (three
    # TF32 passes a product): the kernels' bound is the latter
    dq_f32_bound, dq_f32_by = _bound(3 * prod, dq_bytes)
    dkv_f32_bound, dkv_f32_by = _bound(4 * prod, dkv_bytes)
    dq_bound, dq_by = _bound(3 * 3 * prod, dq_bytes, H100_TF32_FLOPS)
    dkv_bound, dkv_by = _bound(3 * 4 * prod, dkv_bytes, H100_TF32_FLOPS)
    fwd_bound, _ = _bound(3 * fwd_flops, fwd_bytes, H100_TF32_FLOPS)
    fwd_core_bound, _ = _bound(fwd_flops, fwd_bytes)
    print(f"[flash_attention_bwd] builds: {builds}")
    print(f"[flash_attention_bwd] H={HEADS}, tol f32 {BWD_TOL} bf16 {BWD_BF16_TOL} x "
          f"max|ref|, each case bitwise equal across two calls and to autograd; {card}: "
          + "; ".join(report)
          + f"; BERT B={b} L={length} D={HEAD_DIM} f32 (device ms per call, profiler): dq "
          f"kernel {dq_ms:.4f} (bound {dq_bound:.4f} {dq_by} on the tensor cores as "
          f"3xTF32, {dq_f32_bound:.4f} {dq_f32_by} on the CUDA cores), dk/dv kernel "
          f"{dkv_ms:.4f} (bound {dkv_bound:.4f} {dkv_by}; {dkv_f32_bound:.4f} "
          f"{dkv_f32_by}); the two kernels {dq_ms + dkv_ms:.4f} = "
          f"{(dq_ms + dkv_ms) / plain_ms:.2f}x the plain backward (dq, dk, dv together) "
          f"and {(dq_ms + dkv_ms) / library_ms:.2f}x SDPA's backward; whole backward "
          f"with delta {whole_ms:.4f} (CUDA-graph replay), plain {plain_ms:.4f}, SDPA "
          f"backward {library_ms:.4f} (its kernels' device time, profiler; main kernel "
          f"{sdpa_kernel} {sdpa_times[max(sdpa_times, key=sdpa_times.get)]:.4f}); forward "
          f"kernel at this shape {fwd_ms:.4f}, plain {fwd_plain_ms:.4f}, SDPA "
          f"{fwd_library_ms:.4f} (kernel/SDPA {fwd_ms / fwd_library_ms:.2f}), bound "
          f"{fwd_bound:.4f} (3xTF32 tensor cores vs bytes; CUDA-core bound "
          f"{fwd_core_bound:.4f})")
    # plain_ms and library_ms time dq, dk and dv together (no plain or library
    # call computes one of them alone): hold them against pair_ms, not ms
    common = {"route": "cuda", "source": "sparkdl_torch/csrc/flash_attention_bwd.cu",
              "launches": None, "plain_ms": plain_ms, "library_ms": library_ms,
              "plain_and_library_cover": "dq+dk+dv", "pair_ms": dq_ms + dkv_ms}
    dq = {"name": "flash_attention_bwd_dq", **common,
          "replaces": "sparkdl_tpu/ops/flash_attention.py:189",
          "max_abs_err": errs["bert", torch.float32, "dq"], "ms": dq_ms,
          "bound_ms": dq_bound, "bound_by": dq_by, "cuda_core_bound_ms": dq_f32_bound}
    dkv = {"name": "flash_attention_bwd_dkv", **common,
           "replaces": "sparkdl_tpu/ops/flash_attention.py:223",
           "max_abs_err": max(errs["bert", torch.float32, "dk"],
                              errs["bert", torch.float32, "dv"]),
           "ms": dkv_ms, "bound_ms": dkv_bound, "bound_by": dkv_by,
           "cuda_core_bound_ms": dkv_f32_bound}
    return dq, dkv, {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                     "library_ms": fwd_library_ms, "bound_ms": fwd_bound,
                     "cuda_core_bound_ms": fwd_core_bound}


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
    and bf16, plus an odd M; timed in f32 against its bound (3xTF32 on the
    tensor cores, the CUDA-core f32 bound beside it), its plain version and
    the bare torch.matmul. Prints the kernel's builds (_gemm_builds)."""
    import numpy as np
    import torch

    from sparkdl_torch.ops.fused_gemm_bn import (
        conv1x1_bn_stats,
        gemm_bn_stats,
        gemm_bn_stats_reference,
        reference_conv1x1_bn_stats,
    )

    builds = _gemm_builds()
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

    ms = plain_ms = mm_ms = bound_ms = core_ms = ops_ms = bytes_ms = 0.0
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
        # 3xTF32 on the tensor cores: three TF32 passes a product
        b_ms, b_by = _bound(3 * 2.0 * m * k * n, nbytes, H100_TF32_FLOPS)
        c_ms, c_by = _bound(2.0 * m * k * n, nbytes)
        ms, plain_ms, mm_ms = ms + count * t_k, plain_ms + count * t_p, mm_ms + count * t_mm
        bound_ms, core_ms = bound_ms + count * b_ms, core_ms + count * c_ms
        ops_ms += count * (3 * 2.0 * m * k * n / H100_TF32_FLOPS * 1e3)
        bytes_ms += count * (nbytes / H100_BYTES_S * 1e3)
        report.append(f"{m}x{k}->{n} x{count}: kernel {t_k:.4f}, plain {t_p:.4f}, "
                      f"matmul {t_mm:.4f}, bound {b_ms:.4f} ({b_by}; CUDA-core "
                      f"{c_ms:.4f} {c_by})")
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[fused_gemm_bn] builds: {builds}")
    print(f"[fused_gemm_bn] tol f32 y {GEMM_TOL}, mean/var {STATS_TOL}, bf16 "
          f"{GEMM_BF16_TOL} x max|ref|; worst rel err " + ", ".join(
              f"{d} {w} {e[0]:.1e}" for (d, w), e in sorted(worst.items()))
          + f" over {len(checks)} shapes (prev BN + ReLU on/off, M 1000 and "
          f"3136 not tile multiples); {card}; f32 device ms per call (CUDA-graph "
          f"replay): " + "; ".join(report)
          + f"; one step's 25 launches: kernel {ms:.3f} ms, plain {plain_ms:.3f}, bare "
          f"f32 torch.matmul {mm_ms:.3f}, bound {bound_ms:.3f} ({bound_by}: 3xTF32 "
          f"operations {ops_ms:.3f} at 495 TFLOP/s, bytes {bytes_ms:.3f}; CUDA-core bound "
          f"{core_ms:.3f}); library_ms null: no single PyTorch call computes "
          "the GEMM with the BN stats (torch.matmul above is for information)")
    return {"name": "gemm_bn_stats", "route": "cuda",
            "source": "sparkdl_torch/csrc/fused_gemm_bn.cu",
            "replaces": "sparkdl_tpu/ops/fused_gemm_bn.py:67", "launches": None,
            "max_abs_err": worst["f32", "y"][1], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "cuda_core_bound_ms": core_ms, "matmul_ms": mm_ms}


def _bn_bytes(kind: str, launch: tuple, size: int, passes: bool = False) -> float:
    """Bytes a launch needs: each [M, C] input read once, each output
    written once. With ``passes``, the bytes of bn_train's design instead:
    its backward reads dz, each y and r in both passes."""
    m, c = launch[:2]
    if kind == "moments":
        return m * c * size
    j, res = launch[2], launch[3]
    if kind == "apply":
        return m * c * size * (j + res + 1)
    reads = 1 + j + res
    return m * c * size * ((1 + passes) * reads + j + res)


def _bn_rand(g, m: int, c: int, dtype, scale: float = 1.0, shift: float = 0.0):
    import torch

    return (torch.randn(m, c, generator=g, device="cuda") * scale + shift).to(dtype)


def _bn_terms(g, m: int, c: int, j: int, dtype) -> list:
    """``j`` random BatchNorms over [m, c] as bn_train's backward takes
    them: (y, scale, shift, mean, var), the moments y's own."""
    import torch

    from sparkdl_torch.ops import bn_train as B

    terms = []
    for _ in range(j):
        y = _bn_rand(g, m, c, dtype, 1.5, 0.4)
        mean, var = B.batch_moments_reference(y)
        gamma = torch.rand(c, generator=g, device="cuda") + 0.5
        beta = torch.randn(c, generator=g, device="cuda") * 0.2
        terms.append((y, *B.affine(gamma, beta, mean, var, BN_EPS), mean, var))
    return terms


def bn_step_ms(launches: dict, plain: bool = False) -> tuple:
    """float32 device ms a step of ``launches`` (``bn_train_launches``) by
    kind, each distinct launch timed once (CUDA-graph replay) and counted as
    often as the step makes it; beside them the byte bound, the ms of the
    design's own traffic at the peak bandwidth and, with ``plain``, the
    plain versions' ms."""
    import torch

    from sparkdl_torch.ops import bn_train as B

    g = torch.Generator(device="cuda").manual_seed(12)
    f32 = torch.float32
    totals, bounds, design, plain_ms = {}, {}, {}, {}
    for kind, items in launches.items():
        for shape in sorted(set(items)):
            count = items.count(shape)
            m, c = shape[:2]
            r = _bn_rand(g, m, c, f32) if kind != "moments" and shape[3] else None
            if kind == "moments":
                y = _bn_rand(g, m, c, f32, 2.0, 0.5)
                run, ref = (lambda: B.batch_moments(y)), (lambda: B.batch_moments_reference(y))
            elif kind == "apply":
                t3 = [t[:3] for t in _bn_terms(g, m, c, shape[2], f32)]
                run = (lambda: B.bn_train_apply(t3, r, True))
                ref = (lambda: B.bn_train_apply_reference(t3, r))
            else:
                terms, dz = _bn_terms(g, m, c, shape[2], f32), _bn_rand(g, m, c, f32)
                kw = dict(relu=True, fma_mask=shape[4], scale_grads=shape[4])
                run = (lambda: B.bn_train_backward(dz, terms, BN_EPS, r, **kw))
                ref = (lambda: B.bn_train_backward_reference(dz, terms, BN_EPS, r, **kw))
            totals[kind] = totals.get(kind, 0.0) + count * _device_ms(run, calls=10)
            if plain:
                plain_ms[kind] = (plain_ms.get(kind, 0.0)
                                  + count * _device_ms(ref, calls=5, reps=3))
            bounds[kind] = (bounds.get(kind, 0.0)
                            + count * _bn_bytes(kind, shape, 4) / H100_BYTES_S * 1e3)
            design[kind] = (design.get(kind, 0.0) + count
                            * _bn_bytes(kind, shape, 4, passes=True) / H100_BYTES_S * 1e3)
            del run, ref
            torch.cuda.empty_cache()
    return totals, bounds, design, plain_ms


def phase_bn_train(card: str) -> dict:
    """bn_train's kernels against their plain versions at every BatchNorm
    launch of the fused ResNet50 step (B=64, 224 px: 28 moments, 36
    applies, 49 backwards), float32 and bfloat16: moments and apply
    within BN_TOL x max|ref| (apply is the plain chain's bits), backward
    within BN_BWD_TOL (a bfloat16 dy within one rounding of the f32
    value besides), each repeated call the same bits; then each launch's
    float32 device ms (CUDA-graph replay) summed over a step, beside its
    byte bound and the plain versions' ms."""
    import torch

    from sparkdl_torch.models.resnet_fused import bn_train_launches
    from sparkdl_torch.ops import bn_train as B

    launches = bn_train_launches(RESNET_BATCH, RESNET_SIZE)
    g = torch.Generator(device="cuda").manual_seed(11)

    def check(what, got, want, tol, step=0.0):
        err = (got.float() - want.float()).abs()
        allowed = tol * want.float().abs().max() + step * want.float().abs()
        if not bool((err <= allowed).all()):
            worst = float((err - allowed).max())
            raise AssertionError(f"bn_train {what}: off by {worst:.3e} over tol {tol} x "
                                 f"max|ref| + {step} x |ref|")
        return float(err.max() / want.float().abs().max().clamp_min(1e-30))

    worst: dict = {}
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for m, c in sorted(set(launches["moments"])):
            y = _bn_rand(g, m, c, dtype, 2.0, 0.5)
            got = B.batch_moments(y)
            again = B.batch_moments(y)
            want = B.batch_moments_reference(y)
            for k in range(2):
                e = check(f"moments {m}x{c} {label}", got[k], want[k], BN_TOL)
                worst[label, "moments"] = max(worst.get((label, "moments"), 0.0), e)
                if not torch.equal(got[k], again[k]):
                    raise AssertionError(f"bn_train moments {m}x{c} {label}: not repeatable")
        for m, c, j, res in sorted(set(launches["apply"])):
            terms = _bn_terms(g, m, c, j, dtype)
            r = _bn_rand(g, m, c, dtype) if res else None
            got = B.bn_train_apply([t[:3] for t in terms], r, True)
            want = B.bn_train_apply_reference([t[:3] for t in terms], r)
            e = check(f"apply {m}x{c} J={j} res={res} {label}", got, want, BN_TOL)
            worst[label, "apply"] = max(worst.get((label, "apply"), 0.0), e)
        for m, c, j, res, seam in sorted(set(launches["backward"])):
            terms = _bn_terms(g, m, c, j, dtype)
            r = _bn_rand(g, m, c, dtype) if res else None
            dz = _bn_rand(g, m, c, dtype)
            kw = dict(relu=True, fma_mask=seam, scale_grads=seam)
            got = B.bn_train_backward(dz, terms, BN_EPS, r, **kw)
            again = B.bn_train_backward(dz, terms, BN_EPS, r, **kw)
            f32 = [(t[0].float(), *t[1:]) for t in terms]
            want = B.bn_train_backward_reference(dz.float(), f32, BN_EPS,
                                                 None if r is None else r.float(), **kw)
            name = f"backward {m}x{c} J={j} res={res} seam={seam} {label}"
            step = BN_BF16_STEP if dtype == torch.bfloat16 else 0.0
            errs = [check(name + " dy", a, b, BN_BWD_TOL, step) for a, b in zip(got[0], want[0])]
            errs += [check(name + " grads", a, b, BN_BWD_TOL)
                     for pa, pb in zip(got[1], want[1]) for a, b in zip(pa, pb)]
            if r is not None:
                errs.append(check(name + " dr", got[2], want[2], 0.0))
            worst[label, "backward"] = max(worst.get((label, "backward"), 0.0), *errs)
            same = all(torch.equal(a, b) for a, b in zip(got[0], again[0]))
            if not same or (r is not None and not torch.equal(got[2], again[2])):
                raise AssertionError(f"bn_train {name}: not repeatable")
        torch.cuda.empty_cache()

    totals, bounds, design, plain = bn_step_ms(launches, plain=True)
    ms, bound_ms, plain_ms = sum(totals.values()), sum(bounds.values()), sum(plain.values())
    design_ms = sum(design.values())
    counts = {k: len(v) for k, v in launches.items()}
    print(f"[bn_train] every BatchNorm launch of the fused ResNet50 step (B={RESNET_BATCH}, "
          f"{RESNET_SIZE} px): moments {counts['moments']}, apply {counts['apply']}, backward "
          f"{counts['backward']}; worst error x max|ref| "
          + ", ".join(f"{d} {k} {e:.1e}" for (d, k), e in sorted(worst.items()))
          + f" (tol {BN_TOL} moments and apply, {BN_BWD_TOL} backward, a bf16 dy one "
          f"rounding of the f32 value besides); each repeat the same bits")
    print(f"[bn_train] {card}; f32 device ms a step (CUDA-graph replay): "
          + ", ".join(f"{k} {totals[k]:.3f} (bound {bounds[k]:.3f}, plain {plain[k]:.3f})"
                      for k in launches)
          + f"; all {ms:.3f} ms against a byte bound of {bound_ms:.3f} ({bound_ms / ms:.1%} "
          f"of the roofline; each input read once, each output written once), the "
          f"two-pass design's own traffic {design_ms:.3f} ({design_ms / ms:.1%}; the "
          f"backward reads dz, y and r twice), plain versions {plain_ms:.3f}; library_ms "
          "null: no single "
          "PyTorch call computes a BatchNorm with the residual, the shortcut's BatchNorm "
          "and ReLU, nor the seam's backward")
    return {"name": "bn_train", "route": "cuda", "source": "sparkdl_torch/csrc/bn_train.cu",
            "replaces": None, "launches": counts, "max_abs_err": worst["f32", "backward"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "by_kind": totals}


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
    from sparkdl_torch.runtime.dispatch import chain_carry, dispatch_count
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

    # the eager reference: classification_train_step in a plain loop, with
    # the optimizer finetune_classifier makes on the card
    def adamw(m):
        return torch.optim.AdamW(m.parameters(), lr=2e-5, weight_decay=0.01, eps=1e-8,
                                 capturable=True)

    staged = [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in batches]

    def eager_loop():
        m = model("flash")
        opt = adamw(m)
        step = classification_train_step(m, opt)
        metrics, step_ms = [], []
        t0 = time.perf_counter()
        for batch in staged:
            t1 = time.perf_counter()
            out = step(batch)
            metrics.append((float(out["loss"]), float(out["accuracy"])))  # waits
            step_ms.append((time.perf_counter() - t1) * 1e3)
        return m, opt, step, metrics, step_ms, time.perf_counter() - t0

    def finetune(k):
        m = model("flash")
        torch.cuda.synchronize()
        _zero_counts()
        d0 = dispatch_count("train")
        t0 = time.perf_counter()
        _, history = finetune_classifier(m, batches, learning_rate=2e-5, chain_steps=k)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = (flash_attention.launches, flash_attention_bwd.launches_dq,
                  flash_attention_bwd.launches_dkv)
        dispatches = int(dispatch_count("train") - d0)
        want = cfg.num_hidden_layers * BERT_STEPS
        if counts != (want, want, want) or dispatches != BERT_STEPS // k:
            raise AssertionError(
                f"chain_steps={k}: BERT launches forward/dq/dkv {counts}, want {want} "
                f"each ({cfg.num_hidden_layers} a step); train dispatches {dispatches}, "
                f"want {BERT_STEPS // k}")
        return m, history, secs, counts, dispatches

    # chain_steps 1 and 4 against the eager loop, under deterministic
    # algorithms: history and final parameters bitwise
    with _deterministic():
        ref_model, _, _, ref, _, _ = eager_loop()
        ref_params = [p.detach() for p in ref_model.parameters()]
        for k in (1, 4):
            m, history, _, _, _ = finetune(k)
            got = [(h["loss"], h["accuracy"]) for h in history]
            same_params = all(torch.equal(p.detach(), q)
                              for p, q in zip(m.parameters(), ref_params))
            if got != ref or not same_params:
                raise AssertionError(
                    f"chain_steps={k}: history equal to the eager loop {got == ref}, "
                    f"final parameters equal {same_params} (want both bitwise)")
            del m
        del ref_model, ref_params
        torch.cuda.empty_cache()

    # the main path (default algorithms): chain_steps=1, then 4, timed
    runs = {}
    for k in (4, 1):
        m, history, secs, counts, dispatches = finetune(k)
        steady = [h["step_time_s"] * 1e3 for h in history[k:]]  # after the capture
        runs[k] = (history, secs, counts, dispatches, float(np.median(steady)))
        del m
        torch.cuda.empty_cache()
    history, secs, counts, _, step_ms = runs[1]

    full_model = model("full")
    _, history_full = finetune_classifier(full_model, batches, learning_rate=2e-5)
    losses = np.array([h["loss"] for h in history])
    want_losses = np.array([h["loss"] for h in history_full])
    hist_rel = float(np.abs(losses - want_losses).max() / np.abs(want_losses).max())
    if not np.isfinite(losses).all() or hist_rel > 1e-3:
        raise AssertionError(f"BERT loss history vs full: rel {hist_rel:.3e} (tol 1e-3)")
    full_ms = float(np.median([h["step_time_s"] for h in history_full[1:]])) * 1e3
    del full_model
    torch.cuda.empty_cache()

    # one step host-driven against the device: eager (host wall to its
    # metrics; the profiler's kernel sum) and graphed (host wall to
    # completion; CUDA events around the replay)
    eager_model, eager_opt, eager_step, _, eager_ms, eager_secs = eager_loop()
    eager_ms = float(np.median(eager_ms[1:]))
    times = _kernel_times(lambda: eager_step(staged[0]), reps=1)
    chained = chain_carry(eager_step)
    chained(staged[:1])  # captured
    graph_host = _wall_ms(lambda: chained(staged[:1]))
    graph_dev = _time_ms(lambda: chained(staged[:1]), warmup=1, reps=10)
    graph = chained.graphs.graphs()[0]
    prof_line = _breakdown(times, {
        "flash fwd": ("flash_fwd_kernel",), "flash bwd": ("flash_bwd_",),
        "GEMMs": ("gemm", "sgemm", "cutlass", "Kernel2")})
    b = BERT_TRAIN_BATCH
    print(f"[train_bert] finetune_classifier BERT-base ({cfg.num_hidden_layers}x"
          f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, MLP "
          f"{cfg.intermediate_size}, vocab {cfg.vocab_size}), float32, random init seed "
          f"0 in {init_s:.1f} s, 2 labels, attn_impl='flash', AdamW 2e-5 (capturable); "
          f"{BERT_STEPS} batches of B={b} L={length}, right-padded lengths 16..{length}; "
          f"{card}: chain_steps=1 {BERT_STEPS * b / secs:.1f} examples/s over the run "
          f"(the first step's capture included), step {step_ms:.2f} ms (median after "
          f"the capture, host wall to the device's completion; {b / step_ms * 1e3:.1f} "
          f"examples/s), {runs[1][3]} train dispatches; chain_steps=4 "
          f"{BERT_STEPS * b / runs[4][1]:.1f} examples/s over the run, step "
          f"{runs[4][4]:.2f} ms ({b / runs[4][4] * 1e3:.1f} examples/s), {runs[4][3]} "
          f"dispatches; eager loop {BERT_STEPS * b / eager_secs:.1f} examples/s, step "
          f"{eager_ms:.2f} ms; 'full' {full_ms:.2f} ms; launches "
          f"forward/dq/dkv {counts[0]}/{counts[1]}/{counts[2]} = "
          f"{cfg.num_hidden_layers} a step x {BERT_STEPS} (chain_steps=4 the same); "
          f"under deterministic algorithms the history and final parameters of both "
          f"equal the eager loop's (bitwise); vs attn_impl='full': first-step loss rel "
          f"{loss_rel:.1e} (tol 1e-5), worst gradient rel {grad_rel:.1e} (tol 1e-4, "
          f"scale floored at 1e-3 of the largest), loss history rel {hist_rel:.1e} (tol "
          f"1e-3); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"[train_bert] one step B={b} L={length}: eager {eager_ms:.2f} ms host-driven, "
          f"{sum(times.values()):.2f} ms of kernels (profiler); graphed {graph_host:.2f} "
          f"ms host wall, {graph_dev:.2f} ms CUDA events (capture "
          f"{graph.capture_s * 1e3:.0f} ms, pool {graph.pool_bytes / 2**20:.0f} MB; per "
          f"replay: {_launch_names(graph.launches)})")
    print(f"[train_bert] profile of one eager step with the kernels: {prof_line}")
    dq_entry["launches"], dkv_entry["launches"] = counts[1], counts[2]
    fwd["bert_launches"] = counts[0]
    del chained, graph, eager_model, eager_opt, eager_step, staged
    torch.cuda.empty_cache()
    return BERT_STEPS * b / secs, step_ms


TRAIN_DP_STEPS, TRAIN_DP_EVERY, TRAIN_DP_FAULT = 12, 4, 10
FLOPS_TOL = 1e-3  # the kernel route's model FLOPs against the plain route's


def _bert_fwd_bwd(model, batch):
    """One forward and backward of the classifier (no optimizer step): the
    work whose model FLOPs compiled_flops counts."""
    import torch

    logits = model(batch["input_ids"], batch["attention_mask"])
    torch.nn.functional.cross_entropy(logits, batch["labels"]).backward()


def _histogram_mean(name: str) -> float:
    from sparkdl_torch.observability.registry import registry

    fam = registry().get(name)
    vals = fam.snapshot_values().get("", {}) if fam is not None else {}
    return float(vals.get("mean") or math.nan)


def train_dp_worker(seed: int = 0) -> dict:
    """The body of [train_dp]'s one TorchRunner rank (an NCCL process on
    the card): preflight, check_health, an uninterrupted fine-tune of
    BERT-base, the same run through resumable_finetune with a fault at
    step 10 (checkpoints every 4 steps), a timed run, FLOP counts on the
    kernel and plain routes, and one timed save/wait/verify/restore."""
    import logging
    import shutil

    import numpy as np
    import torch

    from sparkdl_torch.checkpoint import CheckpointManager
    from sparkdl_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
        init_bert_,
    )
    from sparkdl_torch.observability.health import check_health, preflight
    from sparkdl_torch.observability.metrics import (
        StepMeter,
        aggregate_across_hosts,
        compiled_flops,
        device_peak_flops,
    )
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from sparkdl_torch.partition import DataParallelPartitioner, make_mesh
    from sparkdl_torch.reliability import RetryPolicy, resumable_finetune
    from sparkdl_torch.reliability.faults import inject
    from sparkdl_torch.runtime.dispatch import dispatch_count
    from sparkdl_torch.train import finetune_classifier
    from sparkdl_torch.train.finetune import train_state

    metrics_log = logging.getLogger("sparkdl_torch.metrics")
    metrics_log.setLevel(logging.INFO)
    metrics_log.addHandler(logging.StreamHandler(sys.stdout))
    torch.backends.cudnn.allow_tf32 = False  # as phase_card sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"preflight": preflight().summary()}
    health = check_health()
    if not health.ok:
        raise RuntimeError(health.summary())
    out["health"] = health.summary()
    cfg = BertConfig.base(attn_impl="flash")
    state = init_bert_(BertForSequenceClassification(cfg, num_labels=2, device="cpu"),
                       seed=seed).state_dict()
    rng = np.random.default_rng(9)
    b, length = BERT_TRAIN_BATCH, BERT_TRAIN_LEN
    batches = []
    for _ in range(TRAIN_DP_STEPS):
        mask = _right_padded_mask(rng, b, length).cpu().numpy()
        batches.append({
            "input_ids": rng.integers(0, cfg.vocab_size, (b, length)) * mask,
            "attention_mask": mask, "labels": rng.integers(0, 2, b)})

    def model(device="cuda"):
        m = BertForSequenceClassification(cfg, num_labels=2, device=device)
        m.load_state_dict(state)
        return m

    def partitioner():
        return DataParallelPartitioner(make_mesh(dp=1, fsdp=1), zero_axis="fsdp")

    def counts():
        return (flash_attention.launches, flash_attention_bwd.launches_dq,
                flash_attention_bwd.launches_dkv)

    root = tempfile.mkdtemp(prefix="sparkdl-train-dp-")
    try:
        # the uninterrupted run and the recovered one, bitwise (the
        # deterministic algorithms: cuDNN's and the embedding's default
        # backward sum with atomics)
        with _deterministic():
            ref_model, ref = finetune_classifier(
                model(), batches, learning_rate=2e-5, partitioner=partitioner())
            starts = []

            def note_start(entry, last=[0]):
                if entry["step"] <= last[0] or not starts:
                    starts.append(entry["step"] - 1)
                last[0] = entry["step"]

            _zero_counts()
            d0 = dispatch_count("train")
            with inject(f"dispatch:RuntimeError@{TRAIN_DP_FAULT}"):
                got_model, got = resumable_finetune(
                    model(), batches, checkpoint_dir=os.path.join(root, "run"),
                    partitioner=partitioner(), checkpoint_every=TRAIN_DP_EVERY,
                    keep_checkpoints=2, learning_rate=2e-5, metrics_cb=note_start,
                    retry=RetryPolicy(max_attempts=2, base_delay_s=0.0))
            out["launches"] = counts()
            out["dispatches"] = int(dispatch_count("train") - d0)
            out["restored_from"] = starts
            out["bitwise"] = (
                [(h["step"], h["loss"], h["accuracy"]) for h in got]
                == [(h["step"], h["loss"], h["accuracy"]) for h in ref]
                and all(torch.equal(p, q) for p, q in
                        zip(got_model.parameters(), ref_model.parameters())))
            out["steps_run"] = TRAIN_DP_FAULT - 1 + len(got) - starts[-1]
            out["losses"] = [h["loss"] for h in got]
            del ref_model, got_model
        out["save_sync_ms"] = _histogram_mean("sparkdl_checkpoint_save_seconds") * 1e3
        out["restore_ms"] = _histogram_mean("sparkdl_checkpoint_restore_seconds") * 1e3

        # the same steps with no checkpoints: what the saves cost a step
        bare_meter = StepMeter(warmup_steps=1)
        _, bare = finetune_classifier(model(), batches, learning_rate=2e-5,
                                      partitioner=partitioner())
        for h in bare:
            bare_meter.record(h["step_time_s"], examples=b)
        out["bare_step_ms"] = bare_meter.step_time_percentile(50) * 1e3

        # the timed run (default algorithms), checkpointing as above
        part = partitioner()
        timed = model()
        t0 = time.perf_counter()
        _, hist = finetune_classifier(
            timed, batches, learning_rate=2e-5, partitioner=part,
            checkpoint_dir=os.path.join(root, "timed"),
            checkpoint_every=TRAIN_DP_EVERY, keep_checkpoints=2)
        # the loop's own rate: every example over the whole call, its
        # capture and in-loop saves (and the final drain) included
        out["loop_s"] = time.perf_counter() - t0
        from sparkdl_torch.observability.registry import registry

        out["opt_state_bytes"] = registry().get(
            "sparkdl_opt_state_bytes").labelled_values("axis")["fsdp"]
        staged = {k: torch.as_tensor(v).cuda() for k, v in batches[0].items()}
        flops = compiled_flops(_bert_fwd_bwd, timed, staged)
        timed.zero_grad(set_to_none=True)
        meta = BertForSequenceClassification(cfg, num_labels=2, device="cpu").to("meta")
        plain = compiled_flops(_bert_fwd_bwd, meta,
                               {k: v.to("meta") for k, v in staged.items()})
        meter = StepMeter(flops_per_step=flops, n_chips=1, warmup_steps=1,
                          peak_flops_per_chip=device_peak_flops(dtype="f32"))
        for h in hist:
            meter.record(h["step_time_s"], examples=b)
        out["flops"], out["plain_flops"] = flops, plain
        out["meter"] = meter.summary()
        out["step_ms"] = meter.step_time_percentile(50) * 1e3
        out["rollup"] = aggregate_across_hosts(meter.summary())

        # one save of the full train state, timed by its halves, then a
        # verify and a restore into the live tensors
        opt = torch.optim.AdamW(timed.parameters(), lr=2e-5,
                                capturable=timed.classifier.weight.is_cuda)
        from sparkdl_torch.train.finetune import materialize_optimizer_state

        materialize_optimizer_state(opt)
        live = train_state(timed, opt, TRAIN_DP_STEPS)
        with CheckpointManager(os.path.join(root, "one"), keep=1) as mgr:
            t0 = time.perf_counter()
            mgr.save(TRAIN_DP_STEPS, live, force=True)
            t1 = time.perf_counter()
            mgr.wait()
            t2 = time.perf_counter()
            ok = mgr.verify(TRAIN_DP_STEPS)
            t3 = time.perf_counter()
            mgr.restore(template=live)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                   os.walk(os.path.join(root, "one")) for f in fs)
        out["one_save"] = {"sync_ms": (t1 - t0) * 1e3, "wait_ms": (t2 - t1) * 1e3,
                           "verify_ms": (t3 - t2) * 1e3, "verified": ok,
                           "restore_ms": (t4 - t3) * 1e3, "bytes": size}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_train_dp(card: str, bert_step_ms: float) -> dict:
    """[train_dp]: HorovodRunner's story on the card. TorchRunner(np=-1)
    starts one NCCL rank, which fine-tunes BERT-base through
    resumable_finetune under a ZeRO DataParallelPartitioner (dp=1,
    fsdp=1) with checkpoints, recovers from an injected fault bitwise,
    and reports its launches, FLOPs, MFU and checkpoint times."""
    import torch

    import chip_smoke as this  # by reference: the rank imports it
    from sparkdl_torch import TorchRunner

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = TorchRunner(np=-1, local_platform="cuda", timeout_s=900,
                    metrics_summary=True).run(this.train_dp_worker, seed=0)
    wall = time.perf_counter() - t0
    layers = 12
    fwd, dq, dkv = r["launches"]
    want = layers * r["steps_run"]
    rel = abs(r["flops"] - r["plain_flops"]) / r["plain_flops"]
    failures = []
    if not r["bitwise"]:
        failures.append("the recovered history or final parameters differ from "
                        "the uninterrupted run's")
    if r["restored_from"] != [0, TRAIN_DP_FAULT - 1 - (TRAIN_DP_FAULT - 1) % TRAIN_DP_EVERY]:
        failures.append(f"attempts restored from steps {r['restored_from']}")
    if (fwd, dq, dkv) != (want, want, want) or r["dispatches"] != r["steps_run"]:
        failures.append(f"launches forward/dq/dkv {fwd}/{dq}/{dkv}, want {want} each; "
                        f"train dispatches {r['dispatches']}, want {r['steps_run']}")
    if rel > FLOPS_TOL:
        failures.append(f"compiled_flops kernel route {r['flops']:.6e} vs plain "
                        f"{r['plain_flops']:.6e}: rel {rel:.2e} (tol {FLOPS_TOL})")
    if not r["one_save"]["verified"]:
        failures.append("the timed save did not verify")
    if not all(math.isfinite(x) for x in r["losses"]):
        failures.append("non-finite losses")
    if failures:
        raise AssertionError("[train_dp] " + "; ".join(failures))
    m, s = r["meter"], r["one_save"]
    print(f"[train_dp] {card}: TorchRunner(np=-1, local_platform='cuda') -> one NCCL "
          f"rank ({r['preflight']}), {wall:.1f} s for the whole job; resumable_finetune "
          f"over BERT-base, attn_impl='flash', {TRAIN_DP_STEPS} batches of "
          f"B={BERT_TRAIN_BATCH} L={BERT_TRAIN_LEN}, DataParallelPartitioner(make_mesh("
          f"dp=1, fsdp=1), zero_axis='fsdp'), checkpoint_every={TRAIN_DP_EVERY}, keep 2, "
          f"fault_point('dispatch') at step {TRAIN_DP_FAULT}: attempts restored from "
          f"steps {r['restored_from']}, recovered history and final parameters bitwise "
          f"the uninterrupted run's (deterministic algorithms) {r['bitwise']}; "
          f"{r['steps_run']} steps run, {r['dispatches']} train dispatches (one graph a "
          f"step), launches forward/dq/dkv {fwd}/{dq}/{dkv} = {layers} a step as "
          f"[train_bert]; loss {r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}")
    loop_rate = TRAIN_DP_STEPS * BERT_TRAIN_BATCH / r["loop_s"]
    print(f"[train_dp] timed run (default algorithms, checkpointing): the whole "
          f"finetune_classifier call {r['loop_s'] * 1e3:.1f} ms for {TRAIN_DP_STEPS} "
          f"steps = {loop_rate:.1f} examples/s (capture, in-loop saves and the final "
          f"drain included); step-only (the saves excluded): step "
          f"{r['step_ms']:.2f} ms median after the capture ({r['bare_step_ms']:.2f} ms with "
          f"no checkpoints; [train_bert] {bert_step_ms:.2f} ms), "
          f"{m['examples_per_sec']:.1f} examples/s, compiled_flops "
          f"{r['flops']:.6e} a step on the kernel route, {r['plain_flops']:.6e} on the "
          f"plain route (meta tensors; rel {rel:.1e}, tol {FLOPS_TOL}), MFU "
          f"{m['mfu']:.4f} of the f32 peak {67e12:.3e} FLOP/s (device_peak_flops); "
          f"opt_state_bytes (ZeRO on fsdp=1) {r['opt_state_bytes'] / 2**20:.1f} MiB; "
          f"in-loop checkpoints: save (drain + snapshot) {r['save_sync_ms']:.1f} ms, "
          f"restore {r['restore_ms']:.1f} ms (means); one full "
          f"state ({s['bytes'] / 2**30:.2f} GiB): save {s['sync_ms']:.1f} ms, wait "
          f"(write + sha256) {s['wait_ms']:.1f} ms, verify {s['verify_ms']:.1f} ms, "
          f"restore {s['restore_ms']:.1f} ms; aggregate_across_hosts "
          f"{json.dumps(r['rollup'], sort_keys=True)}")
    return {"examples_s": m["examples_per_sec"], "loop_examples_s": loop_rate,
            "mfu": m["mfu"],
            "step_ms": r["step_ms"], "bare_step_ms": r["bare_step_ms"],
            "save_ms": s["sync_ms"],
            "wait_ms": s["wait_ms"], "restore_ms": s["restore_ms"]}


# -- [parallel]: model parallelism (parallel/) on the card ----------------------

MOE_EXPERTS, MOE_EVERY, MOE_K, MOE_CF = 8, 2, 2, 2.0
MOE_ROWS, MOE_LEN, MOE_NEW = 16, 128, 32
RING_LEN, RING_SHARDS = 4096, 4
RING_TOL = 1e-5   # f32 online softmax vs the dense softmax, relative to max|ref|


def _moe_config():
    """GPT-2 small with six mixture-of-experts layers (every second one):
    8 experts of the dense MLP's shape, top-2, capacity factor 2."""
    from sparkdl_torch.models.gpt import GPTConfig

    return GPTConfig(positions="learned", attn_impl="flash", flash_decode=True,
                     num_experts=MOE_EXPERTS, moe_every=MOE_EVERY, moe_k=MOE_K,
                     moe_capacity_factor=MOE_CF)


def _moe_check(card: str) -> dict:
    """[moe]: the MoE GPT generating through the flash forward and flash
    decode, the whole generate one CUDA graph, against the eager "full"
    path's greedy tokens; one forward's logits against "full"; an MoE
    layer's device time against a dense MLP layer's."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from sparkdl_torch.models.gpt import GPTLMHeadModel, generate, init_gpt_
    from sparkdl_torch.ops.flash_attention import flash_attention
    from sparkdl_torch.ops.flash_decode import flash_decode
    from sparkdl_torch.transformers.text_generator import (
        GENERATE_GRAPHS,
        graphed_generate,
    )

    cfg = _moe_config()
    full = dataclasses.replace(cfg, attn_impl="full", flash_decode=False)
    t0 = time.perf_counter()
    state = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
    init_s = time.perf_counter() - t0
    mods = {}
    for name, c in (("flash", cfg), ("full", full)):
        mods[name] = GPTLMHeadModel(c, device="cuda")
        mods[name].load_state_dict(state)
        mods[name].eval()
    mod = mods["flash"]
    # parameters beyond the dense model: each MoE layer's experts and
    # router in place of one dense MLP
    n_moe = sum(hasattr(blk, "moe_mlp") for blk in mod.h)
    dense_mlp = sum(p.numel() for p in (*mod.h[0].up.parameters(), *mod.h[0].down.parameters()))
    extra = sum(p.numel() for n, p in mod.named_parameters() if "moe_mlp" in n) - n_moe * dense_mlp

    rng = np.random.default_rng(11)
    lens = rng.integers(8, MOE_LEN + 1, MOE_ROWS)
    ids = torch.zeros((MOE_ROWS, MOE_LEN), dtype=torch.long)
    mask = torch.zeros((MOE_ROWS, MOE_LEN), dtype=torch.bool)
    for i, n in enumerate(lens):
        ids[i, MOE_LEN - n:] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
        mask[i, MOE_LEN - n:] = True
    ids, mask = ids.cuda(), mask.cuda()

    GENERATE_GRAPHS.clear()
    captures0 = GENERATE_GRAPHS.captures
    graphed_generate(mod, ids, mask, MOE_NEW)  # eager, then captured
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    got = graphed_generate(mod, ids, mask, MOE_NEW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_attn, n_dec = flash_attention.launches, flash_decode.launches
    layers = cfg.num_layers
    failures = []
    if GENERATE_GRAPHS.captures != captures0 + 1:
        failures.append(f"{GENERATE_GRAPHS.captures - captures0} captures, want 1")
    if n_attn != layers or n_dec != layers * (MOE_NEW - 1):
        failures.append(f"launches flash_attention {n_attn} (want {layers}), flash_decode "
                        f"{n_dec} (want {layers * (MOE_NEW - 1)})")
    want = generate(mods["full"], ids, MOE_NEW, attention_mask=mask)
    same_rows = int((got == want).all(dim=1).sum())
    if same_rows != MOE_ROWS:
        failures.append(f"greedy tokens differ from the eager 'full' path in "
                        f"{MOE_ROWS - same_rows} rows")
    plain_ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (MOE_ROWS, MOE_LEN))).cuda()
    with torch.inference_mode():
        logits = {n: m(plain_ids)[0] for n, m in mods.items()}
    _, logit_rel = _rel_err(logits["flash"], logits["full"])
    if not torch.isfinite(logits["flash"]).all() or logit_rel > LOGIT_TOL:
        failures.append(f"forward logits vs 'full': rel err {logit_rel:.3e} (tol {LOGIT_TOL})")
    if failures:
        raise AssertionError("[moe] " + "; ".join(failures))

    h = torch.randn((MOE_ROWS, MOE_LEN, cfg.hidden_size), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    moe_blk, dense_blk = mod.h[MOE_EVERY - 1].moe_mlp, mod.h[0]
    with torch.inference_mode():
        moe_ms = _device_ms(lambda: moe_blk(h), calls=10)
        dense_ms = _device_ms(lambda: dense_blk.down(F.gelu(dense_blk.up(h), approximate="tanh")),
                              calls=10)
    tokens_s = MOE_ROWS * MOE_NEW / secs
    print(f"[moe] {card}: GPT-2 small ({layers}x{cfg.hidden_size}, {cfg.num_heads} heads, "
          f"learned positions, float32, random init seed 0 in {init_s:.1f} s) with "
          f"{n_moe} MoE layers (every {MOE_EVERY}nd: {MOE_EXPERTS} experts, top-{MOE_K}, "
          f"capacity factor {MOE_CF}; {extra / 1e6:.1f} M parameters more than dense), "
          f"attn_impl='flash', flash_decode; B={MOE_ROWS} left-padded prompts of "
          f"{int(lens.min())}..{int(lens.max())} tokens, {MOE_NEW} greedy tokens, the whole "
          f"generate one CUDA graph: {tokens_s:.1f} tokens/s (a replay, {secs * 1e3:.1f} ms); "
          f"launches flash_attention {n_attn} = {layers} layers x 1 prefill, flash_decode "
          f"{n_dec} = {layers} x {MOE_NEW - 1}; tokens equal to eager attn_impl='full' in "
          f"{same_rows}/{MOE_ROWS} rows; forward logits rel err {logit_rel:.2e} (tol "
          f"{LOGIT_TOL}); device ms at [{MOE_ROWS}, {MOE_LEN}, {cfg.hidden_size}]: MoE layer "
          f"{moe_ms:.3f} (capacity {moe_blk.capacity(MOE_LEN)} a group), dense MLP layer "
          f"{dense_ms:.3f} ({moe_ms / dense_ms:.2f}x)")
    GENERATE_GRAPHS.clear()
    del mods, mod
    torch.cuda.empty_cache()
    return {"tokens_s": tokens_s, "attn_launches": n_attn, "decode_launches": n_dec,
            "moe_ms": moe_ms, "dense_ms": dense_ms}


def _ring_arithmetic() -> dict:
    """The ring's fold at GPT-2-small width, B=1, L=4096, causal, on one
    card: each of RING_SHARDS query shards folds the K/V shards in the
    order its rank would receive them (its own first), against the dense
    causal softmax; and the all-gather schedule's per-shard products
    against the whole sequence's rows (does cuBLAS round a block of rows
    as it rounds them inside the whole?)."""
    import torch
    import torch.nn.functional as F

    from sparkdl_torch.ops.flash_attention import NEG_INF
    from sparkdl_torch.parallel.ring_attention import _block_attend

    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, RING_LEN, HEADS, HEAD_DIM), device="cuda", generator=g)
               for _ in range(3))
    scale = HEAD_DIM ** -0.5
    n = RING_LEN // RING_SHARDS

    def dense(qs, q0):
        s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float()) / math.sqrt(HEAD_DIM)
        q_pos = q0 + torch.arange(qs.shape[1], device="cuda")
        keep = torch.arange(RING_LEN, device="cuda")[None, :] <= q_pos[:, None]
        p = torch.softmax(torch.where(keep[None, None], s, NEG_INF), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)

    def ring():
        outs = []
        for r in range(RING_SHARDS):
            qs = q[:, r * n:(r + 1) * n]
            o = torch.zeros_like(qs)
            m = torch.full((1, HEADS, n), NEG_INF, device="cuda")
            l = torch.zeros((1, HEADS, n), device="cuda")
            for hop in range(RING_SHARDS):
                owner = (r - hop) % RING_SHARDS
                o, m, l = _block_attend(
                    qs, k[:, owner * n:(owner + 1) * n], v[:, owner * n:(owner + 1) * n],
                    o, m, l, q_offset=r * n, k_offset=owner * n, causal=True, scale=scale)
            outs.append(o / l.clamp_min(1e-30).transpose(1, 2)[..., None])
        return torch.cat(outs, dim=1)

    with torch.inference_mode():
        ref = dense(q, 0)
        got = ring()
        err, rel = _rel_err(got, ref)
        shards = [dense(q[:, r * n:(r + 1) * n], r * n) for r in range(RING_SHARDS)]
        attn_diff = max((s - ref[:, r * n:(r + 1) * n]).abs().max().item()
                        for r, s in enumerate(shards))
        # GPT-2 small's products (in, out): q/k/v/out_proj, up, down, and a
        # fused q/k/v
        lin_diff = {}
        for din, dout in ((768, 768), (768, 3072), (3072, 768), (768, 2304)):
            w = torch.randn((dout, din), device="cuda", generator=g) * din ** -0.5
            x = torch.randn((1, RING_LEN, din), device="cuda", generator=g)
            whole = F.linear(x, w)
            lin_diff[f"{din}x{dout}"] = max(
                (F.linear(x[:, r * n:(r + 1) * n], w) - whole[:, r * n:(r + 1) * n])
                .abs().max().item() for r in range(RING_SHARDS))
        ring_ms = _time_ms(ring, warmup=1, reps=3)
        dense_ms = _time_ms(lambda: dense(q, 0), warmup=1, reps=3)
    if not torch.isfinite(got).all() or rel > RING_TOL:
        raise AssertionError(f"[ring] the fold vs dense attention: rel err {rel:.3e} "
                             f"(tol {RING_TOL})")
    return {"err": err, "rel": rel, "attn_diff": attn_diff, "lin_diff": lin_diff,
            "ring_ms": ring_ms, "dense_ms": dense_ms}


def parallel_worker(seed: int = 0) -> dict:
    """Rank body of [ring] (one NCCL rank): allgather_self_attention over
    the process group's sp axis against the dense path, then sp_prefill of
    a 4096-token prompt through GPT-2 small with RoPE under each sp_mode
    against the "full" forward, and 32 greedy tokens from its cache
    against plain generate's."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.gpt import (
        GPTConfig,
        GPTLMHeadModel,
        generate,
        generate_from_cache,
        init_gpt_,
        sp_prefill,
    )
    from sparkdl_torch.parallel.ring_attention import allgather_self_attention
    from sparkdl_torch.partition import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(dp=1, sp=dist.get_world_size())
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((2, 512, HEADS, HEAD_DIM), device="cuda", generator=g)
               for _ in range(3))
    with torch.inference_mode():
        got = allgather_self_attention(q, k, v, causal=True, mesh=mesh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(HEAD_DIM)
        keep = torch.ones((512, 512), dtype=torch.bool, device="cuda").tril()
        from sparkdl_torch.ops.flash_attention import NEG_INF

        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
            torch.where(keep, s, NEG_INF), dim=-1), v)
    out["allgather_bitwise"] = bool(torch.equal(got, want))
    cfg = GPTConfig()  # GPT-2 small widths, RoPE
    state = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=seed).state_dict()
    plain = GPTLMHeadModel(cfg, device="cuda")
    plain.load_state_dict(state)
    plain.eval()
    ids = torch.randint(0, cfg.vocab_size, (1, RING_LEN), device="cuda", generator=g)
    with torch.inference_mode():
        full = plain(ids)[0]
    want_toks = generate(plain, ids, GEN_NEW)[:, RING_LEN:]
    for mode in ("allgather", "ring"):
        model = GPTLMHeadModel(dataclasses.replace(cfg, attn_impl="ring", sp_mode=mode),
                               device="cuda")
        model.load_state_dict(state)
        model.eval()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = sp_prefill(model, ids, mesh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        toks = generate_from_cache(model, logits, cache, GEN_NEW)
        err, rel = _rel_err(logits, full)
        out[mode] = {"bitwise": bool(torch.equal(logits, full)), "err": err, "rel": rel,
                     "tokens_equal": bool(torch.equal(toks, want_toks)), "ms": ms,
                     "finite": bool(torch.isfinite(logits).all()),
                     "cache": list(cache["k"].shape)}
        del model, logits, cache
        torch.cuda.empty_cache()
    return out


def phase_parallel(card: str, attn_entry: dict, decode_entry: dict) -> dict:
    """[parallel]: model parallelism on the card. [moe] generates with a
    mixture-of-experts GPT-2 small through both flash kernels; [ring]
    checks the ring's fold at full width, the all-gather schedule's
    products, and sp_prefill over a one-rank NCCL group
    (TorchRunner(np=-1)); with two or more cards, tools/parallel4_probe.py's
    multi-rank checks run too."""
    import torch

    import chip_smoke as this  # by reference: the rank imports it
    from sparkdl_torch import TorchRunner

    t_all = time.perf_counter()
    moe = _moe_check(card)
    attn_entry["moe_launches"] = moe["attn_launches"]
    decode_entry["moe_launches"] = moe["decode_launches"]

    t0 = time.perf_counter()
    arith = _ring_arithmetic()
    r = TorchRunner(np=-1, local_platform="cuda", timeout_s=600).run(
        this.parallel_worker, seed=0)
    failures = []
    if not r["allgather_bitwise"]:
        failures.append("allgather_self_attention over the one-rank group differs from "
                        "the dense path")
    for mode in ("allgather", "ring"):
        m = r[mode]
        if not m["finite"] or m["rel"] > LOGIT_TOL:
            failures.append(f"sp_prefill {mode} logits rel err {m['rel']:.3e} (tol {LOGIT_TOL})")
        if not m["tokens_equal"]:
            failures.append(f"{GEN_NEW} greedy tokens after sp_prefill {mode} differ from "
                            "plain generate's")
    if not r["allgather"]["bitwise"]:
        failures.append("sp_prefill allgather logits not bitwise the 'full' forward's")
    if failures:
        raise AssertionError("[ring] " + "; ".join(failures))
    print(f"[ring] {card}: the ring's fold (_block_attend) at GPT-2-small width, B=1 "
          f"L={RING_LEN} causal, {RING_SHARDS} shards folded in ring order (own first, "
          f"the causal future's shards adding exp(-1e30 - m) = 0): max abs err "
          f"{arith['err']:.2e}, rel {arith['rel']:.2e} of the dense softmax (tol "
          f"{RING_TOL}), {arith['ring_ms']:.2f} ms for the 16 block folds vs "
          f"{arith['dense_ms']:.2f} ms dense (both plain torch on one card); the "
          f"all-gather schedule's products for a shard of L/{RING_SHARDS} rows vs the same "
          f"rows of the whole: attention max diff {arith['attn_diff']:.3e}; a linear "
          f"layer's [{RING_LEN // RING_SHARDS} x in]x[in x out] max diff "
          + ", ".join(f"{k} {v:.3e}" for k, v in arith["lin_diff"].items())
          + " (0 = bitwise: cuBLAS may pick another algorithm for another row count)")
    print(f"[ring] TorchRunner(np=-1) -> one {r['backend']} rank: allgather_self_attention "
          f"over its sp axis bitwise the dense path {r['allgather_bitwise']}; sp_prefill of a "
          f"{RING_LEN}-token prompt, GPT-2 small with RoPE (float32, seed 0): allgather "
          f"bitwise the 'full' forward {r['allgather']['bitwise']} ({r['allgather']['ms']:.1f} "
          f"ms host wall), ring rel err {r['ring']['rel']:.2e} ({r['ring']['ms']:.1f} ms); "
          f"cache {r['allgather']['cache']}; {GEN_NEW} greedy tokens from each cache equal to "
          f"plain generate's: allgather {r['allgather']['tokens_equal']}, ring "
          f"{r['ring']['tokens_equal']}; {time.perf_counter() - t0:.1f} s")
    count = torch.cuda.device_count()
    if count >= 2:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
        import parallel4_probe

        parallel4_probe.run_checks(card, np=min(4, count))
    else:
        print(f"[parallel] {count} card: a world of one rank (sp, tp, ep and pp of 1, every "
              "collective a no-op); the multi-rank checks need two or more cards "
              "(tools/parallel4_probe.py on four)")
    print(f"[parallel] {time.perf_counter() - t_all:.1f} s")
    return {"moe_tokens_s": moe["tokens_s"], "moe_ms": moe["moe_ms"],
            "dense_ms": moe["dense_ms"], "ring_rel": arith["rel"]}


def _dp_features(runner, feeds) -> "tuple":
    """(features [rows, 2048], seconds) of ``runner.run`` over ``feeds``."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = np.stack(list(runner.run(iter(feeds))))
    torch.cuda.synchronize()
    return feats, time.perf_counter() - t0


def _dp_generator(state, devices=None):
    """DeepTextGenerator over GPT-2 small at [generate]'s sizes; with
    ``devices``, its groups spread over that placement."""
    from sparkdl_torch import DeepTextGenerator
    from sparkdl_torch.models.gpt import GPTConfig

    class Placed(DeepTextGenerator):
        @staticmethod
        def _devices(device, batch_size):
            return list(devices)

    cls = DeepTextGenerator if devices is None else Placed
    cfg = GPTConfig(positions="learned", attn_impl="flash", flash_decode=True)
    return cls(inputCol="prompt", outputCol="gen", model=(cfg, state),
               batchSize=GEN_BATCH, maxLength=GEN_LEN, maxNewTokens=GEN_NEW)


def _dp_tokens(gen, df) -> "tuple":
    """(tokens by row id, seconds, flash forward and decode launches) of a
    transform after a warm-up one (each bucket's graph captured), every
    launch count at 0 just before it."""
    import torch

    gen.transform(df).collect()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out = gen.transform(df).collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    from sparkdl_torch.ops.flash_attention import flash_attention
    from sparkdl_torch.ops.flash_decode import flash_decode

    return ({r["id"]: r["gen"] for r in out}, secs, flash_attention.launches,
            flash_decode.launches)


def phase_dp(card: str, stem_entry: dict) -> dict:
    """[dp]: data-parallel inference in one process (BatchedRunner over a
    LocalDevicePartitioner). The featurizer with data_parallel=None, which
    on one card resolves to that card, bitwise a runner given apply_fn
    alone (one card, no replicate); a runner over ["cuda:0", "cuda:0"] (two
    replicas on one card, each with its own stream and graphs) bitwise a
    one-card runner at the shard's batch, 32, with its difference from the
    batch-64 runner printed; DeepTextGenerator over the same two
    placements, tokens equal; data_parallel=True raising on one card.
    With two or more cards, the same over min(4, count) real cards, and
    images/s and tokens/s against one card."""
    import numpy as np
    import torch

    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
    from sparkdl_torch.image import imageArrayToStructBGR
    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, init_gpt_
    from sparkdl_torch.ops.stem_fused import inception_stem_fused
    from sparkdl_torch.partition import LocalDevicePartitioner
    from sparkdl_torch.transformers._inference import BatchedRunner
    from sparkdl_torch.transformers.named_image import _named_apply, _named_model_runner

    t_all = time.perf_counter()
    count = torch.cuda.device_count()
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (N_ROWS, SIZE, SIZE, 3), dtype=np.uint8)
    feeds = [{"img": images[i].astype(np.float32)} for i in range(N_ROWS)]
    df = LocalDataFrame.from_rows(
        [{"id": i, "image": imageArrayToStructBGR(images[i])} for i in range(N_ROWS)], 1)
    n_batches = N_ROWS // BATCH

    def make(dev):
        return _named_apply("InceptionV3", "random", False, "features", dev)

    # a runner given apply_fn alone: one card, no replicate
    one = BatchedRunner(make("cuda"), batch_size=BATCH, device="cuda")
    _dp_features(one, feeds)  # warm-up: graphs
    want, one_s = _dp_features(one, feeds)

    # the entry point: the featurizer, data_parallel=None
    featurizer = DeepImageFeaturizer(inputCol="image", outputCol="features",
                                     modelName="InceptionV3", weights="random",
                                     batchSize=BATCH)
    runner = _named_model_runner("InceptionV3", "random", False, "features", BATCH, "cuda")
    featurizer.transform(df).collect()  # warm-up: graphs
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    out = featurizer.transform(df).collect()
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    feat_launches = inception_stem_fused.launches
    got = np.stack([r["features"] for r in out])
    n_use = min(count, BATCH)
    if len(runner.devices) != n_use or feat_launches != n_batches * n_use:
        raise AssertionError(
            f"featurizer placement {runner.devices}, {feat_launches} stem launches "
            f"for {n_batches} batches on {count} cards")
    failures = []
    if n_use == 1 and not np.array_equal(got, want):
        failures.append("the featurizer (data_parallel=None, one card) differs from the "
                        f"one-card runner: max abs diff {np.abs(got - want).max():.3e}")

    # two replicas on one card: bitwise a one-card runner at the shard's batch
    shard = BatchedRunner(make("cuda"), batch_size=BATCH // 2, device="cuda")
    half, _ = _dp_features(shard, feeds)
    pair = BatchedRunner(make("cuda"), batch_size=BATCH, replicate=make,
                         partitioner=LocalDevicePartitioner(["cuda:0", "cuda:0"]))
    _dp_features(pair, feeds)  # warm-up: each replica captures its graphs
    _zero_counts()
    paired, pair_s = _dp_features(pair, feeds)
    pair_launches = inception_stem_fused.launches
    if pair_launches != 2 * n_batches:
        failures.append(f"two replicas: {pair_launches} stem launches for "
                        f"{n_batches} batches")
    if not np.array_equal(paired, half):
        failures.append("two replicas on one card differ from the batch-32 runner: max "
                        f"abs diff {np.abs(paired - half).max():.3e}")
    scale = float(np.abs(want).max())
    pair_vs_64 = float(np.abs(paired - want).max())
    if pair_vs_64 / scale > NET_TOL:
        failures.append(f"two replicas vs the batch-64 runner: rel {pair_vs_64 / scale:.3e}")
    try:
        BatchedRunner(make("cuda"), batch_size=BATCH, data_parallel=True, replicate=make)
        raised = "no error"
    except ValueError as e:
        raised = str(e)
    if count == 1 and "only one local device" not in raised:
        failures.append(f"data_parallel=True on one card: {raised}")

    # DeepTextGenerator over the same placements
    cfg = GPTConfig(positions="learned", attn_impl="flash", flash_decode=True)
    state = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
    grng = np.random.default_rng(6)
    prompts = [grng.integers(0, cfg.vocab_size, n).tolist()
               for n in grng.integers(8, GEN_LEN + 1, GEN_ROWS)]
    gdf = LocalDataFrame.from_rows([{"id": i, "prompt": p} for i, p in enumerate(prompts)],
                                   N_PARTS)
    base, base_s, base_attn, base_decode = _dp_tokens(_dp_generator(state, ["cuda"]), gdf)
    auto, auto_s, _, _ = _dp_tokens(_dp_generator(state), gdf)
    two, two_s, two_attn, two_decode = _dp_tokens(
        _dp_generator(state, ["cuda:0", "cuda:0"]), gdf)
    n_tok = GEN_ROWS * GEN_NEW
    for label, toks in (("data_parallel=None", auto), ('["cuda:0", "cuda:0"]', two)):
        if toks != base:
            bad = sum(toks[i] != base[i] for i in base)
            failures.append(f"DeepTextGenerator over {label}: {bad} of {GEN_ROWS} rows' "
                            "tokens differ from the one-card run's")
    if not (two_attn and two_decode):
        failures.append(f"two replicas: flash forward {two_attn}, decode {two_decode} "
                        "launches")
    if failures:
        raise AssertionError("[dp] " + "; ".join(failures))
    stem_entry["dp_launches"] = pair_launches
    print(f"[dp] {card}: {count} card(s). DeepImageFeaturizer(InceptionV3), data_parallel="
          f"None over {N_ROWS} rows, batch {BATCH}: {len(runner.devices)} card(s) "
          f"{[str(d) for d in runner.devices]}, {feat_launches} stem launches, "
          + ("bitwise the one-card runner given apply_fn alone (no replicate)"
             if n_use == 1 else "")
          + f"; {N_ROWS / feat_s:.1f} images/s through the transform")
    print(f"[dp] runner over [\"cuda:0\", \"cuda:0\"] (two replicas, own streams and "
          f"graphs): bitwise the one-card runner at batch {BATCH // 2} True; max diff "
          f"from the batch-{BATCH} runner {pair_vs_64:.3e} ({pair_vs_64 / scale:.3e} of "
          f"the largest feature, {scale:.3e}); {pair_launches} stem launches for "
          f"{n_batches} batches (one a replica); runner.run {N_ROWS / pair_s:.1f} images/s "
          f"vs one replica {N_ROWS / one_s:.1f}; data_parallel=True here: {raised[:70]!r}")
    print(f"[dp] DeepTextGenerator GPT-2 small ({GEN_ROWS} prompts of 8-{GEN_LEN} tokens, "
          f"batch {GEN_BATCH}, {GEN_NEW} greedy tokens, flash): one card "
          f"{n_tok / base_s:.1f} tokens/s; data_parallel=None tokens equal, "
          f"{n_tok / auto_s:.1f} tokens/s; two replicas on cuda:0 tokens equal, "
          f"{n_tok / two_s:.1f} tokens/s, flash forward {two_attn} / decode "
          f"{two_decode} launches (one card {base_attn} / {base_decode})")
    out = {"images_s": N_ROWS / feat_s, "one_images_s": N_ROWS / one_s,
           "pair_images_s": N_ROWS / pair_s, "tokens_s": n_tok / auto_s,
           "one_tokens_s": n_tok / base_s, "cards": n_use}
    if n_use > 1:
        # each card's shard is bitwise a one-card runner at batch B/n
        shard_n = BatchedRunner(make("cuda"), batch_size=BATCH // n_use, device="cuda")
        at_shard, _ = _dp_features(shard_n, feeds)
        _, dp_s = _dp_features(runner, feeds)
        out["run_images_s"] = N_ROWS / dp_s
        diff = float(np.abs(got - want).max())
        if not np.array_equal(got, at_shard):
            raise AssertionError(
                f"[dp] {n_use} cards differ from the one-card runner at batch "
                f"{BATCH // n_use}: max abs diff {np.abs(got - at_shard).max():.3e}")
        print(f"[dp] {n_use} cards: the featurizer bitwise the one-card runner at batch "
              f"{BATCH // n_use} True; max diff from the batch-{BATCH} runner {diff:.3e} "
              f"({diff / scale:.3e} of the largest feature); runner.run images/s "
              f"{N_ROWS / dp_s:.1f} vs one card {N_ROWS / one_s:.1f} = "
              f"{one_s / dp_s:.2f}x (the transform, host extract included, "
              f"{N_ROWS / feat_s:.1f}); tokens/s {n_tok / auto_s:.1f} vs one card "
              f"{n_tok / base_s:.1f} = {base_s / auto_s:.2f}x; {card}")
    print(f"[dp] {time.perf_counter() - t_all:.1f} s")
    return out


def phase_train_resnet(card: str, gemm_entry: dict) -> float:
    """The fused ResNet50 train step (bench_train.py's recipe) at 224 px,
    batch 64, as a CUDA graph: against the eager step (bitwise) and
    against make_vision_train_step over the plain module."""
    import copy

    import numpy as np
    import torch

    from sparkdl_torch.models.common import init_zoo_
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.models.resnet_fused import bn_train_launches
    from sparkdl_torch.ops.bn_train import batch_moments, bn_train_apply, bn_train_backward
    from sparkdl_torch.ops.fused_gemm_bn import gemm_bn_stats
    from sparkdl_torch.train.vision import (
        _make_step,
        make_resnet50_fused_train_step,
        make_vision_train_step,
        resnet50_fused_loss_fn,
    )

    base = init_zoo_(ResNet50(num_classes=1000), seed=0)  # built on the card
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.random((RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3),
                                    dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).cuda()

    def fresh(kind):
        m = copy.deepcopy(base)
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        if kind == "fused":
            step = make_resnet50_fused_train_step(m, opt, num_classes=1000,
                                                  dtype=torch.float32)
        elif kind == "eager":
            step = _make_step(m, resnet50_fused_loss_fn(m, num_classes=1000,
                                                        dtype=torch.float32), opt)
        else:
            step = make_vision_train_step(m, opt)
        return m, step

    def state(m):
        return ([p.detach().clone() for p in m.parameters()],
                [b.clone() for b in m.buffers()])

    # fused against plain from the same start: losses, stats after step 1
    runs = {}
    for kind in ("fused", "plain"):
        m, step = fresh(kind)
        losses = [float(step(x, y))]
        stats = {n: (b.running_mean.clone(), b.running_var.clone())
                 for n, b in m.named_modules() if isinstance(b, torch.nn.BatchNorm2d)}
        losses += [float(step(x, y)) for _ in range(2)]
        runs[kind] = (losses, stats)
        del m, step
        torch.cuda.empty_cache()
    (lf, sf), (lp, sp) = runs["fused"], runs["plain"]
    loss_rel = abs(lf[0] - lp[0]) / abs(lp[0])
    stat_err = max(float(((a - b).abs() - 1e-3 * b.abs()).max())
                   for n in sp for a, b in zip(sf[n], sp[n]))
    track = max(abs(f - p) / abs(p) for f, p in zip(lf, lp))
    if not np.isfinite(lf).all() or loss_rel > 1e-3 or stat_err > 1e-4 or track > 0.15:
        raise AssertionError(
            f"fused vs plain ResNet50 step: first loss rel {loss_rel:.3e} (tol 1e-3), "
            f"stats |a-b| - 1e-3|b| {stat_err:.3e} (tol 1e-4), losses {lf} vs {lp}")

    # the graphed step against the eager one over RESNET_STEPS steps, under
    # deterministic algorithms: losses, parameters and BN statistics bitwise
    with _deterministic():
        runs = {}
        for kind in ("eager", "fused"):
            m, step = fresh(kind)
            losses = [float(step(x, y)) for _ in range(RESNET_STEPS)]
            runs[kind] = (losses, *state(m))
            del m, step
            torch.cuda.empty_cache()
    (le, pe, be), (lg, pg, bg) = runs["eager"], runs["fused"]
    same = (le == lg, all(map(torch.equal, pe, pg)), all(map(torch.equal, be, bg)))
    if not all(same):
        raise AssertionError(f"graphed fused step vs eager: losses, parameters, BN "
                             f"statistics equal {same} (want all bitwise); {lg} vs {le}")
    del runs, pe, pg, be, bg

    # the main path: the graphed fused step, timed (default algorithms)
    module, step = fresh("fused")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(RESNET_STEPS)]  # the first captures
    torch.cuda.synchronize()
    first_secs = time.perf_counter() - t0
    launches = gemm_bn_stats.launches
    if launches != 25 * RESNET_STEPS:
        raise AssertionError(f"gemm_bn_stats launched {launches} times in "
                             f"{RESNET_STEPS} steps, want 25 a step")
    bn_want = {k: len(v) for k, v in bn_train_launches(RESNET_BATCH, RESNET_SIZE).items()}
    bn_got = {"moments": batch_moments.launches, "apply": bn_train_apply.launches,
              "backward": bn_train_backward.launches}
    if any(bn_got[k] != bn_want[k] * RESNET_STEPS for k in bn_want):
        raise AssertionError(f"bn_train launched {bn_got} in {RESNET_STEPS} steps, want "
                             f"{bn_want} a step")
    losses = [float(t) for t in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"ResNet50 losses not finite: {losses}")
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        step(x, y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    graph_dev = _time_ms(lambda: step(x, y), warmup=1, reps=5)
    graph = step.graphs.graphs()[0]

    timing = {}
    for kind in ("eager", "plain"):
        m, other = fresh(kind)
        other(x, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RESNET_STEPS):
            other(x, y)
        torch.cuda.synchronize()
        timing[kind] = (time.perf_counter() - t0) / RESNET_STEPS
        if kind == "eager":
            eager_step = other
        else:
            del m, other
            torch.cuda.empty_cache()

    groups = {"fused 1x1 kernel": ("gemm_bn_kernel", "stats_reduce_kernel"),
              "BatchNorm kernels": ("bn_train_",),
              "cuDNN convs": ("cudnn", "conv", "implicit", "wgrad", "dgrad", "xmma",
                              "sm90", "sm80")}
    eager_times = _kernel_times(lambda: eager_step(x, y), reps=1)
    step_ms = secs / RESNET_STEPS * 1e3
    print(f"[train_resnet] make_resnet50_fused_train_step ResNet50 {RESNET_SIZE} px, "
          f"B={RESNET_BATCH}, 1000 classes, float32, SGD 0.1 momentum 0.9, random init "
          f"seed 0, one CUDA graph a step; {card}: {RESNET_BATCH * RESNET_STEPS / secs:.1f} "
          f"images/s, step {step_ms:.2f} ms host-driven ({graph_dev:.2f} ms device, CUDA "
          f"events around a replay; {first_secs:.2f} s for the first {RESNET_STEPS} "
          f"steps, capture {graph.capture_s * 1e3:.0f} ms, pool "
          f"{graph.pool_bytes / 2**20:.0f} MB); eager fused step {timing['eager'] * 1e3:.2f} "
          f"ms host-driven ({sum(eager_times.values()):.2f} ms of kernels), plain step "
          f"{timing['plain'] * 1e3:.2f} ms (graphed), "
          f"{RESNET_BATCH / timing['plain']:.1f} images/s; gemm_bn_stats "
          f"launches {launches} = 25 x {RESNET_STEPS}, bn_train {bn_got} = {bn_want} x "
          f"{RESNET_STEPS} ({_launch_names(graph.launches)} a replay); graphed vs eager over {RESNET_STEPS} steps under deterministic "
          f"algorithms: losses, parameters and BN statistics bitwise; vs the plain step: "
          f"first loss rel {loss_rel:.1e} (tol 1e-3), BN stats after step 1 within atol "
          f"1e-4 + rtol 1e-3 (worst excess {stat_err:.1e}), 3 losses "
          f"{', '.join(f'{v:.4f}' for v in lf)} vs {', '.join(f'{v:.4f}' for v in lp)} "
          f"(worst {track:.1%}, tol 15%); losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"[train_resnet] profile of one eager fused step: {_breakdown(eager_times, groups)}")
    gemm_entry["launches"] = launches
    del module, step, graph, eager_step
    torch.cuda.empty_cache()
    return RESNET_BATCH * RESNET_STEPS / secs


ZOO_MODELS = ("ResNet50", "Xception", "VGG16", "VGG19", "ViTB16")
ZOO_TOL = 1e-4        # card vs CPU, the same module: cuDNN's and oneDNN's algorithms differ
VIT_TOL = 1e-4        # 12 layers of f32 on both sides, attention sums reordered
TEXT_TOL = 1e-4
TEXT_ROWS, TEXT_LEN, TEXT_BATCH = 256, 128, 64
HPO_STEPS, HPO_BATCH = 5, 32


def _release_cached_paths() -> str:
    """Drop the per-process caches of models, runners and CUDA graphs that
    the transformers keep (named-image runners, the generator's graphs,
    the text featurizer's runners), collect their reference cycles and
    return the memory to the card; then reset the peak. Says what was
    reserved before and after."""
    import gc

    import torch

    from sparkdl_torch.transformers import named_image, text, text_generator

    before = torch.cuda.memory_reserved()
    named_image._named_model_runner.cache_clear()
    named_image._load_named_model.cache_clear()
    text_generator.GENERATE_GRAPHS.clear()
    text_generator._MODEL_CACHE.clear()
    text._RUNNER_CACHE.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free, total = torch.cuda.mem_get_info()
    return (f"{before / 2**30:.1f} -> {torch.cuda.memory_reserved() / 2**30:.1f} GiB "
            f"reserved, {free / 2**30:.1f} of {total / 2**30:.1f} GiB free")


def _image_rows(rng, size: int):
    """(uint8 images [N_ROWS, size, size, 3], their BGR structs)."""
    import numpy as np

    from sparkdl_torch.image import imageArrayToStructBGR

    images = rng.integers(0, 256, (N_ROWS, size, size, 3), dtype=np.uint8)
    return images, [{"id": i, "image": imageArrayToStructBGR(images[i])}
                    for i in range(N_ROWS)]


def phase_zoo(card: str) -> dict:
    """DeepImageFeaturizer and DeepImagePredictor over every other zoo model
    at full width and depth (random weights, seed 0), batch 64, over 256
    random rows at the model's input size in 4 partitions: two rows'
    features against the same module on the CPU, the probabilities'
    shape and sums, images/s (median of TIME_REPS transforms after a
    warm-up) and the forward's device ms a batch (CUDA events). The
    convolutions and dense layers are cuDNN/cuBLAS: no kernel of the
    port runs here (ViTB16's registry entry attends with attn_impl
    "full")."""
    import copy

    import numpy as np
    import torch

    from sparkdl_torch import DeepImageFeaturizer, DeepImagePredictor, LocalDataFrame
    from sparkdl_torch.models.registry import get_entry
    from sparkdl_torch.ops.preprocess import PREPROCESSORS
    from sparkdl_torch.transformers import named_image

    held = _release_cached_paths()
    rng = np.random.default_rng(3)
    by_size, rates, report = {}, {}, []
    for name in ZOO_MODELS:
        entry = get_entry(name)
        size = entry.input_size[0]
        if size not in by_size:
            by_size.clear()
            by_size[size] = _image_rows(rng, size)
        images, rows = by_size[size]
        df = LocalDataFrame.from_rows(rows, N_PARTS)
        kw = dict(inputCol="image", outputCol="out", modelName=name, weights="random",
                  batchSize=BATCH)
        featurizer, predictor = DeepImageFeaturizer(**kw), DeepImagePredictor(**kw)

        t0 = time.perf_counter()
        featurizer.transform(df).collect()  # warm-up: the model, graphs, cuDNN plans
        first_s = time.perf_counter() - t0
        secs = []
        for _ in range(TIME_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = featurizer.transform(df).collect()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        feats = np.stack([r["out"] for r in sorted(out, key=lambda r: r["id"])])
        if feats.shape != (N_ROWS, entry.feature_dim) or not np.isfinite(feats).all():
            raise AssertionError(f"[zoo] {name}: bad features {feats.shape}")
        predictor.transform(df).collect()
        probs = np.stack([r["out"] for r in predictor.transform(df).collect()])
        sums = probs.sum(axis=1)
        if probs.shape != (N_ROWS, 1000) or np.abs(sums - 1).max() > 1e-4:
            raise AssertionError(f"[zoo] {name}: probabilities {probs.shape}, sums "
                                 f"{sums.min():.6f}..{sums.max():.6f}")

        # two rows against the same module on the CPU
        top = entry.features_need_top
        module = named_image._load_named_model(name, "random", top, "cuda")
        preprocess = PREPROCESSORS[entry.preprocess]
        x = torch.from_numpy(images[:2].astype(np.float32))
        with torch.inference_mode():
            want, _ = copy.deepcopy(module).cpu()(preprocess(x))
            xd = preprocess(torch.from_numpy(images[:BATCH].astype(np.float32)).cuda())
            fwd_ms = _time_ms(lambda: module(xd), warmup=2, reps=5)
        abs_err, rel = _rel_err(torch.from_numpy(feats[:2]), want)
        if rel > ZOO_TOL:
            raise AssertionError(f"[zoo] {name}: card vs CPU rel err {rel:.3e} "
                                 f"(tol {ZOO_TOL})")
        rates[name] = N_ROWS / statistics.median(secs)
        report.append(
            f"{name} {size} px: {rates[name]:.1f} images/s (median of {TIME_REPS}; "
            f"min {N_ROWS / max(secs):.1f}, max {N_ROWS / min(secs):.1f}; first "
            f"transform {first_s:.1f} s), forward {fwd_ms:.2f} ms a batch of {BATCH} "
            f"(CUDA events), features {entry.feature_dim} vs CPU rel err {rel:.1e}, "
            f"probs sum 1 within {np.abs(sums - 1).max():.1e}")
        report[-1] += f", peak {torch.cuda.max_memory_reserved() / 2**30:.1f} GiB reserved"
        del module, xd, featurizer, predictor
        _release_cached_paths()
    print(f"[zoo] DeepImageFeaturizer / DeepImagePredictor, random init seed 0, "
          f"{N_ROWS} rows in {N_PARTS} partitions, batchSize {BATCH}, features vs "
          f"the same module on the CPU for 2 rows (tol {ZOO_TOL}); the earlier "
          f"paths' cached models and graphs released first ({held}); {card}: "
          + "; ".join(report))
    return rates


ZOO_BF16_TOL = 2.0 ** -5  # bf16 activations and operands vs float32, ~94 convs / 12 layers
KERAS_TOL = 1e-4          # the same float32 ResNet50 as two torch programs, card and CPU


def _operand_dtypes(fn) -> dict:
    """{op: dtypes of its floating operands} for the convolutions and
    matrix products dispatched by one call of ``fn``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = {"conv2d", "convolution", "linear", "matmul", "mm", "addmm", "bmm"}
    seen: dict = {}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ops:
                for a in args:
                    if isinstance(a, torch.Tensor) and a.is_floating_point():
                        seen.setdefault(name, set()).add(str(a.dtype).split(".")[-1])
            return func(*args, **(kwargs or {}))

    with Mode():
        fn()
    return {k: sorted(v) for k, v in seen.items()}


def _zoo_bf16_kernel_checks(x, stem_params, vit_bf16, xv, rng) -> list:
    """The bf16 builds that [zoo_bf16] launches, each against its plain
    version on the path's own inputs: the stem's f32-pixels->bf16 build on
    the B=64, 299 px batch within STEM_BF16_TOL, and the flash forward's
    bf16 build, unmasked at L=197 (three full 64-key tiles and a ragged
    5), on the q/k/v that each of ViT-B/16's layers gives it and on
    unit-normal q/k/v of that shape (a sharper softmax), within BF16_TOL
    of max |ref|. These launches come before the counted forwards."""
    import numpy as np
    import torch

    import sparkdl_torch.models.vit as vit_module
    from sparkdl_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from sparkdl_torch.ops.stem_fused import inception_stem_fused, stem_reference

    bf16 = torch.bfloat16
    with torch.inference_mode():
        got = inception_stem_fused(x, stem_params, dtype=bf16)
        want = stem_reference(x, stem_params).to(bf16)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"[zoo_bf16] stem f32->bf16: bad output {tuple(got.shape)}")
        _, stem_rel = _rel_err(got, want)
        if stem_rel > STEM_BF16_TOL:
            raise AssertionError(f"[zoo_bf16] stem f32->bf16 B={x.shape[0]}: rel err "
                                 f"{stem_rel:.3e} > {STEM_BF16_TOL}")

        seen = []  # every layer's (q, k, v, args, kwargs) of one bf16 forward

        def record(q, k, v, *args, **kwargs):
            seen.append((q, k, v, args, kwargs))
            return flash_attention(q, k, v, *args, **kwargs)

        vit_module.flash_attention = record
        try:
            vit_bf16(xv)
        finally:
            vit_module.flash_attention = flash_attention
        q0 = seen[0][0]
        normal = tuple(torch.from_numpy(rng.standard_normal(
            tuple(q0.shape), dtype=np.float32)).cuda().to(bf16) for _ in "qkv")
        cases = seen + [normal + ((), {})]
        worst = 0.0
        for i, (q, k, v, args, kwargs) in enumerate(cases):
            got = flash_attention(q, k, v, *args, **kwargs)
            want = flash_attention_reference(q, k, v, *args, **kwargs)
            torch.cuda.synchronize()
            what = f"layer {i}" if i < len(seen) else "unit-normal q/k/v"
            if (q.dtype != bf16 or got.shape != want.shape
                    or not torch.isfinite(got.float()).all()):
                raise AssertionError(f"[zoo_bf16] flash_attention {what}: bad output or "
                                     f"dtype {q.dtype}")
            _, rel = _rel_err(got, want)
            if rel > BF16_TOL:
                raise AssertionError(f"[zoo_bf16] flash_attention bf16 {what} "
                                     f"{tuple(q.shape)}: rel err {rel:.3e} > {BF16_TOL}")
            worst = max(worst, rel)
    return [f"stem f32->bf16 B={x.shape[0]} {x.shape[1]} px rel err {stem_rel:.2e} "
            f"(tol {STEM_BF16_TOL})",
            f"flash_attention bf16 {list(q0.shape)} unmasked, {len(seen)} layers' q/k/v "
            f"and unit-normal q/k/v: worst rel err {worst:.2e} (tol {BF16_TOL})"]


def _dispatched_ops(fn) -> int:
    """The count of ATen ops that one call of ``fn`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count[0] += 1
            return func(*args, **(kwargs or {}))

    with Mode():
        fn()
    return count[0]


def phase_zoo_bf16(card: str, stem_entry: dict, attn_entry: dict) -> dict:
    """The zoo at dtype=bfloat16 on the card, full width and depth, random
    weights (seed 0), batch 64: InceptionV3's branch-merged forward at 299
    px (the stem kernel writing bf16) and ViT-B/16 at 224 px with
    attn_impl="flash" (the flash forward's bf16 instantiation), each held
    against the same weights' float32 forward within ZOO_BF16_TOL of
    max |f32|. Before that, each kernel's bf16 build is held against its
    plain version on this path's own inputs (_zoo_bf16_kernel_checks).
    Each bf16 forward must launch its kernel (counts zeroed just before
    it), keep its parameters float32 and give every convolution and matrix
    product bfloat16 operands, as the JAX package rounds. Prints the
    errors and the device ms a batch in both dtypes."""
    import numpy as np
    import torch

    from sparkdl_torch.models.inception_fused import (
        fused_inception_v3_features,
        prepare_fused_inception_v3,
    )
    from sparkdl_torch.models.registry import build_torch_model
    from sparkdl_torch.models.vit import ViTConfig, ViTModel
    from sparkdl_torch.ops.flash_attention import flash_attention
    from sparkdl_torch.ops.fold import fold_tf_preprocess
    from sparkdl_torch.ops.preprocess import preprocess_tf
    from sparkdl_torch.ops.stem_fused import inception_stem_fused

    bf16 = torch.bfloat16
    rng = np.random.default_rng(7)
    inception = build_torch_model("InceptionV3", "random", include_top=False, seed=0)
    params = prepare_fused_inception_v3(fold_tf_preprocess(inception.state_dict()))
    x = torch.from_numpy(rng.integers(0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.float32)).cuda()
    cfg = ViTConfig.b16(attn_impl="flash")
    weights = build_torch_model("ViTB16", "random", include_top=False, seed=0).state_dict()
    vit = {}
    for dt in (torch.float32, bf16):
        vit[dt] = ViTModel(cfg, include_top=False, dtype=dt)
        vit[dt].load_state_dict(weights)
        vit[dt] = vit[dt].cuda().eval()
    xv = preprocess_tf(torch.from_numpy(rng.integers(
        0, 256, (BATCH, cfg.image_size, cfg.image_size, 3)).astype(np.float32)).cuda())
    paths = {
        "InceptionV3": (lambda dt: fused_inception_v3_features(params, x, dtype=dt),
                        inception_stem_fused, 1, SIZE, stem_entry),
        "ViTB16": (lambda dt: vit[dt](xv)[0], flash_attention, cfg.num_layers,
                   cfg.image_size, attn_entry),
    }
    f32_params = all(p.dtype == torch.float32 for p in vit[bf16].parameters()) and all(
        w.dtype == torch.float32 for w, _ in params["convs"].values())
    if not f32_params:
        raise AssertionError("[zoo_bf16] parameters are not float32")
    kernel_report = _zoo_bf16_kernel_checks(x, params["stem"], vit[bf16], xv, rng)
    out, report = {}, []
    for name, (fwd, kernel, want_launches, size, entry) in paths.items():
        with torch.inference_mode():
            want = fwd(torch.float32)
            torch.cuda.synchronize()
            _zero_counts()
            got = fwd(bf16)
            torch.cuda.synchronize()
            launches = kernel.launches
            operands = _operand_dtypes(lambda: fwd(bf16))
            ms = {dt: _time_ms(lambda dt=dt: fwd(dt), warmup=2, reps=10)
                  for dt in (torch.float32, bf16)}
        if launches != want_launches:
            raise AssertionError(f"[zoo_bf16] {name}: {kernel.__name__} launched "
                                 f"{launches} times in one bf16 forward, want {want_launches}")
        if not operands or any(v != ["bfloat16"] for v in operands.values()):
            raise AssertionError(f"[zoo_bf16] {name}: operand dtypes {operands}")
        abs_err, rel = _rel_err(got, want)
        if got.shape != want.shape or not torch.isfinite(got).all() or rel > ZOO_BF16_TOL:
            raise AssertionError(f"[zoo_bf16] {name}: bf16 vs float32 rel err {rel:.3e} "
                                 f"(tol {ZOO_BF16_TOL})")
        entry["zoo_bf16_launches"] = launches
        out[name] = {"rel_err": rel, "f32_ms": ms[torch.float32], "bf16_ms": ms[bf16],
                     "launches": launches}
        report.append(
            f"{name} {size} px: bf16 vs float32 features max|diff| {abs_err:.3e} = "
            f"{rel:.2e} of max|f32| (tol {ZOO_BF16_TOL}); {kernel.__name__} launches "
            f"{launches} a bf16 forward; operands {operands}; forward "
            f"{ms[torch.float32]:.2f} ms float32, {ms[bf16]:.2f} ms bf16 a batch "
            f"(CUDA events)")
    print(f"[zoo_bf16] kernels against their plain versions on this path's inputs: "
          + "; ".join(kernel_report))
    print(f"[zoo_bf16] dtype=bfloat16 zoo, random init seed 0, B={BATCH}, parameters "
          f"float32: " + "; ".join(report) + f"; {card}")
    del inception, params, vit, x, xv
    torch.cuda.empty_cache()
    return out


def _keras_entry(cls: str, name: str, inputs: list, **config) -> dict:
    """One layer of a Keras 3 functional config: ``inputs`` are the names
    of the layers whose (single) outputs it is called on."""
    tensors = [{"class_name": "__keras_tensor__",
                "config": {"keras_history": [src, 0, 0]}} for src in inputs]
    args = [tensors] if len(tensors) > 1 else tensors
    return {"class_name": cls, "name": name, "config": {"name": name, **config},
            "inbound_nodes": [{"args": args, "kwargs": {}}] if inputs else []}


def resnet50_keras_graph(seed: int = 0, size: int = 224):
    """keras.applications.ResNet50(include_top=False, pooling="avg") as a
    KerasGraph written in code: Keras' layer names, order, configs and
    connections (``conv1_pad``, ``conv1_conv``, ``conv1_bn``, ...,
    ``conv5_block3_out``, ``avg_pool``), with seeded numpy weights
    (lecun-scaled kernels, BN statistics away from 0/1). Needs no Keras."""
    import numpy as np

    from sparkdl_torch.models.keras_loader import KerasGraph

    rng = np.random.default_rng(seed)
    layers, weights = [], {}

    def add(cls, name, inputs, **config):
        layers.append(_keras_entry(cls, name, inputs, **config))
        return name

    def conv(name, src, cin, filters, k, stride=1, padding="valid"):
        weights[name] = [
            (rng.standard_normal((k, k, cin, filters)) / np.sqrt(k * k * cin)).astype(np.float32),
            (0.1 * rng.standard_normal(filters)).astype(np.float32)]
        return add("Conv2D", name, [src], filters=filters, kernel_size=[k, k],
                   strides=[stride, stride], padding=padding, data_format="channels_last",
                   dilation_rate=[1, 1], groups=1, activation="linear", use_bias=True)

    def bn(name, src, c):
        weights[name] = [(1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
                         (0.1 * rng.standard_normal(c)).astype(np.float32),
                         (0.1 * rng.standard_normal(c)).astype(np.float32),
                         (0.5 + rng.random(c)).astype(np.float32)]
        return add("BatchNormalization", name, [src], axis=3, momentum=0.99,
                   epsilon=1.001e-5, center=True, scale=True)

    def relu(name, src):
        return add("Activation", name, [src], activation="relu")

    add("InputLayer", "input_layer", [], batch_shape=[None, size, size, 3])
    add("ZeroPadding2D", "conv1_pad", ["input_layer"], padding=[[3, 3], [3, 3]],
        data_format="channels_last")
    relu("conv1_relu", bn("conv1_bn", conv("conv1_conv", "conv1_pad", 3, 64, 7, 2), 64))
    add("ZeroPadding2D", "pool1_pad", ["conv1_relu"], padding=[[1, 1], [1, 1]],
        data_format="channels_last")
    x = add("MaxPooling2D", "pool1_pool", ["pool1_pad"], pool_size=[3, 3], padding="valid",
            strides=[2, 2], data_format="channels_last")
    cin = 64
    for stage, (filters, blocks, stride) in enumerate(
            ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)), start=2):
        for b in range(1, blocks + 1):
            p, s = f"conv{stage}_block{b}", (stride if b == 1 else 1)
            h = relu(f"{p}_1_relu", bn(f"{p}_1_bn", conv(f"{p}_1_conv", x, cin, filters, 1, s),
                                       filters))
            h = relu(f"{p}_2_relu", bn(f"{p}_2_bn", conv(f"{p}_2_conv", h, filters, filters, 3,
                                                         1, "same"), filters))
            if b == 1:  # Keras' order: the shortcut's conv, the closing conv, their BNs
                short = conv(f"{p}_0_conv", x, cin, 4 * filters, 1, s)
            h = conv(f"{p}_3_conv", h, filters, 4 * filters, 1)
            if b == 1:
                short = bn(f"{p}_0_bn", short, 4 * filters)
            else:
                short = x
            h = bn(f"{p}_3_bn", h, 4 * filters)
            x = relu(f"{p}_out", add("Add", f"{p}_add", [short, h]))
            cin = 4 * filters
    add("GlobalAveragePooling2D", "avg_pool", [x], data_format="channels_last",
        keepdims=False)
    config = {"name": "resnet50", "trainable": True, "layers": layers,
              "input_layers": ["input_layer", 0, 0], "output_layers": ["avg_pool", 0, 0]}
    return KerasGraph(config=config, weights=weights)


def _small_keras_graph(seed: int, size: int, classes: int):
    """A small Keras image classifier as a KerasGraph in code: Conv2D 3x3
    same -> BatchNormalization (momentum 0.5) -> ReLU -> global average
    pool -> Dense softmax."""
    import numpy as np

    from sparkdl_torch.models.keras_loader import KerasGraph

    rng = np.random.default_rng(seed)
    layers = [
        _keras_entry("InputLayer", "input", [], batch_shape=[None, size, size, 3]),
        _keras_entry("Conv2D", "conv", ["input"], filters=16, kernel_size=[3, 3],
                     strides=[1, 1], padding="same", activation="linear", use_bias=True),
        _keras_entry("BatchNormalization", "bn", ["conv"], axis=-1, momentum=0.5,
                     epsilon=1e-3),
        _keras_entry("ReLU", "relu", ["bn"]),
        _keras_entry("GlobalAveragePooling2D", "pool", ["relu"]),
        _keras_entry("Dense", "head", ["pool"], units=classes, activation="softmax"),
    ]
    weights = {
        "conv": [(rng.standard_normal((3, 3, 3, 16)) / np.sqrt(27)).astype(np.float32),
                 np.zeros(16, np.float32)],
        "bn": [np.ones(16, np.float32), np.zeros(16, np.float32),
               np.zeros(16, np.float32), np.ones(16, np.float32)],
        "head": [(rng.standard_normal((16, classes)) / 4).astype(np.float32),
                 np.zeros(classes, np.float32)],
    }
    return KerasGraph(config={"name": "small", "layers": layers,
                              "input_layers": ["input", 0, 0],
                              "output_layers": ["head", 0, 0]}, weights=weights)


def phase_keras(card: str) -> dict:
    """The Keras side without Keras (this machine has none): ResNet50's
    layer graph as keras.applications names it, written as a KerasGraph
    in code with seeded weights. registerKerasImageUDF (BASELINE config 3)
    scores 256 random image rows at 224 px through it on the card, one
    row a call through applyUDF over 4 partitions (caffe preprocessing as
    the UDF's torch preprocessor): rows/s after a warm-up of 8 rows. The
    same graph goes through the zoo converter into the port's ResNet50;
    the UDF's outputs are held against the zoo module's on the card (all
    rows) and against the graph module on the CPU (two rows), within
    KERAS_TOL of max |ref|. Where a row's time goes, measured right after
    the UDF's run: the graph module's forward on one device row with its
    result's readback, as the UDF calls it (host clock, median of 25),
    its device time (CUDA-graph replays) and the ATen ops it dispatches.
    Then the estimator's torch training loop runs
    one epoch (Adam, categorical crossentropy, batch 8, shuffled) over a
    small Conv-BN-Dense graph on the card: the loss must be finite and
    fall. No kernel of the port runs here (cuDNN/cuBLAS)."""
    import copy
    import importlib.util

    import numpy as np
    import torch

    from sparkdl_torch import LocalDataFrame, registerKerasImageUDF
    from sparkdl_torch.estimators.keras_image_file_estimator import (
        fit_keras_graph,
        keras_loss,
    )
    from sparkdl_torch.models.keras_graph import KerasGraphModule
    from sparkdl_torch.models.keras_loader import load_keras_weights
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.ops.preprocess import preprocess_caffe
    from sparkdl_torch.udf import applyUDF

    graph = resnet50_keras_graph(seed=0)
    rng = np.random.default_rng(8)
    images, rows = _image_rows(rng, 224)
    registerKerasImageUDF("resnet50_keras", graph, preprocessor=preprocess_caffe)
    applyUDF("resnet50_keras", LocalDataFrame.from_rows(rows[:8], 1), "image",
             "scores").collect()  # warm-up: cuDNN plans
    df = LocalDataFrame.from_rows(rows, N_PARTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = applyUDF("resnet50_keras", df, "image", "scores").collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    row_module = KerasGraphModule(graph, device="cuda").eval()
    with torch.inference_mode():
        x1 = preprocess_caffe(torch.from_numpy(images[:1].astype(np.float32)).cuda())
        walls = []
        for _ in range(28):
            t1 = time.perf_counter()
            row_module(x1).cpu()
            walls.append(time.perf_counter() - t1)
        row_host_ms = sorted(walls[3:])[len(walls[3:]) // 2] * 1e3
        row_ops = _dispatched_ops(lambda: row_module(x1))
        row_device_ms = _device_ms(lambda: row_module(x1), calls=5, reps=5)
    got = torch.from_numpy(np.stack([r["scores"] for r in out]))
    if got.shape != (N_ROWS, 2048) or not torch.isfinite(got).all():
        raise AssertionError(f"[keras] UDF outputs {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")

    zoo = load_keras_weights(ResNet50(include_top=False, device="cpu"), graph, "topo")
    zoo = zoo.cuda().eval()
    cpu = KerasGraphModule(graph, device="cpu").eval()
    with torch.inference_mode():
        x = preprocess_caffe(torch.from_numpy(images.astype(np.float32)).cuda())
        want = torch.cat([zoo(x[i:i + BATCH])[0] for i in range(0, N_ROWS, BATCH)]).cpu()
        want_cpu = cpu(preprocess_caffe(torch.from_numpy(images[:2].astype(np.float32))))
    _, rel_zoo = _rel_err(got, want)
    _, rel_cpu = _rel_err(got[:2], want_cpu)
    if rel_zoo > KERAS_TOL or rel_cpu > KERAS_TOL:
        raise AssertionError(f"[keras] UDF vs zoo ResNet50 rel err {rel_zoo:.3e}, vs the "
                             f"graph on the CPU {rel_cpu:.3e} (tol {KERAS_TOL})")
    rate = N_ROWS / secs
    print(f"[keras] registerKerasImageUDF over ResNet50's Keras graph ({len(graph.layers)} "
          f"layers, {len(graph.weights)} weight-bearing, written in code, seed 0): "
          f"{N_ROWS} rows at 224 px in {N_PARTS} partitions, one row a call, "
          f"{rate:.1f} rows/s ({secs:.2f} s after 8 warm-up rows); outputs "
          f"[{N_ROWS}, 2048] vs the zoo ResNet50 loaded through the converter on the "
          f"card rel err {rel_zoo:.1e}, vs the graph module on the CPU (2 rows) "
          f"{rel_cpu:.1e} (tol {KERAS_TOL}); {card}")
    print(f"[keras] where a UDF row's {1e3 / rate:.2f} ms go: the graph module's forward "
          f"on one device row with its readback {row_host_ms:.2f} ms (host clock, median "
          f"of 25), of it {row_device_ms:.2f} ms of device time (CUDA-graph replays); "
          f"{row_ops} ATen ops dispatched a forward; the rest of the row is the UDF's "
          f"host work (image conversion, resize, the input's copy); {card}")

    small = _small_keras_graph(seed=1, size=32, classes=3)
    xs = rng.standard_normal((256, 32, 32, 3)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[xs.mean(axis=(1, 2)).argmax(axis=1)]
    module = KerasGraphModule(small, device="cuda")
    start = copy.deepcopy(module.keras_weights())
    loss_fn = keras_loss("categorical_crossentropy")
    xt, yt = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()

    def full_loss() -> float:
        with torch.no_grad():
            return loss_fn(module(xt), yt).mean().item()

    before = full_loss()
    t0 = time.perf_counter()
    history = fit_keras_graph(module, xs, ys, optimizer="adam",
                              loss="categorical_crossentropy", epochs=1, batch_size=8,
                              shuffle=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after = full_loss()
    moved = float(np.abs(module.keras_weights()["bn"][2] - start["bn"][2]).max())
    if not (math.isfinite(before) and math.isfinite(after) and after < before
            and math.isfinite(history["loss"][0]) and moved > 0):
        raise AssertionError(f"[keras] fit: loss {before:.4f} -> {after:.4f}, epoch loss "
                             f"{history['loss']}, moving mean moved {moved:.3e}")
    print(f"[keras] KerasImageFileEstimator's torch loop (fit_keras_graph) on the card: "
          f"Conv-BN-Dense graph, 256 examples 32x32, 1 epoch of 32 steps, Adam "
          f"(Keras defaults), categorical crossentropy: loss over the set {before:.4f} "
          f"-> {after:.4f}, epoch mean {history['loss'][0]:.4f}, BN moving mean moved "
          f"{moved:.3e}, {fit_s:.2f} s; {card}")
    keras_here = importlib.util.find_spec("keras") is not None
    print(f"[keras] judged on the CPU, not here: reading .h5/.keras files "
          f"(KerasTransformer, KerasImageFileTransformer, registerKerasImageUDF from a "
          f"file, the estimator's load and save), because this machine has no keras/"
          f"h5py (keras importable here: {keras_here}); tests/test_torch_keras_*.py")
    del zoo, cpu, module, x, x1, row_module
    torch.cuda.empty_cache()
    return {"rows_s": rate, "rel_zoo": rel_zoo, "rel_cpu": rel_cpu,
            "loss": (before, after), "row_host_ms": row_host_ms,
            "row_device_ms": row_device_ms, "row_ops": row_ops}


TF_ROWS, TF_BATCH = 128, 64
TF_TOL = 1e-5        # the same float32 ResNet50 as two torch programs on the card, TF32 off
TF_CPU_TOL = 1e-4    # card vs CPU: cuDNN's and oneDNN's algorithms differ (KERAS_TOL)
MLP_WIDTHS, MLP_BATCH, MLP_ROWS = (2048, 4096, 4096, 1000), 256, 1024
MLP_TOL = 1e-5       # the same cuBLAS float32 products, bias and softmax as separate ops
FLOW_TOL = 1e-5      # card vs CPU: elementwise ops only (tanh's last ulp)


def resnet50_tf_graph(seed: int = 0, size: int = 224):
    """The TFGraph that tf.keras' ResNet50(include_top=False,
    pooling="avg") freezes to, written in code with no TF: Pad, Conv2D +
    BiasAdd, FusedBatchNormV3 (inference), Relu, MaxPool, AddV2 and Mean,
    named after the Keras layers (``conv1_pad/Pad``, ``conv1_conv/Conv2D``,
    ..., ``avg_pool/Mean``), input ``input_1`` (NHWC float32 pixels).
    The weights are resnet50_keras_graph(seed, size)'s, so both graphs
    compute the same function."""
    import numpy as np

    from sparkdl_torch.graph.tfgraph import TFGraph, TFNode, const, placeholder

    weights = resnet50_keras_graph(seed, size).weights
    f32, i32 = np.dtype("float32"), np.dtype("int32")
    nodes = [placeholder("input_1", f32, [None, size, size, 3])]

    def op(name, kind, inputs, **attrs):
        nodes.append(TFNode(name, kind, tuple(inputs), {"T": f32, **attrs}))
        return name

    def pad(name, src, p):
        nodes.append(const(f"{name}/paddings", np.array([[0, 0], [p, p], [p, p], [0, 0]],
                                                        np.int32)))
        return op(f"{name}/Pad", "Pad", [src, f"{name}/paddings"], Tpaddings=i32)

    def conv(layer, src, stride=1, padding="VALID"):
        kernel, bias = weights[layer]
        nodes.extend([const(f"{layer}/kernel", kernel), const(f"{layer}/bias", bias)])
        h = op(f"{layer}/Conv2D", "Conv2D", [src, f"{layer}/kernel"], strides=[1, stride, stride, 1],
               padding=padding, data_format="NHWC", dilations=[1, 1, 1, 1],
               explicit_paddings=[], use_cudnn_on_gpu=True)
        return op(f"{layer}/BiasAdd", "BiasAdd", [h, f"{layer}/bias"], data_format="NHWC")

    def bn(layer, src):
        for key, value in zip(("gamma", "beta", "moving_mean", "moving_variance"),
                              weights[layer]):
            nodes.append(const(f"{layer}/{key}", value))
        return op(f"{layer}/FusedBatchNormV3", "FusedBatchNormV3",
                  [src] + [f"{layer}/{k}" for k in ("gamma", "beta", "moving_mean",
                                                    "moving_variance")],
                  U=f32, epsilon=1.001e-5, exponential_avg_factor=1.0, data_format="NHWC",
                  is_training=False)

    def relu(layer, src):
        return op(f"{layer}/Relu", "Relu", [src])

    x = relu("conv1_relu", bn("conv1_bn", conv("conv1_conv", pad("conv1_pad", "input_1", 3), 2)))
    x = pad("pool1_pad", x, 1)
    x = op("pool1_pool/MaxPool", "MaxPool", [x], ksize=[1, 3, 3, 1], strides=[1, 2, 2, 1],
           padding="VALID", data_format="NHWC", explicit_paddings=[])
    for stage, (blocks, stride) in enumerate(((3, 1), (4, 2), (6, 2), (3, 2)), start=2):
        for b in range(1, blocks + 1):
            p, s = f"conv{stage}_block{b}", (stride if b == 1 else 1)
            h = relu(f"{p}_1_relu", bn(f"{p}_1_bn", conv(f"{p}_1_conv", x, s)))
            h = relu(f"{p}_2_relu", bn(f"{p}_2_bn", conv(f"{p}_2_conv", h, 1, "SAME")))
            h = bn(f"{p}_3_bn", conv(f"{p}_3_conv", h))
            short = bn(f"{p}_0_bn", conv(f"{p}_0_conv", x, s)) if b == 1 else x
            x = relu(f"{p}_out", op(f"{p}_add/add", "AddV2", [short, h]))
    nodes.append(const("avg_pool/Mean/reduction_indices", np.array([1, 2], np.int32)))
    op("avg_pool/Mean", "Mean", [x, "avg_pool/Mean/reduction_indices"], Tidx=i32,
       keep_dims=False)
    return TFGraph(nodes)


def mlp_tf_graph(seed: int = 0, widths=MLP_WIDTHS):
    """A frozen dense classifier as a TFGraph in code: MatMul + BiasAdd +
    Relu per hidden layer, MatMul + BiasAdd + Softmax at the top; input
    ``x`` [None, widths[0]], output ``probs``. Returns (graph, weights)."""
    import numpy as np

    from sparkdl_torch.graph.tfgraph import TFGraph, TFNode, const, placeholder

    rng = np.random.default_rng(seed)
    f32 = np.dtype("float32")
    nodes, weights, h = [placeholder("x", f32, [None, widths[0]])], [], "x"
    for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        w = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        weights.append((w, b))
        nodes += [const(f"dense{i}/kernel", w), const(f"dense{i}/bias", b),
                  TFNode(f"dense{i}/MatMul", "MatMul", (h, f"dense{i}/kernel"),
                         {"T": f32, "transpose_a": False, "transpose_b": False}),
                  TFNode(f"dense{i}/BiasAdd", "BiasAdd", (f"dense{i}/MatMul", f"dense{i}/bias"),
                         {"T": f32, "data_format": "NHWC"})]
        h = f"dense{i}/BiasAdd"
        if i < len(widths) - 2:
            nodes.append(TFNode(f"dense{i}/Relu", "Relu", (h,), {"T": f32}))
            h = f"dense{i}/Relu"
    nodes.append(TFNode("probs", "Softmax", (h,), {"T": f32}))
    return TFGraph(nodes), weights


def control_flow_tf_graph(width: int = 64):
    """A graph with a functional If and a While, as TF2 freezes tf.cond
    and tf.while_loop: y = While(i < 5: (i + 1, 0.5 a + tanh a)) over
    a = If(mean(x) > 0, 2x + 1, -x). Input ``x`` [None, width], output
    ``loop:1``."""
    import numpy as np

    from sparkdl_torch.graph.tfgraph import TFFunction, TFGraph, TFNode, const, placeholder

    f32, i32 = np.dtype("float32"), np.dtype("int32")

    def fn(nodes, inputs, outputs):
        return TFFunction(TFGraph(nodes), inputs, outputs)

    then_ = fn([placeholder("x", f32, [None, width]), const("two", np.float32(2)),
                const("one", np.float32(1)),
                TFNode("mul", "Mul", ("x", "two"), {"T": f32}),
                TFNode("add", "AddV2", ("mul", "one"), {"T": f32})], ["x:0"], ["add:0"])
    else_ = fn([placeholder("x", f32, [None, width]),
                TFNode("neg", "Neg", ("x",), {"T": f32})], ["x:0"], ["neg:0"])
    cond = fn([placeholder("i", i32, []), placeholder("a", f32, [None, width]),
               const("n", np.int32(5)), TFNode("less", "Less", ("i", "n"), {"T": i32})],
              ["i:0", "a:0"], ["less:0"])
    body = fn([placeholder("i", i32, []), placeholder("a", f32, [None, width]),
               const("one", np.int32(1)), const("half", np.float32(0.5)),
               TFNode("next", "AddV2", ("i", "one"), {"T": i32}),
               TFNode("scaled", "Mul", ("a", "half"), {"T": f32}),
               TFNode("tanh", "Tanh", ("a",), {"T": f32}),
               TFNode("acc", "AddV2", ("scaled", "tanh"), {"T": f32})],
              ["i:0", "a:0"], ["next:0", "acc:0"])
    nodes = [placeholder("x", f32, [None, width]), const("axes", np.array([0, 1], np.int32)),
             const("zero", np.float32(0)), const("start", np.int32(0)),
             TFNode("mean", "Mean", ("x", "axes"), {"T": f32, "keep_dims": False}),
             TFNode("pred", "Greater", ("mean", "zero"), {"T": f32}),
             TFNode("branch", "StatelessIf", ("pred", "x"),
                    {"then_branch": "then", "else_branch": "else"}),
             TFNode("loop", "StatelessWhile", ("start", "branch"),
                    {"cond": "cond", "body": "body"})]
    return TFGraph(nodes, library={"then": then_, "else": else_, "cond": cond, "body": body})


def shape_math_tf_graph(width: int = 64):
    """y = (x / n) * n * Fill([n, width], 2) with n = Shape(x)[0]: a graph
    whose device operands are computed from the batch's shape (the scalar
    n and the [n, width] fill), so each batch size gives them other
    values. Input ``x`` [None, width], output ``y``; y == 2x exactly when
    n is a power of two."""
    import numpy as np

    from sparkdl_torch.graph.tfgraph import TFGraph, TFNode, const, placeholder

    f32, i32 = np.dtype("float32"), np.dtype("int32")
    return TFGraph([
        placeholder("x", f32, [None, width]),
        const("begin", np.array([0], np.int32)), const("end", np.array([1], np.int32)),
        const("strides", np.array([1], np.int32)), const("width", np.int32(width)),
        const("two", np.float32(2)),
        TFNode("shape", "Shape", ("x",), {"T": f32, "out_type": i32}),
        TFNode("n", "StridedSlice", ("shape", "begin", "end", "strides"),
               {"T": i32, "Index": i32, "begin_mask": 0, "end_mask": 0, "ellipsis_mask": 0,
                "new_axis_mask": 0, "shrink_axis_mask": 1}),
        TFNode("nf", "Cast", ("n",), {"SrcT": i32, "DstT": f32, "Truncate": False}),
        TFNode("dims", "Pack", ("n", "width"), {"T": i32, "N": 2, "axis": 0}),
        TFNode("twos", "Fill", ("dims", "two"), {"T": f32, "index_type": i32}),
        TFNode("scaled", "RealDiv", ("x", "nf"), {"T": f32}),
        TFNode("back", "Mul", ("scaled", "nf"), {"T": f32}),
        TFNode("y", "Mul", ("back", "twos"), {"T": f32}),
    ])


def check_shape_math_buckets(rows: int = 96, batch: int = 64, width: int = 64) -> list:
    """shape_math_tf_graph through TFTransformer on the card over one
    partition of ``rows`` rows (a batch of ``batch`` and a tail of
    ``rows - batch``: two buckets, each captured as a CUDA graph after
    its eager warm-up), three transforms, with the freed memory of the
    card's allocator filled with NaN between them; every row must be 2x
    exactly. A captured graph holds the addresses of the device copies
    of the shape-derived operands, so a copy dropped when another bucket
    ran would read reused memory here. Returns the graphs' keys."""
    import numpy as np
    import torch

    from sparkdl_torch import LocalDataFrame, TFInputGraph, TFTransformer
    from sparkdl_torch.transformers._inference import _GRAPH_RUNNERS

    gin = TFInputGraph.fromGraphDef(shape_math_tf_graph(width), ["x"], ["y"])
    feats = np.random.default_rng(5).standard_normal((rows, width)).astype(np.float32)
    df = LocalDataFrame.from_rows([{"v": feats[i]} for i in range(rows)], 1)
    tft = TFTransformer(tfInputGraph=gin, inputMapping={"v": "x"}, outputMapping={"y": "y"},
                        batchSize=batch, device="cuda")
    for attempt in range(3):
        got = np.stack([r["y"] for r in tft.transform(df).collect()])
        bad = int((got != 2 * feats).any(axis=1).sum())
        if bad:
            raise AssertionError(f"[tf_graph] shape-derived operands, transform {attempt}: "
                                 f"{bad} of {rows} rows differ from 2x")
        torch.cuda.synchronize()
        junk = [torch.full((n, width), float("nan"), device="cuda")
                for n in (batch, rows - batch) for _ in range(4)]
        junk += [torch.full((), float("nan"), device="cuda") for _ in range(16)]
        del junk
    (runner,) = _GRAPH_RUNNERS[gin].values()
    keys = runner._chainer.graph_keys
    if len({k[0] for k in keys}) < 2:
        raise AssertionError(f"[tf_graph] shape-derived operands: graphs {keys}, not two buckets")
    return keys


def phase_tf_graph(card: str) -> dict:
    """TF-graph ingestion's run half on the card, with no TF (this machine
    has none): ResNet50's frozen tf.keras graph, written in code
    (resnet50_tf_graph, seed 0), through TFImageTransformer(outputMode=
    "vector", device="cuda", batchSize=64) over 128 random rows at 224 px
    (rows/s of a second transform, after one that captured the runner's
    CUDA graphs), its features held to KerasGraphModule over the same
    weights' Keras graph on the card (TF_TOL) and to the CPU translation
    (2 rows, TF_CPU_TOL); one batch's forward in device ms (CUDA-graph
    replays), the ATen ops it dispatches, and f32_precision="default"
    against "highest". Then TFTransformer over a 2048-4096-4096-1000 MLP
    graph at batch 256, held to the same math in plain torch, and an
    If/While graph on the card held to the CPU. No kernel of the port
    runs here (cuDNN/cuBLAS), and none is launched."""
    import importlib.util

    import numpy as np
    import torch

    from sparkdl_torch import LocalDataFrame, TFImageTransformer, TFInputGraph, TFTransformer
    from sparkdl_torch.graph.tf2torch import translate_graph
    from sparkdl_torch.models.keras_graph import KerasGraphModule
    from sparkdl_torch.transformers._inference import _GRAPH_RUNNERS

    launched = _launch_counts()
    graph = resnet50_tf_graph(seed=0)
    gin = TFInputGraph.fromGraphDef(graph, ["input_1"], ["avg_pool/Mean"])
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (TF_ROWS, 224, 224, 3), dtype=np.uint8)
    from sparkdl_torch.image import imageArrayToStructBGR

    df = LocalDataFrame.from_rows(
        [{"id": i, "image": imageArrayToStructBGR(images[i])} for i in range(TF_ROWS)], 2)
    transformer = TFImageTransformer(inputCol="image", outputCol="features", graph=gin,
                                     outputMode="vector", device="cuda", batchSize=TF_BATCH)
    # TF32 on in the process (phase_card turned it off) while the
    # transformer captures and runs: f32_precision="highest" must keep
    # its products float32 all the same (TF_TOL below) and give the
    # flags back as it found them
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        transformer.transform(df).collect()  # translation, cuDNN plans, graph captures
        first_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = transformer.transform(df).collect()
        secs = time.perf_counter() - t0
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if flags != (True, True):
        raise AssertionError(f"[tf_graph] TF32 flags (cudnn, cuBLAS) {flags} after the "
                             "transforms, not restored to (True, True)")
    (runner,) = _GRAPH_RUNNERS[gin].values()
    captured = sorted(k[1] for k in runner._chainer.graph_keys)
    got = torch.from_numpy(np.stack([r["features"] for r in out]))
    if got.shape != (TF_ROWS, 2048) or not torch.isfinite(got).all() or not captured:
        raise AssertionError(f"[tf_graph] features {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}, graphs {captured}")
    keras = KerasGraphModule(resnet50_keras_graph(seed=0), device="cuda").eval()
    x = torch.from_numpy(images.astype(np.float32)).cuda()
    with torch.inference_mode():
        want = torch.cat([keras(x[i:i + TF_BATCH]) for i in range(0, TF_ROWS, TF_BATCH)]).cpu()
        cpu = translate_graph(graph, ["input_1"], ["avg_pool/Mean"], device="cpu")
        want_cpu = cpu(images[:2].astype(np.float32))[0]
    _, rel = _rel_err(got, want)
    _, rel_cpu = _rel_err(got[:2], want_cpu)
    if rel > TF_TOL or rel_cpu > TF_CPU_TOL:
        raise AssertionError(f"[tf_graph] features vs KerasGraphModule rel err {rel:.3e} "
                             f"(tol {TF_TOL}), vs the CPU translation {rel_cpu:.3e} "
                             f"(tol {TF_CPU_TOL})")
    hi = gin.to_torch(device="cuda")
    lo = gin.to_torch(device="cuda", f32_precision="default")
    xb = x[:TF_BATCH].contiguous()
    with torch.inference_mode():
        f_hi, f_lo = hi(xb)[0], lo(xb)[0]
        _, rel_lo = _rel_err(f_lo, f_hi)
        ops = _dispatched_ops(lambda: hi(xb))
        ms_hi = _device_ms(lambda: hi(xb), calls=5, reps=5)
        ms_lo = _device_ms(lambda: lo(xb), calls=5, reps=5)
    if not torch.isfinite(f_lo).all() or rel_lo > ZOO_BF16_TOL:
        raise AssertionError(f"[tf_graph] f32_precision='default' vs 'highest' rel err "
                             f"{rel_lo:.3e} (tol {ZOO_BF16_TOL})")
    rate = TF_ROWS / secs
    print(f"[tf_graph] TFImageTransformer over ResNet50's frozen tf.keras graph "
          f"({len(graph.nodes)} nodes, written in code, seed 0, no TF), {TF_ROWS} rows at 224 "
          f"px in 2 partitions, batchSize {TF_BATCH}, device cuda; {card}: {rate:.1f} rows/s "
          f"({secs:.2f} s; first transform {first_s:.1f} s with translation and captures), "
          f"CUDA graphs captured for K {captured}; features [{TF_ROWS}, 2048] vs "
          f"KerasGraphModule over the same weights on the card rel err {rel:.1e} (tol "
          f"{TF_TOL}; the transforms ran with the process's TF32 flags on, and "
          f"f32_precision='highest' kept them float32 and gave the flags back), vs the CPU "
          f"translation (2 rows) {rel_cpu:.1e} (tol {TF_CPU_TOL})")
    print(f"[tf_graph] one batch of {TF_BATCH} through the translated graph; {card}: "
          f"{ms_hi:.2f} ms of device time at f32_precision='highest' (CUDA-graph replays), "
          f"{ops} ATen ops dispatched a forward; f32_precision='default' (bf16 operands, "
          f"float32 accumulation) {ms_lo:.2f} ms, rel err vs 'highest' {rel_lo:.2e} (tol "
          f"{ZOO_BF16_TOL})")

    mlp, weights = mlp_tf_graph(seed=0, widths=MLP_WIDTHS)
    feats = rng.standard_normal((MLP_ROWS, MLP_WIDTHS[0])).astype(np.float32)
    mlp_gin = TFInputGraph.fromGraphDef(mlp, ["x"], ["probs"])
    tft = TFTransformer(tfInputGraph=mlp_gin, inputMapping={"v": "x"},
                        outputMapping={"probs": "p"}, batchSize=MLP_BATCH, device="cuda")
    mdf = LocalDataFrame.from_rows([{"v": feats[i]} for i in range(MLP_ROWS)], 2)
    tft.transform(mdf).collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mout = tft.transform(mdf).collect()
    mlp_s = time.perf_counter() - t0
    (mrunner,) = _GRAPH_RUNNERS[mlp_gin].values()
    mlp_graphs = sorted(k[1] for k in mrunner._chainer.graph_keys)
    mgot = torch.from_numpy(np.stack([r["p"] for r in mout]))
    with torch.inference_mode():
        h = torch.from_numpy(feats).cuda()
        for i, (w, b) in enumerate(weights):
            h = h @ torch.from_numpy(w).cuda() + torch.from_numpy(b).cuda()
            h = torch.relu(h) if i < len(weights) - 1 else torch.softmax(h, dim=-1)
        mwant = h.cpu()
        mfn = mlp_gin.to_torch(device="cuda")
        xm = torch.from_numpy(feats[:MLP_BATCH]).cuda()
        mlp_ms = _device_ms(lambda: mfn(xm), calls=5, reps=5)
    _, mrel = _rel_err(mgot, mwant)
    if mgot.shape != (MLP_ROWS, MLP_WIDTHS[-1]) or mrel > MLP_TOL or not mlp_graphs:
        raise AssertionError(f"[tf_graph] MLP {tuple(mgot.shape)} rel err {mrel:.3e} "
                             f"(tol {MLP_TOL}), graphs {mlp_graphs}")
    print(f"[tf_graph] TFTransformer over a {'-'.join(map(str, MLP_WIDTHS))} MLP graph "
          f"(MatMul + BiasAdd + Relu, Softmax), {MLP_ROWS} rows, batchSize {MLP_BATCH}; "
          f"{card}: {MLP_ROWS / mlp_s:.1f} rows/s ({mlp_s:.2f} s), {mlp_ms:.3f} ms of device "
          f"time a batch, CUDA graphs for K {mlp_graphs}; vs the same math in plain torch "
          f"on the card rel err {mrel:.1e} (tol {MLP_TOL})")

    flow = control_flow_tf_graph()
    xf = rng.standard_normal((256, 64)).astype(np.float32)
    fgot, fwant = [], []
    for sign in (1.0, -1.0):  # one input for each branch of the If
        xs = np.abs(xf) * sign
        card_fn = translate_graph(flow, ["x"], ["loop:1"], device="cuda")
        fgot.append(card_fn(torch.from_numpy(xs).cuda())[0].cpu())
        fwant.append(translate_graph(flow, ["x"], ["loop:1"], device="cpu")(xs)[0])
    _, frel = _rel_err(torch.cat(fgot), torch.cat(fwant))
    if frel > FLOW_TOL or not card_fn.host_sync:
        raise AssertionError(f"[tf_graph] If/While graph card vs CPU rel err {frel:.3e} "
                             f"(tol {FLOW_TOL})")
    print(f"[tf_graph] StatelessIf + StatelessWhile graph ({len(flow.library)} library "
          f"functions, predicates read to the host, so runners keep it eager) on the card, "
          f"both branches, [256, 64]: vs the CPU translation rel err {frel:.1e} (tol "
          f"{FLOW_TOL}); {card}")
    keys = check_shape_math_buckets()
    print(f"[tf_graph] a graph whose device operands come from Shape(x)[0] (x / n * n * "
          f"Fill([n, 64], 2)) through TFTransformer, 96 rows as a batch of 64 and a tail of "
          f"32, three transforms with the allocator's free memory filled with NaN between "
          f"them: every row equals 2x exactly, CUDA graphs {sorted(keys)}; {card}")
    after = _launch_counts()
    if after != launched:
        raise AssertionError(f"[tf_graph] launched a kernel of the port: {launched} -> {after}")
    print("[tf_graph] no kernel of the port launched in this phase")
    tf_here = importlib.util.find_spec("tensorflow") is not None
    print(f"[tf_graph] judged on the CPU, not here: reading GraphDefs, SavedModels and "
          f"checkpoints (TFInputGraph's six constructors, GraphFunction.load, "
          f"IsolatedSession, buildSpImageConverter), because this machine has no TensorFlow "
          f"or protobuf (tensorflow importable here: {tf_here}); tests/test_torch_tf2torch.py, "
          f"test_torch_graph_*.py, test_torch_tf2_ingestion.py, test_torch_tf_transformers.py")
    del keras, hi, lo, x, xb, mfn
    torch.cuda.empty_cache()
    return {"rows_s": rate, "rel": rel, "rel_cpu": rel_cpu, "ms": ms_hi, "ms_default": ms_lo,
            "rel_default": rel_lo, "ops": ops, "mlp_rows_s": MLP_ROWS / mlp_s,
            "mlp_ms": mlp_ms}


def _attention_times(q, k, v, mask) -> dict:
    """The flash forward (no grad) against its plain version, SDPA and its
    3xTF32 bound on the same inputs (the work this mask needs:
    _attention_work): device ms from CUDA-graph replays."""
    import torch.nn.functional as F

    from sparkdl_torch.ops.flash_attention import (
        _keep_mask,
        flash_attention,
        flash_attention_reference,
    )

    b, lq, h, d = q.shape
    lk = k.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    keep = None if mask is None else _keep_mask(b, lq, lk, mask, False, 0, q.device)
    card_flops, nbytes = _attention_work(b, lq, lk, mask, heads=h, head_dim=d)
    bound_ms, bound_by = _bound(3 * card_flops, nbytes, H100_TF32_FLOPS)
    return {
        "ms": _device_ms(lambda: flash_attention(q, k, v, mask)),
        "host_ms": _time_ms(lambda: flash_attention(q, k, v, mask)),
        "plain_ms": _device_ms(lambda: flash_attention_reference(q, k, v, mask)),
        "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "gflop": card_flops / 1e9, "mb": nbytes / 1e6,
    }


def _times_text(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms ({t['host_ms']:.4f} per call from the host), "
            f"plain {t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f} (kernel/sdpa "
            f"{t['ms'] / t['library_ms']:.2f}), bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}; {t['gflop']:.3f} GFLOP as 3xTF32 at 495 TFLOP/s, "
            f"{t['mb']:.1f} MB)")


def phase_vit(card: str, attn_entry: dict) -> float:
    """ViT-B/16 (224 px, 12 layers, L=197) with attn_impl="flash" against
    "full" on the card, the same random weights (seed 0), B=64: features
    within VIT_TOL, the flash forward's launches a forward, the forward's
    device ms each way, and the kernel at B=64 L=197 (no mask) against
    its plain version, SDPA and its bound."""
    import numpy as np
    import torch

    from sparkdl_torch.models.registry import build_torch_model
    from sparkdl_torch.models.vit import ViTConfig, ViTModel
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from sparkdl_torch.ops.preprocess import preprocess_tf

    full = build_torch_model("ViTB16", "random", include_top=False, seed=0)
    cfg = ViTConfig.b16(attn_impl="flash")
    flash = ViTModel(cfg, include_top=False)
    flash.load_state_dict(full.state_dict())
    flash = flash.cuda().eval()
    rng = np.random.default_rng(6)
    size = cfg.image_size
    x = preprocess_tf(torch.from_numpy(rng.integers(
        0, 256, (BATCH, size, size, 3)).astype(np.float32)).cuda())
    with torch.inference_mode():
        torch.cuda.synchronize()
        _zero_counts()
        got, _ = flash(x)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        want, _ = full(x)
        flash_ms = _time_ms(lambda: flash(x), warmup=1, reps=5)
        full_ms = _time_ms(lambda: full(x), warmup=1, reps=5)
    if launches != cfg.num_layers:
        raise AssertionError(f"[vit] flash_attention launched {launches} times in one "
                             f"forward, want {cfg.num_layers}")
    abs_err, rel = _rel_err(got, want)
    if not torch.isfinite(got).all() or rel > VIT_TOL:
        raise AssertionError(f"[vit] flash vs full features: rel err {rel:.3e} "
                             f"(tol {VIT_TOL})")

    length = cfg.num_patches + 1
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (BATCH, length, HEADS, HEAD_DIM), dtype=np.float32)).cuda() for _ in "qkv")
    kernel_err = _rel_err(flash_attention(q, k, v), flash_attention_reference(q, k, v))
    if kernel_err[1] > ATTN_TOL:
        raise AssertionError(f"[vit] kernel vs plain at L={length}: rel err "
                             f"{kernel_err[1]:.3e} (tol {ATTN_TOL})")
    times = _attention_times(q, k, v, None)
    print(f"[vit] ViT-B/16 {cfg.image_size} px ({cfg.num_layers}x{cfg.hidden_size}, "
          f"L={length}), random init seed 0, B={BATCH}, attn_impl='flash' vs 'full' on "
          f"the same weights: features rel err {rel:.1e} (tol {VIT_TOL}); flash_attention "
          f"launches {launches} a forward; forward {flash_ms:.2f} ms flash, {full_ms:.2f} "
          f"ms full (CUDA events); kernel at B={BATCH} L={length} H={HEADS} D={HEAD_DIM} "
          f"no mask: rel err vs plain {kernel_err[1]:.1e} (tol {ATTN_TOL}), "
          f"{_times_text(times)}; {card}")
    attn_entry.update({f"vit_{k}": times[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    attn_entry["vit_launches"] = launches
    del full, flash, x, q, k, v
    torch.cuda.empty_cache()
    return times["ms"]


def phase_text(card: str, attn_entry: dict) -> float:
    """DeepTextFeaturizer over BERT-base (random init seed 0) with
    attn_impl="flash": 256 rows of 16..128 tokens and one empty row in
    4 partitions, batch 64, maxLength 128, each pooling against
    attn_impl="full" on real rows (the empty row finite) and, on the first,
    middle and last real row of each partition, against an eager BertModel
    forward outside the runner (no graph: a baked-in or stale mask shows
    there, not against "full", which replays graphs too), the flash
    forward's launches per batch through the runner's graph replays,
    examples/s, and the kernel at B=64 L=128 with a right-padded key
    mask against its plain version, SDPA and its bound."""
    import dataclasses

    import numpy as np
    import torch

    from sparkdl_torch import DeepTextFeaturizer, LocalDataFrame
    from sparkdl_torch.models.bert import BertConfig, BertModel, init_bert_
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from sparkdl_torch.transformers import text

    cfg = BertConfig.base(attn_impl="flash")
    state = init_bert_(BertModel(cfg, device="cpu"), seed=0).state_dict()
    rng = np.random.default_rng(7)
    lengths = list(rng.integers(16, TEXT_LEN + 1, TEXT_ROWS))
    lengths.insert(TEXT_ROWS // 2, 0)  # an empty row: no valid key
    rows = [{"id": i, "tokens": rng.integers(1, cfg.vocab_size, n).tolist()}
            for i, n in enumerate(lengths)]
    empty = lengths.index(0)
    df = LocalDataFrame.from_rows(rows, N_PARTS)
    n_batches = sum(r["n"] for r in df.mapPartitions(
        lambda part: [{"n": math.ceil(len(list(part)) / TEXT_BATCH)}]).collect())

    def featurizer(attn_impl, pooling):
        return DeepTextFeaturizer(
            inputCol="tokens", outputCol="f", pooling=pooling, maxLength=TEXT_LEN,
            batchSize=TEXT_BATCH,
            model=(dataclasses.replace(cfg, attn_impl=attn_impl), state))

    def features(t):
        out = t.transform(df).collect()
        return np.stack([r["f"] for r in sorted(out, key=lambda r: r["id"])])

    errs, eager_errs, launches, secs = {}, {}, {}, []
    real = [i for i, n in enumerate(lengths) if n]
    probe = []  # the first, middle and last real row of each partition
    for part in df.mapPartitions(lambda p: [{"ids": [r["id"] for r in p]}]).collect():
        ids = [i for i in part["ids"] if lengths[i]]
        probe += sorted({ids[0], ids[len(ids) // 2], ids[-1]})
    eager = BertModel(dataclasses.replace(cfg, attn_impl="full"), device="cuda").eval()
    eager.load_state_dict(state)
    ids, keep = (np.zeros((len(probe), TEXT_LEN), np.int64) for _ in "ik")
    for j, i in enumerate(probe):
        tokens = rows[i]["tokens"][:TEXT_LEN]
        ids[j, :len(tokens)], keep[j, :len(tokens)] = tokens, 1
    with torch.inference_mode():
        ids, keep = torch.from_numpy(ids).cuda(), torch.from_numpy(keep).cuda()
        seq, pooled = eager(ids, keep)
        weight = keep[:, :, None].float()
        eager_out = {"cls": seq[:, 0], "mean": (seq * weight).sum(1) / weight.sum(1),
                     "pooler": pooled}
        eager_out = {p: t.float().cpu() for p, t in eager_out.items()}
    del eager, ids, keep, seq, pooled
    for pooling in ("cls", "mean", "pooler"):
        flash = featurizer("flash", pooling)
        features(flash)  # warm-up: the model, one graph a bucket
        torch.cuda.synchronize()
        _zero_counts()
        got = features(flash)
        torch.cuda.synchronize()
        launches[pooling] = flash_attention.launches
        if pooling == "mean":  # the default pooling: timed
            for _ in range(TIME_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                features(flash)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        want = features(featurizer("full", pooling))
        if got.shape != (len(rows), cfg.hidden_size) or not np.isfinite(got).all():
            raise AssertionError(f"[text] {pooling}: bad features {got.shape} "
                                 f"(empty row finite: {np.isfinite(got[empty]).all()})")
        errs[pooling] = _rel_err(torch.from_numpy(got[real]), torch.from_numpy(want[real]))
        if errs[pooling][1] > TEXT_TOL:
            raise AssertionError(f"[text] {pooling}: flash vs full rel err "
                                 f"{errs[pooling][1]:.3e} (tol {TEXT_TOL})")
        eager_errs[pooling] = _rel_err(torch.from_numpy(got[probe]), eager_out[pooling])
        if eager_errs[pooling][1] > TEXT_TOL:
            raise AssertionError(f"[text] {pooling}: graphed flash vs an eager full "
                                 f"forward, rows {probe}: rel err "
                                 f"{eager_errs[pooling][1]:.3e} (tol {TEXT_TOL})")
        if launches[pooling] != cfg.num_hidden_layers * n_batches:
            raise AssertionError(
                f"[text] {pooling}: flash_attention launched {launches[pooling]} times "
                f"for {n_batches} batches, want {cfg.num_hidden_layers} a batch")
        text._RUNNER_CACHE.clear()
        torch.cuda.empty_cache()

    # the kernel at the featurizer's shape: a right-padded key mask of
    # 16..128 keys, and a row without a valid key (finite)
    b, length = TEXT_BATCH, TEXT_LEN
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, length, HEADS, HEAD_DIM), dtype=np.float32)).cuda() for _ in "qkv")
    mask = _right_padded_mask(rng, b, length)
    dead = mask.clone()
    dead[-1] = False
    got = flash_attention(q, k, v, dead)
    kernel_err = _rel_err(got[:-1], flash_attention_reference(q, k, v, dead)[:-1])
    if kernel_err[1] > ATTN_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"[text] kernel vs plain at L={length} with the mask: rel "
                             f"err {kernel_err[1]:.3e} (tol {ATTN_TOL})")
    valid_keys = int(mask.sum())
    times = _attention_times(q, k, v, mask)
    rate = len(rows) / statistics.median(secs)
    print(f"[text] DeepTextFeaturizer BERT-base ({cfg.num_hidden_layers}x"
          f"{cfg.hidden_size}), random init seed 0, attn_impl='flash', {len(rows)} rows "
          f"(16..{TEXT_LEN} tokens, one empty) in {N_PARTS} partitions, batchSize "
          f"{TEXT_BATCH}, maxLength {TEXT_LEN}; {card}: {rate:.1f} examples/s (mean "
          f"pooling, median of {TIME_REPS}; min {len(rows) / max(secs):.1f}, max "
          f"{len(rows) / min(secs):.1f}); flash_attention launches "
          + ", ".join(f"{p} {n}" for p, n in launches.items())
          + f" = {cfg.num_hidden_layers} a batch x {n_batches} batches (graph replays); "
          f"vs attn_impl='full' on real rows: "
          + ", ".join(f"{p} rel err {e[1]:.1e}" for p, e in errs.items())
          + f" (tol {TEXT_TOL}), empty row finite; vs an eager attn_impl='full' "
          f"BertModel forward outside the runner on {len(probe)} rows (first, middle, "
          f"last real row of each partition): "
          + ", ".join(f"{p} rel err {e[1]:.1e}" for p, e in eager_errs.items())
          + f" (tol {TEXT_TOL}); kernel at B={b} L={length} "
          f"H={HEADS} D={HEAD_DIM} with the key mask ({valid_keys} valid keys): rel err "
          f"vs plain {kernel_err[1]:.1e} (tol {ATTN_TOL}; a row without a valid key "
          f"finite), {_times_text(times)}")
    attn_entry.update({f"text_{k}": times[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    attn_entry["text_launches"] = launches["mean"]
    del q, k, v
    torch.cuda.empty_cache()
    return rate


def phase_hpo(card: str) -> dict:
    """hpo.fmin with trial_runner="threads": two trials over two
    learning rates, each HPO_STEPS finetune_classifier steps of BERT-base
    (flash attention, forward and backward kernels) at B=32 L=128; the
    best is the trial with the lower final loss."""
    import numpy as np
    import torch

    from sparkdl_torch.hpo import Trials, fmin, hp
    from sparkdl_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
        init_bert_,
    )
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from sparkdl_torch.train import finetune_classifier

    cfg = BertConfig.base(attn_impl="flash")
    state = init_bert_(BertForSequenceClassification(cfg, num_labels=2, device="cpu"),
                       seed=0).state_dict()
    rng = np.random.default_rng(10)
    batches = []
    for _ in range(HPO_STEPS):
        mask = _right_padded_mask(rng, HPO_BATCH, BERT_TRAIN_LEN).cpu().numpy()
        batches.append({
            "input_ids": rng.integers(0, cfg.vocab_size, (HPO_BATCH, BERT_TRAIN_LEN)) * mask,
            "attention_mask": mask, "labels": rng.integers(0, 2, HPO_BATCH)})

    def objective(params):
        model = BertForSequenceClassification(cfg, num_labels=2, device="cuda")
        model.load_state_dict(state)
        t0 = time.perf_counter()
        _, history = finetune_classifier(model, batches, learning_rate=params["lr"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
        return {"loss": history[-1]["loss"], "seconds": secs,
                "first_loss": history[0]["loss"]}

    trials = Trials()
    torch.cuda.synchronize()
    _zero_counts()
    best = fmin(objective, {"lr": hp.loguniform("lr", math.log(1e-5), math.log(1e-3))},
                max_evals=2, seed=0, trials=trials, trial_runner="threads",
                use_hyperopt=False)
    counts = (flash_attention.launches, flash_attention_bwd.launches_dq,
              flash_attention_bwd.launches_dkv)
    ok = [t for t in trials.trials if t["status"] == "ok"]
    if len(ok) != 2:
        raise AssertionError(f"[hpo] trials failed: {trials.trials}")
    lower = min(ok, key=lambda t: t["loss"])
    if best != lower["params"] or not all(np.isfinite(t["loss"]) for t in ok):
        raise AssertionError(f"[hpo] best {best} is not the trial with the lower final "
                             f"loss: {[(t['params'], t['loss']) for t in ok]}")
    want = cfg.num_hidden_layers * HPO_STEPS * len(ok)
    if counts != (want, want, want):
        raise AssertionError(f"[hpo] flash launches forward/dq/dkv {counts}, want {want} "
                             "each")
    print(f"[hpo] fmin(trial_runner='threads'), {len(ok)} trials over lr "
          f"loguniform(1e-5, 1e-3), each finetune_classifier BERT-base (attn_impl="
          f"'flash') {HPO_STEPS} steps of B={HPO_BATCH} L={BERT_TRAIN_LEN}; {card}: "
          + "; ".join(f"lr {t['params']['lr']:.2e}: loss {t['first_loss']:.4f} -> "
                      f"{t['loss']:.4f} in {t['seconds']:.1f} s" for t in ok)
          + f"; best lr {best['lr']:.2e} (the lower final loss); flash launches "
          f"forward/dq/dkv {counts[0]}/{counts[1]}/{counts[2]} = {cfg.num_hidden_layers} "
          f"a step x {HPO_STEPS} x {len(ok)}")
    return {"seconds": [t["seconds"] for t in ok], "best": best}

SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BLOCK, SERVE_CHUNK = 16, 512, 16, 256
SERVE_REQS, SERVE_NEW, SERVE_SHARED, SERVE_PREFIX = 64, 32, 16, 128
SERVE_THREADS, SERVE_WAIT_S = 8, 0.004
SERVE_QUANT_AGREE = 0.8  # tests/serving/test_kv_quant.py's "near the oracle" bar
SERVE_TICK_NEW = 200     # the timed decode ticks: 16 rows of 256 + up to 200 tokens


def _featurizer_rows() -> tuple:
    """N_ROWS random SIZE-px image rows (seed 11) and the featurizer's
    row for each, by id: what the serving phases answer against."""
    import numpy as np

    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame

    _, rows = _image_rows(np.random.default_rng(11), SIZE)
    want = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="InceptionV3",
                               weights="random", batchSize=BATCH).transform(
        LocalDataFrame.from_rows(rows, N_PARTS)).collect()
    return rows, {r["id"]: r["f"] for r in want}


def _serve_prompts(vocab: int, seed: int) -> list:
    """SERVE_REQS prompts of 8..256 tokens from ``seed``; every fourth
    one (SERVE_SHARED of them) opens with one SERVE_PREFIX-token prefix
    and an 8-token stem, half of those with a short tail (the prompt's
    last block partial: a later sharer copies it on write)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SERVE_PREFIX)
    stem = rng.integers(0, vocab, 8)
    prompts = []
    for i in range(SERVE_REQS):
        if i % (SERVE_REQS // SERVE_SHARED):
            prompts.append(rng.integers(0, vocab, int(rng.integers(8, 257))))
            continue
        n_tail = int(rng.integers(1, 16) if (i // 4) % 2 else rng.integers(16, 129))
        tail = np.concatenate([stem, rng.integers(0, vocab, n_tail)])[:n_tail]
        prompts.append(np.concatenate([prefix, tail]))
    return prompts


def _serve_engine(cfg, model, **kw):
    from sparkdl_torch.serving import ContinuousGPTEngine

    return ContinuousGPTEngine(
        cfg, model, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
        kv_block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK, auto_start=False, **kw)


def _burst(eng, prompts) -> dict:
    """All prompts submitted at once (on a fresh engine before its daemon
    loop starts), each for SERVE_NEW tokens: the tokens, wall seconds,
    per-request TTFT and ms per output token after the first, and the
    engine's snapshot."""
    import numpy as np

    sent, done, futs = [], {}, []
    for i, p in enumerate(prompts):
        sent.append(time.monotonic())
        futs.append(eng.submit(p, SERVE_NEW))
        futs[-1].add_done_callback(lambda f, i=i: done.__setitem__(i, time.monotonic()))
    t0 = time.perf_counter()
    eng.start()
    outs = [np.asarray(f.result(timeout=600)) for f in futs]
    secs = time.perf_counter() - t0
    ttft = [f.ttft_s for f in futs]
    tpot = [(done[i] - sent[i] - ttft[i]) / (len(outs[i]) - 1) for i in range(len(outs))]
    return {"outs": outs, "secs": secs, "ttft": ttft, "tpot": tpot,
            "snap": eng.snapshot()}


def _serve_runs(cfg, model, bursts, **kw) -> list:
    """One engine, the bursts in turn: the first cold (each program's
    first call runs eagerly and is captured), the later ones replaying
    its CUDA graphs. Closes the engine (which frees its graphs)."""
    import torch

    eng = _serve_engine(cfg, model, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for prompts in bursts:
        captured = eng.graphs.captures
        runs.append(_burst(eng, prompts))
        runs[-1]["captured"] = eng.graphs.captures - captured
    runs[-1]["peak_gib"] = torch.cuda.max_memory_reserved() / 2**30
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return runs


def _first_difference(model, prompt, got, want) -> str:
    """Where two greedy streams of one prompt part: the first step that
    differs, and at that step the oracle's top-2 logit gap and the largest
    logit difference between the two contexts' next-token logits."""
    import torch

    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    if j >= min(len(got), len(want)):
        return f"lengths {len(got)} vs {len(want)}"
    dev = next(model.parameters()).device
    with torch.no_grad():
        lw = model(torch.as_tensor([list(prompt) + want[:j]], device=dev))[0][0, -1]
        lg = model(torch.as_tensor([list(prompt) + got[:j]], device=dev))[0][0, -1]
    top2 = torch.topk(lw, 2).values
    return (f"first difference at step {j} ({got[j]} vs {want[j]}), top-2 logit gap "
            f"{(top2[0] - top2[1]).item():.3e}, max logit diff "
            f"{(lw - lg).abs().max().item():.3e}")


def _same_tokens(name, model, prompts, got, want) -> int:
    """How many streams of ``got`` equal ``want``; raises at the first
    that differs, with where and by how much."""
    for p, a, b in zip(prompts, got, want):
        if len(a) != len(b) or (a != b).any():
            raise AssertionError(f"[serve] {name}: tokens differ: "
                                 + _first_difference(model, p, a.tolist(), b.tolist()))
    return len(got)


def _decode_tick(cfg, model) -> str:
    """One decode tick at S=16 live rows, each past 256 tokens (the gather
    covers nb=32 blocks = 512 columns): host wall of tick() against the
    device time of its CUDA graph (replayed between CUDA events), the
    share of an eager step's device time that the paged gather takes
    (torch.profiler), and the bytes bound of the step."""
    import numpy as np
    import torch

    rng = np.random.default_rng(12)
    eng = _serve_engine(cfg, model)
    futs = [eng.submit(rng.integers(0, cfg.vocab_size, SERVE_CHUNK), SERVE_TICK_NEW)
            for _ in range(SERVE_SLOTS)]
    while eng.active_slots < SERVE_SLOTS:
        eng.tick()
    for _ in range(3):  # the first tick at this depth captures its graph
        eng.tick()
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.tick()
        host.append((time.perf_counter() - t0) * 1e3)
    nb = eng._gather_depth(1)
    graph = [g for key, g in zip(eng.graphs.keys(), eng.graphs.graphs())
             if key[1][:2] == ("paged_step", (1, nb))]
    if len(graph) != 1:
        raise AssertionError(f"[serve] {len(graph)} graphs for a decode step at nb={nb}")
    dev = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            graph[0].graph.replay()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / 10)
    table, idx, tok = eng._dev(eng._table), eng._dev(eng._pidx), eng._dev(eng._last_tok)
    with torch.no_grad():
        step = _kernel_times(lambda: eng._paged_step(table, idx, tok, k=1, nb=nb), reps=5)
        gather_ms = _time_ms(lambda: eng._virtual_cache(table[:, :nb]), reps=10)
    index_ms = sum(ms for n, ms in step.items() if "index" in n)
    c = cfg
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    cache = 2 * c.num_layers * SERVE_SLOTS * nb * SERVE_BLOCK * c.hidden_size * 4
    bound = (weights + 3 * cache) / H100_BYTES_S * 1e3
    eng.close(drain=False)
    for f in futs:
        if not f.done() or not isinstance(f.exception(), Exception):
            raise AssertionError("[serve] a timed request was not failed by close(drain=False)")
    del eng
    torch.cuda.empty_cache()
    return (f"decode tick at S={SERVE_SLOTS} live rows, depth {SERVE_CHUNK}+ (gather "
            f"nb={nb} blocks = {nb * SERVE_BLOCK} columns): {statistics.median(host):.3f} ms "
            f"host-driven (tick(): table/idx upload, graph replay, token readback, "
            f"bookkeeping), {statistics.median(dev):.3f} ms device (its CUDA graph between "
            f"CUDA events); the paged gather alone {gather_ms:.3f} ms (CUDA events) = "
            f"{gather_ms / statistics.median(dev):.0%} of the step; eager step's device "
            f"time {sum(step.values()):.3f} ms (torch.profiler), of it index kernels "
            f"(the gather, the column writes and the scatter) {index_ms:.3f} ms = "
            f"{index_ms / max(sum(step.values()), 1e-9):.0%}; "
            f"bytes bound {bound:.3f} ms (weights {weights / 1e9:.2f} GB + the virtual "
            f"cache {cache / 1e9:.2f} GB gathered, written and read by attention); top "
            f"kernels: {_breakdown(step, {}, top=4).split('; top: ')[1]}")


def phase_serve(card: str) -> dict:
    """The serving core: ContinuousGPTEngine at GPT-2-small width (paged
    pool, prefix cache, chunked prefill; dense, chained, speculative,
    bf16 and int8 variants) against batch-1 generate, and ServingEngine
    over DeepImageFeaturizer(InceptionV3)'s runner against the
    featurizer's rows."""
    import threading
    from collections import Counter

    import numpy as np
    import torch

    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, generate, init_gpt_
    from sparkdl_torch.models.registry import get_entry
    from sparkdl_torch.ops.stem_fused import inception_stem_fused
    from sparkdl_torch.serving import ServingEngine
    from sparkdl_torch.transformers.named_image import (
        _image_to_rgb_array,
        _named_model_runner,
        _resize_host,
    )

    t_phase = time.perf_counter()
    # GPT-2 small: GPTConfig's widths, the learned position table, dense
    # attention (the continuous engine's per-slot steps are always dense)
    cfg = GPTConfig(positions="learned")
    model = GPTLMHeadModel(cfg, device="cuda")
    model.load_state_dict(init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict())
    model.eval()
    bursts = [_serve_prompts(cfg.vocab_size, seed) for seed in (0, 1)]

    phase_s = {}
    t0 = time.perf_counter()
    _zero_counts()
    main = _serve_runs(cfg, model, bursts)
    launched = _launch_counts()
    if any(launched.values()):
        raise AssertionError(f"[serve] the continuous engine launched kernels: {launched}")
    phase_s["paged"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the oracle for the warm burst, whose every program is a graph replay
    # (eager batch-1 generate is host-bound: ~0.7 s a request); the cold
    # burst is held to the dense engine's below
    dev = model.wte.weight.device
    with torch.inference_mode():
        oracle = [generate(model, torch.as_tensor(p[None], device=dev).long(),
                           SERVE_NEW)[0, len(p):].cpu().numpy() for p in bursts[1]]
    _same_tokens("paged engine, warm burst vs batch-1 generate", model, bursts[1],
                 main[1]["outs"], oracle)
    phase_s["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs = {}
    for name, kw in (("dense", dict(kv_layout="dense")), ("chain8", dict(chain_tokens=8)),
                     ("spec4", dict(spec_k=4))):
        runs[name] = _serve_runs(cfg, model, bursts, **kw)
        for b, (prompts, run, ref) in enumerate(zip(bursts, runs[name], main)):
            _same_tokens(f"{name} burst {b} vs paged", model, prompts, run["outs"],
                         ref["outs"])
    quant = {}
    for dt in ("bf16", "int8"):
        a = _serve_runs(cfg, model, bursts, kv_dtype=dt)
        b = _serve_runs(cfg, model, bursts, kv_dtype=dt)
        if any((x != y).any() for ra, rb in zip(a, b)
               for x, y in zip(ra["outs"], rb["outs"])):
            raise AssertionError(f"[serve] kv_dtype={dt}: two runs differ")
        agree = np.mean(np.concatenate([x == y for x, y in zip(a[1]["outs"], oracle)]))
        quant[dt] = (agree, a)
    phase_s["variants"] = time.perf_counter() - t0
    warm, kv = main[1], main[1]["snap"]["kv"]
    gs, spec = warm["snap"]["graphs"], runs["spec4"][1]["snap"]["spec"]
    total = SERVE_REQS * SERVE_NEW
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    hits0 = main[0]["snap"]["kv"]["prefix_hits"]
    print(f"[serve] ContinuousGPTEngine GPT-2 small ({cfg.num_layers}x{cfg.hidden_size}, "
          f"learned positions, float32, TF32 off, random init seed 0), n_slots "
          f"{SERVE_SLOTS}, max_len {SERVE_MAX_LEN}, paged pool of {kv['blocks_total']} "
          f"blocks x {SERVE_BLOCK} tokens "
          f"({kv['blocks_total'] * SERVE_BLOCK * kv['bytes_per_token'] / 1e6:.0f} MB), "
          f"prefill_chunk {SERVE_CHUNK}; bursts of {SERVE_REQS} requests of 8..256 "
          f"prompt tokens through the daemon loop ({SERVE_SHARED} share a "
          f"{SERVE_PREFIX}-token prefix), {SERVE_NEW} greedy tokens each, the first burst "
          f"cold (each program's first call eager, then captured), the second (new "
          f"prompts, seed 1) on the captured graphs; {card}: warm "
          f"{total / warm['secs']:.1f} tokens/s ({warm['secs']:.2f} s; cold "
          f"{total / main[0]['secs']:.1f}), TTFT p50 {pct(warm['ttft'], 50) * 1e3:.1f} ms "
          f"p99 {pct(warm['ttft'], 99) * 1e3:.1f} ms, {np.median(warm['tpot']) * 1e3:.2f} "
          f"ms per output token after the first (median over requests), prefix-hit "
          f"tokens {hits0} cold + {kv['prefix_hits'] - hits0} warm, {kv['prefill_chunks']} "
          f"prefill chunks, graphs {gs['captured']} captured in {gs['capture_s']:.2f} s "
          f"({gs['cached']} cached, pools {gs['pool_bytes'] / 2**20:.0f} MB), peak "
          f"reserved {main[1]['peak_gib']:.2f} GiB; kernel launches 0 (the per-slot "
          f"steps are the dense masked path)")
    print(f"[serve] tokens equal to batch-1 generate in {SERVE_REQS}/{SERVE_REQS} "
          f"requests of the warm burst; dense layout, chain_tokens=8 and spec_k=4 each "
          f"equal to the paged run's in {2 * SERVE_REQS}/{2 * SERVE_REQS} (both bursts); warm "
          + ", ".join(f"{n} {total / r[1]['secs']:.1f} tokens/s" for n, r in runs.items())
          + f" (graphs captured during the warm burst: " + ", ".join(
              f"{n} {r[1]['captured']}" for n, r in (("paged", main), *runs.items()))
          + f"); spec acceptance {spec['acceptance_rate']} ({spec['accepted']}/"
          f"{spec['proposed']} drafts, {spec['tokens_per_dispatch']} tokens a verify); "
          + "; ".join(f"kv_dtype={dt}: two engines' runs bitwise equal, {agree:.1%} of "
                      f"the warm burst's tokens equal to generate's (bar "
                      f"{SERVE_QUANT_AGREE:.0%}), warm "
                      f"{total / r[1]['secs']:.1f} tokens/s" for dt, (agree, r) in quant.items()))
    for dt, (agree, _) in quant.items():
        if agree < SERVE_QUANT_AGREE:
            raise AssertionError(f"[serve] kv_dtype={dt}: {agree:.1%} of tokens equal "
                                 f"to generate's, under {SERVE_QUANT_AGREE:.0%}")
    t0 = time.perf_counter()
    print(f"[serve] {_decode_tick(cfg, model)}")
    phase_s["tick"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    del model
    torch.cuda.empty_cache()

    # ServingEngine over the featurizer's own runner, 8 closed-loop clients
    rows, want = _featurizer_rows()
    runner = _named_model_runner("InceptionV3", "random", False, "features", BATCH,
                                 "cuda")
    sizes = []

    class _Counted:
        """The runner, counting the rows of each batch it is handed."""
        chunk_size = runner.chunk_size
        max_inflight_batches = runner.max_inflight_batches

        @staticmethod
        def run_batch_async(arrays):
            sizes.append(len(arrays["img"]))
            return runner.run_batch_async(arrays)

    size = get_entry("InceptionV3").input_size  # the featurizer's own extract
    eng = ServingEngine(_Counted(), max_wait_s=SERVE_WAIT_S, extract=lambda s: {
        "img": _resize_host(_image_to_rgb_array(s), size)})
    got, errs = {}, []

    def client(ids):
        try:
            for i in ids:
                got[i] = eng.submit(rows[i]["image"]).result(timeout=120)
        except Exception as e:  # reported below: a client must not die silently
            errs.append(e)

    _zero_counts()
    threads = [threading.Thread(target=client, args=(range(j, N_ROWS, SERVE_THREADS),))
               for j in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    secs = time.perf_counter() - t0
    stem_launches = inception_stem_fused.launches
    esnap = eng.snapshot()
    eng.close()
    if errs or len(got) != N_ROWS or any(th.is_alive() for th in threads):
        raise AssertionError(f"[serve] ServingEngine: {len(got)}/{N_ROWS} answers, {errs[:3]}")
    worst = max(_rel_err(torch.as_tensor(got[i]), torch.as_tensor(want[i]))[1]
                for i in range(N_ROWS))
    if worst > NET_TOL:
        raise AssertionError(f"[serve] ServingEngine answers vs the featurizer's rows: "
                             f"rel err {worst:.2e} > {NET_TOL}")
    if stem_launches != len(sizes):
        raise AssertionError(f"[serve] stem launches {stem_launches} for {len(sizes)} batches")
    lat = esnap["latency_s"]
    print(f"[serve] ServingEngine over DeepImageFeaturizer(InceptionV3)'s runner, "
          f"{N_ROWS} single-image requests from {SERVE_THREADS} closed-loop client "
          f"threads, max_wait_s {SERVE_WAIT_S}; {card}: {N_ROWS / secs:.1f} requests/s, "
          f"latency p50 {lat['p50'] * 1e3:.1f} ms p99 {lat['p99'] * 1e3:.1f} ms; "
          f"{len(sizes)} batches of sizes {dict(sorted(Counter(sizes).items()))}; "
          f"inception_stem_fused launches {stem_launches} (one a batch); answers vs the "
          f"featurizer's rows rel err {worst:.2e} (tol {NET_TOL})")
    phase_s["serving_engine"] = time.perf_counter() - t0
    print(f"[serve] phase {time.perf_counter() - t_phase:.1f} s: " + ", ".join(
        f"{n} {s:.1f} s" for n, s in phase_s.items()))
    return {"tokens_s": total / warm["secs"], "ttft_ms": pct(warm["ttft"], 50) * 1e3,
            "requests_s": N_ROWS / secs, "p99_ms": lat["p99"] * 1e3,
            "rows": rows, "want": want}


REPLICAS, REPLICA_FAULTS = 2, 3  # replicas on the one card; failed dispatches injected
REPLICA_PROBATION_S = 0.1
TIER_SESSIONS, TIER_NEW, TIER_FRESH = 8, 32, 8    # sessions, tokens a turn, new prompt tokens a turn
TIER_HOST_BLOCKS, TIER_DISK_BLOCKS = 32, 512      # the host tier smaller than turn 1's cold blocks
TIER_TIMED_BLOCKS = 20
H100_HOST_BYTES_S = 64e9  # PCIe 5.0 x16, one direction: the card's link to host memory


class _FailingRunner:
    """A replica's runner whose next ``failures`` dispatches raise, as an
    executor that dies on a dispatch would (the pool's replica.execute
    failure path)."""

    def __init__(self, runner, failures: int):
        self.runner, self.left, self.failed = runner, failures, 0
        self.chunk_size = runner.chunk_size
        self._lock = threading.Lock()

    def run_batch(self, arrays):
        with self._lock:
            fail = self.left > 0
            self.left -= fail
            self.failed += fail
        if fail:
            raise RuntimeError("injected replica.execute failure")
        return self.runner.run_batch(arrays)


def _closed_loop(eng, rows, ids, threads: int, lat: "dict | None" = None) -> tuple:
    """``ids`` requests from ``threads`` closed-loop client threads:
    (answers by id, errors, seconds); each request's seconds in ``lat``."""
    got, errs = {}, []

    def client(part):
        try:
            for i in part:
                sent = time.perf_counter()
                got[i] = eng.submit(rows[i]["image"]).result(timeout=120)
                if lat is not None:
                    lat[i] = time.perf_counter() - sent
        except Exception as e:  # reported by the caller: a client must not die silently
            errs.append(e)

    workers = [threading.Thread(target=client, args=(ids[j::threads],))
               for j in range(threads)]
    t0 = time.perf_counter()
    for th in workers:
        th.start()
    for th in workers:
        th.join(300)
    if any(th.is_alive() for th in workers):
        raise AssertionError("a serving client thread did not finish")
    return got, errs, time.perf_counter() - t0


def phase_replicas(card: str, served: dict) -> dict:
    """ServingEngine over a ReplicaPool of REPLICAS DeepImageFeaturizer
    (InceptionV3) runners on the one card: every bucket warmed on every
    replica, then [serve]'s 256 single-image requests from its 8 closed-loop
    clients (stem launches = the micro-batches summed over the replicas),
    then the same traffic with one replica's next REPLICA_FAULTS dispatches
    failing (no request lost, a quarantine, a probation recovery)."""
    import numpy as np
    import torch

    from sparkdl_torch.models.registry import get_entry
    from sparkdl_torch.ops.stem_fused import inception_stem_fused
    from sparkdl_torch.serving import ReplicaPool, ServingEngine
    from sparkdl_torch.transformers.named_image import (
        _image_to_rgb_array,
        _named_model_runner,
        _resize_host,
    )

    t_phase = time.perf_counter()
    rows, want = served["rows"], served["want"]
    size = get_entry("InceptionV3").input_size
    extract = lambda s: {"img": _resize_host(_image_to_rgb_array(s), size)}  # noqa: E731
    runners = []

    def make_runner(device):
        # the featurizer's runner, built anew per replica (bypassing its
        # per-process cache): own CUDA graphs, own buckets
        runner = _named_model_runner.__wrapped__("InceptionV3", "random", False,
                                                 "features", BATCH, str(device))
        runners.append(_FailingRunner(runner, 0))
        return runners[-1]

    pool = ReplicaPool(make_runner=make_runner, n_replicas=REPLICAS,
                       max_failures=2, probation_s=REPLICA_PROBATION_S)
    devices = sorted({str(r.device) for r in pool.replicas})
    t0 = time.perf_counter()
    _zero_counts()
    img = extract(rows[0]["image"])["img"]
    buckets = runners[0].runner._buckets
    for b in buckets:  # every bucket's graph on every replica before traffic
        pool.warmup({"img": np.repeat(img[None], b, axis=0)})
    warm_s = time.perf_counter() - t0
    warm_launches = inception_stem_fused.launches
    warm_batches = sum(r["dispatched"] for r in pool.snapshot()["replicas"])

    eng = ServingEngine(pool, max_wait_s=SERVE_WAIT_S, extract=extract)
    _zero_counts()
    before = [r["dispatched"] for r in pool.snapshot()["replicas"]]
    got, errs, secs = _closed_loop(eng, rows, list(range(N_ROWS)), SERVE_THREADS)
    stem_launches = inception_stem_fused.launches
    snap = eng.snapshot()
    per_replica = [r["dispatched"] - b for r, b in zip(snap["replicas"], before)]
    if errs or len(got) != N_ROWS:
        raise AssertionError(f"[replicas] {len(got)}/{N_ROWS} answers, {errs[:3]}")
    diffs = [(torch.as_tensor(got[i]) - torch.as_tensor(want[i])).abs().max().item()
             for i in range(N_ROWS)]
    worst = max(_rel_err(torch.as_tensor(got[i]), torch.as_tensor(want[i]))[1]
                for i in range(N_ROWS))
    if worst > NET_TOL:
        raise AssertionError(f"[replicas] answers vs the featurizer's rows: rel err "
                             f"{worst:.2e} > {NET_TOL}")
    if stem_launches != sum(per_replica) or min(per_replica) == 0:
        raise AssertionError(f"[replicas] stem launches {stem_launches} for batches "
                             f"{per_replica} per replica")
    if warm_launches != warm_batches:
        raise AssertionError(f"[replicas] warmup: stem launches {warm_launches} for "
                             f"{warm_batches} batches")
    lat = snap["latency_s"]
    # T2: one micro-batch through each replica's runner, the same rows
    probe = {"img": np.stack([extract(rows[i]["image"])["img"]
                              for i in range(min(8, BATCH))])}
    outs = [r.runner.run_batch(probe) for r in runners]
    cross = max(float(np.abs(o - outs[0]).max()) for o in outs[1:])
    print(f"[replicas] ServingEngine over ReplicaPool(n_replicas={REPLICAS}) on "
          f"{', '.join(devices)}, each replica DeepImageFeaturizer(InceptionV3, "
          f"weights='random')'s runner (own CUDA graphs), warmed over buckets "
          f"{list(buckets)} in {warm_s:.1f} s (stem launches {warm_launches} = "
          f"{warm_batches} warmup batches); {N_ROWS} single-image requests from "
          f"{SERVE_THREADS} closed-loop client threads, max_wait_s {SERVE_WAIT_S}; "
          f"{card}: {N_ROWS / secs:.1f} requests/s, latency p50 {lat['p50'] * 1e3:.1f} ms "
          f"p99 {lat['p99'] * 1e3:.1f} ms; batches per replica {per_replica}, "
          f"inception_stem_fused launches {stem_launches} (= {sum(per_replica)} "
          f"micro-batches); answers vs the featurizer's rows rel err {worst:.2e} (tol "
          f"{NET_TOL}), largest abs difference {max(diffs):.3e}, bitwise equal in "
          f"{sum(d == 0 for d in diffs)}/{N_ROWS}; one {len(probe['img'])}-row micro-batch on each "
          f"replica's runner: largest difference between replicas {cross:.3e} "
          f"({'bitwise equal' if cross == 0 else 'NOT bitwise equal'})")

    # one replica's executor fails its next REPLICA_FAULTS dispatches
    quarantined0 = _metric("sparkdl_replica_quarantined_total")
    rejoined0 = _metric("sparkdl_replica_reintegrated_total")
    rerouted0 = _metric("sparkdl_retries_total", site="replica.execute",
                        outcome="retried")
    victim = runners[-1]
    victim.left = REPLICA_FAULTS
    failed0 = snap["failed"]
    got, errs, fsecs = _closed_loop(eng, rows, list(range(N_ROWS)), SERVE_THREADS)
    deadline = time.monotonic() + 30
    extra = 0
    while (_metric("sparkdl_replica_reintegrated_total") == rejoined0
           and time.monotonic() < deadline):
        # traffic carries the probation probe: keep it flowing until it lands
        more, more_errs, _ = _closed_loop(eng, rows, list(range(16)), 2)
        errs += more_errs
        extra += len(more)
    fsnap = eng.snapshot()
    eng.close()
    pool.close()
    quarantines = _metric("sparkdl_replica_quarantined_total") - quarantined0
    rejoins = _metric("sparkdl_replica_reintegrated_total") - rejoined0
    rerouted = _metric("sparkdl_retries_total", site="replica.execute",
                       outcome="retried") - rerouted0
    lost = N_ROWS - len(got) + len(errs) + fsnap["failed"] - failed0
    if lost or victim.failed != REPLICA_FAULTS or quarantines < 1 or rejoins < 1:
        raise AssertionError(
            f"[replicas] faults: {lost} requests lost ({errs[:3]}), {victim.failed} "
            f"failed dispatches, {quarantines} quarantines, {rejoins} reintegrations")
    worst_f = max(_rel_err(torch.as_tensor(got[i]), torch.as_tensor(want[i]))[1]
                  for i in range(N_ROWS))
    if worst_f > NET_TOL:
        raise AssertionError(f"[replicas] faults: rel err {worst_f:.2e} > {NET_TOL}")
    print(f"[replicas] replica {len(runners) - 1}'s next {REPLICA_FAULTS} dispatches "
          f"fail (max_failures 2, probation_s {REPLICA_PROBATION_S}), the same "
          f"{N_ROWS} requests + {extra} more until the probe rejoins it; {card}: "
          f"{N_ROWS / fsecs:.1f} requests/s; 0 requests lost, {int(rerouted)} "
          f"re-routed micro-batches, {int(quarantines)} quarantine(s), "
          f"{int(rejoins)} probation reintegration(s); answers rel err {worst_f:.2e}; "
          f"batches per replica {[r['dispatched'] for r in fsnap['replicas']]}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"requests_s": N_ROWS / secs, "p50_ms": lat["p50"] * 1e3,
            "p99_ms": lat["p99"] * 1e3, "batches": per_replica,
            "stem_launches": stem_launches}


def _metric(name: str, **labels) -> float:
    from sparkdl_torch.observability.registry import registry

    fam = registry().get(name)
    if fam is None:
        return 0.0
    key = ",".join(f'{k}="{v}"' for k, v in labels.items())
    return fam.snapshot_values().get(key, 0.0)


def _tier_prompts(vocab: int) -> list:
    import numpy as np

    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, int(rng.integers(64, 129))).tolist()
            for _ in range(TIER_SESSIONS)]


def _tier_turn(eng, prompts) -> list:
    """One turn of every session, manual ticks (one schedule for every
    engine with the same settings): the greedy replies."""
    import numpy as np

    futs = [eng.submit(p, TIER_NEW) for p in prompts]
    while not all(f.done() for f in futs):
        eng.tick()
    return [np.asarray(f.result()) for f in futs]


def _tier_next(prompts, replies, turn: int) -> list:
    """Each session's next prompt: its last prompt, its reply, and
    TIER_FRESH new user tokens."""
    import numpy as np

    rng = np.random.default_rng(100 + turn)
    return [p + r.tolist() + rng.integers(0, 50000, TIER_FRESH).tolist()
            for p, r in zip(prompts, replies)]


def _tier_block_times(eng, store_dir: str) -> dict:
    """Per-block park (D2H into page-locked memory), unpark (H2D into a
    fresh block, synchronized), spill (codec + write + fsync + rename) and
    load (read + sha256 + decode) ms: medians of TIER_TIMED_BLOCKS blocks
    of this quiescent engine's cached blocks."""
    import statistics

    import torch

    from sparkdl_torch.serving.kv_tiers import TieredKVStore

    bids = list(eng._prefix._registered)[:TIER_TIMED_BLOCKS]
    park, unpark, spill, load, payloads = [], [], [], [], []
    spare = eng._pool.allocate(1)[0]
    for bid in bids:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl = eng._park_payload(bid)
        park.append((time.perf_counter() - t0) * 1e3)
        payloads.append(pl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not eng._install_parked(spare, pl):
            raise AssertionError("[tiers] timed unpark failed")
        torch.cuda.synchronize()
        unpark.append((time.perf_counter() - t0) * 1e3)
        for name, t in eng._raw_block(spare).items():
            if not torch.equal(t, eng._raw_block(bid)[name]):
                raise AssertionError(f"[tiers] unparked {name} differs from its source")
    eng._pool.release(eng._pool.deref([spare]))
    store = TieredKVStore(1, len(payloads) + 1, spill_dir=store_dir)
    for i, pl in enumerate(payloads):
        t0 = time.perf_counter()
        store._spill(("timed", i), pl)
        spill.append((time.perf_counter() - t0) * 1e3)
    for i in range(len(payloads)):
        t0 = time.perf_counter()
        store._load(store._disk[("timed", i)])
        load.append((time.perf_counter() - t0) * 1e3)
    store.close()
    nbytes = sum(v.nbytes for v in payloads[0].values())
    return {"park_ms": statistics.median(park), "unpark_ms": statistics.median(unpark),
            "spill_ms": statistics.median(spill), "load_ms": statistics.median(load),
            "bytes": nbytes, "bound_ms": nbytes / H100_HOST_BYTES_S * 1e3}


def phase_tiers(card: str) -> dict:
    """ContinuousGPTEngine at GPT-2-small width, paged, with a host tier
    and a disk tier: per kv_dtype, TIER_SESSIONS three-turn sessions. Engine
    A parks every cold block between turns 1 and 2 (some spill to disk),
    engine B (the same settings) never parks: their turn 2 bitwise equal.
    A parks again and exports every parked session; engine C imports them:
    its turn 3 bitwise B's. Park/unpark fallbacks 0 in every engine; per-block
    park/unpark/spill/load ms against the bytes' bound at the host link."""
    import tempfile

    import numpy as np
    import torch

    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, init_gpt_

    t_phase = time.perf_counter()
    cfg = GPTConfig(positions="learned")
    model = GPTLMHeadModel(cfg, device="cuda")
    model.load_state_dict(init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict())
    model.eval()
    prompts = _tier_prompts(cfg.vocab_size)
    out, lines = {}, []
    with tempfile.TemporaryDirectory(prefix="sparkdl-chip-tiers-") as tmp:
        for dt in ("fp32", "bf16", "int8"):
            t0 = time.perf_counter()
            tiers = dict(kv_dtype=dt, host_kv_blocks=TIER_HOST_BLOCKS,
                         disk_kv_blocks=TIER_DISK_BLOCKS)
            engs = {n: _serve_engine(cfg, model, kv_spill_dir=os.path.join(tmp, f"{dt}-{n}"),
                                     **tiers) for n in "ABC"}
            a, b, c = engs["A"], engs["B"], engs["C"]
            _zero_counts()
            turn1 = [_tier_turn(e, prompts) for e in (a, b)]
            if any((x != y).any() for x, y in zip(*turn1)):
                raise AssertionError(f"[tiers] {dt}: turn 1 differs between A and B")
            p2 = _tier_next(prompts, turn1[0], 2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            parked = a.park_cold()
            torch.cuda.synchronize()
            park_s = time.perf_counter() - t1
            st = a._kv_snapshot()["tiers"]
            if st["disk_blocks"] == 0 or st["host_blocks"] == 0:
                raise AssertionError(f"[tiers] {dt}: parked {st}: nothing reached "
                                     "both tiers")
            got2, want2 = _tier_turn(a, p2), _tier_turn(b, p2)
            same2 = sum((x == y).all() for x, y in zip(got2, want2))
            resumed = a._kv_snapshot()["tiers"]["unparks"]
            p3 = _tier_next(p2, want2, 3)
            a.park_cold()
            t1 = time.perf_counter()
            bundle = a.export_parked_sessions()
            blob = json.dumps(bundle)
            export_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            adopted = c.import_parked_sessions(json.loads(blob))
            import_s = time.perf_counter() - t1
            got3, want3 = _tier_turn(c, p3), _tier_turn(b, p3)
            same3 = sum((x == y).all() for x, y in zip(got3, want3))
            fallbacks = {n: e._kv_snapshot()["tiers"]["park_fallbacks"]
                         for n, e in engs.items()}
            cunparks = c._kv_snapshot()["tiers"]["unparks"]
            launched = _launch_counts()
            times = _tier_block_times(b, os.path.join(tmp, f"{dt}-timed"))
            for e in engs.values():
                e.close()
            if same2 != TIER_SESSIONS or same3 != TIER_SESSIONS:
                raise AssertionError(f"[tiers] {dt}: resumed turns equal to never-parked "
                                     f"in {same2} (turn 2) and {same3} (turn 3, imported) "
                                     f"of {TIER_SESSIONS}")
            if any(fallbacks.values()) or adopted != TIER_SESSIONS or not cunparks:
                raise AssertionError(f"[tiers] {dt}: fallbacks {fallbacks}, {adopted} "
                                     f"sessions adopted, {cunparks} unparks on C")
            if any(launched.values()):
                raise AssertionError(f"[tiers] the continuous engine launched kernels: "
                                     f"{launched}")
            out[dt] = times
            lines.append(
                f"[tiers] kv_dtype={dt}: park_cold() parked {parked} blocks in "
                f"{park_s * 1e3:.1f} ms ({st['host_blocks']} host, {st['disk_blocks']} "
                f"disk); turn 2 resumed {resumed} blocks, tokens bitwise the "
                f"never-parked engine's in {same2}/{TIER_SESSIONS} sessions; exported "
                f"{len(bundle['sessions'])} sessions ({len(blob) / 1e6:.1f} MB of JSON) in "
                f"{export_s:.2f} s, {adopted} adopted by a second engine in "
                f"{import_s:.2f} s, whose turn 3 ({cunparks} blocks "
                f"unparked) is bitwise the never-parked engine's in "
                f"{same3}/{TIER_SESSIONS}; park/unpark fallbacks 0; per block "
                f"({times['bytes']} B): park (D2H) {times['park_ms']:.3f} ms, unpark "
                f"(H2D) {times['unpark_ms']:.3f} ms, bound {times['bound_ms']:.4f} ms "
                f"at {H100_HOST_BYTES_S / 1e9:.0f} GB/s; spill {times['spill_ms']:.2f} "
                f"ms, load {times['load_ms']:.2f} ms; {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    print(f"[tiers] ContinuousGPTEngine GPT-2 small ({cfg.num_layers}x{cfg.hidden_size}, "
          f"random init seed 0), paged, n_slots {SERVE_SLOTS}, block {SERVE_BLOCK}, "
          f"host_kv_blocks {TIER_HOST_BLOCKS}, disk_kv_blocks {TIER_DISK_BLOCKS} (a "
          f"temporary kv_spill_dir); {TIER_SESSIONS} sessions of 64..128 prompt tokens, "
          f"{TIER_NEW} greedy tokens a turn, {TIER_FRESH} new tokens a next turn; {card}")
    for line in lines:
        print(line)
    print(f"[tiers] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _profile_batch(logdir: str) -> list:
    """trace() around one featurizer batch of BATCH on an eager runner over
    the featurizer's apply (chain_k=1: no graphs), then around a CUDA-graph
    replay of the same batch: per window the trace's size, event and
    kernel counts, the stem kernel events, the annotate()d range events and
    the stem launches the wrapper counted."""
    import numpy as np

    from sparkdl_torch.models.registry import get_entry
    from sparkdl_torch.observability.profiling import annotate, trace
    from sparkdl_torch.ops.stem_fused import inception_stem_fused
    from sparkdl_torch.transformers._inference import BatchedRunner
    from sparkdl_torch.transformers.named_image import _named_model_runner

    size = get_entry("InceptionV3").input_size
    graphed = _named_model_runner.__wrapped__("InceptionV3", "random", False,
                                              "features", BATCH, "cuda")
    eager = BatchedRunner(graphed.apply_fn, batch_size=BATCH, device="cuda", chain_k=1)
    batch = {"img": np.random.default_rng(5).integers(0, 256, (BATCH, *size, 3),
                                                      dtype=np.uint8)}
    graphed.run_batch(batch)  # captured here, replayed in the second window
    found = []
    for runner in (eager, graphed):
        _zero_counts()
        with trace(logdir) as cap, annotate("sparkdl.featurize_batch"):
            feats = runner.run_batch(batch)
        with open(cap.path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        found.append({
            "mb": os.path.getsize(cap.path) / 1e6, "events": len(events),
            "kernels": len(kernels), "finite": bool(np.isfinite(feats).all()),
            "launches": inception_stem_fused.launches,
            "memcpys": sum(e.get("cat") == "gpu_memcpy" for e in events),
            "device_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
            "stem": [e for e in kernels if "stem_fused_kernel" in e.get("name", "")],
            "ranges": [e for e in events if e.get("name") == "sparkdl.featurize_batch"]})
    return found


SP_SLOTS, SP_MAX_LEN, SP_BLOCK, SP_CHUNK = 8, 1024, 16, 256
SP_REQS, SP_NEW, SP_PREFIX = 8, 32, 256
SP_FAULTS = "sp.permute:OSError@3;sp.gather:OSError@2"  # one of each


def _sp_prompts(vocab: int, seed: int) -> list:
    """SP_REQS prompts of 512..960 tokens (the same lengths for every
    seed, so a second burst replays the first one's graphs), tokens from
    ``seed``; the first two open with one fixed SP_PREFIX-token prefix."""
    import numpy as np

    lens = np.random.default_rng(100).integers(512, 961, SP_REQS)
    lens[0] = 960  # one prompt of four chunks: 256 x 3 + 192
    prefix = np.random.default_rng(101).integers(0, vocab, SP_PREFIX)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(n)) for n in lens]
    for i in (0, 1):
        prompts[i][:SP_PREFIX] = prefix
    return prompts


def _sp_placement(sp: int, cards: bool) -> list:
    """sp shards on sp cards, or all of them on cuda:0."""
    import torch

    if cards and torch.cuda.device_count() < sp:
        raise AssertionError(f"[sp_serve] sp={sp} needs {sp} cards, "
                             f"{torch.cuda.device_count()} visible")
    return [torch.device("cuda", i if cards else 0) for i in range(sp)]


def _sp_engine(cfg, model, sp: int, devices=None, **kw):
    """A ContinuousGPTEngine for [sp_serve]; ``devices`` (when given)
    replaces the engine's own placement of its sp shards."""
    from sparkdl_torch.serving import ContinuousGPTEngine

    cls = ContinuousGPTEngine
    if devices is not None:
        class Placed(ContinuousGPTEngine):
            @staticmethod
            def _sp_devices(device, n):
                return list(devices)
        cls = Placed
    kw.setdefault("n_slots", SP_SLOTS)
    return cls(cfg, model, max_len=SP_MAX_LEN, kv_block_size=SP_BLOCK,
               prefill_chunk=SP_CHUNK, sp=sp, auto_start=False, **kw)


def _sp_timed(eng, devices) -> dict:
    """Wrap an engine's prefill chunks (the sp chunk, or the sp=1 chunk
    programs' graph replays) and sp handoffs in CUDA events recorded on
    every device's current stream: ``{"chunk": [...], "handoff": [...]}``
    of (start events, end events) by device."""
    import torch

    devs = sorted(set(devices), key=str)
    marks = {"chunk": [], "handoff": []}

    def events():
        out = {}
        for d in devs:
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(d))
            out[d] = e
        return out

    def timed(kind, fn):
        def call(*a, **k):
            start = events()
            out = fn(*a, **k)
            marks[kind].append((start, events()))
            return out
        return call

    if eng.sp > 1:
        eng._sp_chunk = timed("chunk", eng._sp_chunk)
        eng._sp_handoff = timed("handoff", eng._sp_handoff)
    else:
        run = eng._run
        chunk = timed("chunk", run)
        eng._run = lambda name, *a, **k: (chunk if name.startswith("chunk")
                                          else run)(name, *a, **k)
    return marks


def _sp_ms(marks: list) -> dict:
    """Per device: the median and the sum of end - start ms over the
    marked calls."""
    import torch

    if not marks:
        return {}
    for d in marks[0][0]:
        torch.cuda.synchronize(d)
    out = {}
    for d in marks[0][0]:
        ms = [a[d].elapsed_time(b[d]) for a, b in marks]
        out[str(d)] = (statistics.median(ms), sum(ms))
    return out


def _sp_final_logits(cfg, model, prompt, sp: int, devices) -> "torch.Tensor":
    """``prompt``'s final prefill chunk's float32 logits [r, vocab] on
    cuda:0: at sp=1 from the single-device chunk (eager, so the logits
    can be read), above it from the sp chunk."""
    import torch

    eng = _sp_engine(cfg, model, sp, devices, n_slots=1)
    got = []
    if sp == 1:
        eng._graphed = False
        inner = eng._chunk_logits

        def keep(*a, **k):
            out = inner(*a, **k)
            got.append(out[0])
            return out
        eng._chunk_logits = keep
    else:
        inner = eng._sp_chunk

        def keep(*a, **k):
            out = inner(*a, **k)
            if out is not None:
                got.append(torch.cat([o.to("cuda:0") for o in out]))
            return out
        eng._sp_chunk = keep
    fut = eng.submit(prompt, 1)
    while not fut.done():
        eng.tick()
    fut.result()
    eng.close()
    r = len(prompt) % SP_CHUNK or SP_CHUNK
    return got[-1][:r]


def _linear_rows(fn) -> dict:
    """{device: rows of each dense layer's input} over one call of ``fn``
    (the q/k/v, output, MLP and head products; attention's bmm left
    out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen: dict = {}

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("linear", "mm", "addmm"):
                x = args[1] if name == "addmm" else args[0]
                seen.setdefault(str(x.device), []).append(x.numel() // x.shape[-1])
            return func(*args, **(kwargs or {}))

    with Mode():
        fn()
    return seen


def _kernel_ms_by_device(fn) -> dict:
    """torch.profiler's CUDA kernel time (ms) on each device while
    ``fn`` runs; empty when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time", None)
        us = us if us is not None else getattr(e, "cuda_time", 0.0)
        out[e.device_index] = out.get(e.device_index, 0.0) + us / 1e3
    return out


SP_DELAY_CYCLES = 100_000_000  # torch.cuda._sleep: tens of ms at the H100's clocks


def _fetch_waits_for_its_card(devices) -> float:
    """start_fetch of a scalar written on the last card behind a
    SP_DELAY_CYCLES spin on that card's stream, with cuda:0 current (as
    the engine's thread has it): the value must be the one written (a
    fresh one, which no earlier pinned buffer can hold). Returns the
    host's wait in ms."""
    import numpy as np
    import torch

    from sparkdl_torch.runtime.completion import start_fetch

    last = devices[-1]
    value = int(np.random.default_rng().integers(1 << 40, 1 << 50))
    x = torch.zeros((), dtype=torch.long, device=last)
    torch.cuda.synchronize(last)
    with torch.cuda.device(last):
        torch.cuda._sleep(SP_DELAY_CYCLES)
        x.fill_(value)
    assert torch.cuda.current_device() == 0
    t0 = time.perf_counter()
    got = int(start_fetch(x).result())
    waited = (time.perf_counter() - t0) * 1e3
    if got != value:
        raise AssertionError(f"[sp_serve] start_fetch of a scalar on {last} with cuda:0 "
                             f"current read {got}, not {value}: it did not wait for "
                             f"{last}'s stream")
    return waited


def _sp_late_shard_token(cfg, model, prompt, sp: int) -> int:
    """``prompt``'s first generated token through an sp engine over the
    cards whose final chunk's last real row sits on a shard past the
    first, with every card but cuda:0 spinning SP_DELAY_CYCLES on its
    stream after the chunk: the token is read across cards while the
    engine's thread keeps cuda:0 current."""
    import torch

    from sparkdl_torch.runtime.batching import pow2_bucket

    eng = _sp_engine(cfg, model, sp, n_slots=1)
    r = len(prompt) % SP_CHUNK or SP_CHUNK
    shard = (r - 1) // (pow2_bucket(r, max(8, sp), eng._chunk_cap) // sp)
    if shard < 1:
        raise AssertionError(f"[sp_serve] sp={sp}: the last real row is on shard {shard}")
    inner = eng._sp_chunk

    def late(*a, **k):
        out = inner(*a, **k)
        if out is not None:
            for d in eng._sp_devs[1:]:
                with torch.cuda.device(d):
                    torch.cuda._sleep(SP_DELAY_CYCLES)
        return out
    eng._sp_chunk = late
    fut = eng.submit(prompt, 1)
    while not fut.done():
        eng.tick()
    eng.close()
    return int(fut.result()[0])


@contextlib.contextmanager
def _env_unset(name: str):
    """``name`` out of the environment for the block, then put back."""
    saved = os.environ.pop(name, None)
    try:
        yield
    finally:
        if saved is not None:
            os.environ[name] = saved


def phase_sp_serve(card: str, sps=(2,), cards: bool = False) -> dict:
    """The continuous engine's sequence-parallel prefill at GPT-2 small's
    full width: ``sp=1`` (the single-device path, its chunks CUDA graphs)
    against each ``sp`` in ``sps`` (eager chunks whose query rows split
    over the shards' devices: every shard on cuda:0, or with ``cards`` one
    card a shard), each over two bursts of the same SP_REQS prompts'
    lengths (the second on captured graphs and cached prefixes). Tokens
    equal across sp and to batch-1 generate, the final chunk's logits
    within LOGIT_TOL of sp=1's, every request handed off and the staging
    pool drained, no request lost under one injected ``sp.permute`` and
    one ``sp.gather`` fault, and no kernel launched (the engine's chunks
    and steps are the dense masked path).

    It runs with CUBLAS_WORKSPACE_CONFIG unset: torch reads the variable
    on every cuBLAS call, ~50 us of host time a call where it is set
    (``tools/cublas_env_probe.py``), which the eager sp chunk would pay on
    each dense product; the phase uses no deterministic algorithm, which
    is what main() sets it for."""
    with _env_unset("CUBLAS_WORKSPACE_CONFIG"):
        return _sp_serve(card, sps, cards)


def _sp_serve(card: str, sps, cards: bool) -> dict:
    """The body of :func:`phase_sp_serve`."""
    import numpy as np
    import torch

    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, generate, init_gpt_
    from sparkdl_torch.observability.flight import flight_recorder
    from sparkdl_torch.reliability import faults

    t_phase = time.perf_counter()
    cfg = GPTConfig(positions="learned")
    model = GPTLMHeadModel(cfg, device="cuda")
    model.load_state_dict(init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict())
    model.eval()
    bursts = [_sp_prompts(cfg.vocab_size, seed) for seed in (0, 1)]
    pct = lambda xs, q: float(np.percentile(xs, q)) * 1e3  # noqa: E731
    res, lines = {}, []
    for sp in (1, *sps):
        devices = _sp_placement(sp, cards) if sp > 1 else [torch.device("cuda", 0)]
        _zero_counts()
        steps0 = _metric("sparkdl_sp_ring_steps_total")
        bytes0 = _metric("sparkdl_sp_permute_bytes_total")
        eng = _sp_engine(cfg, model, sp, None if (cards or sp == 1) else devices)
        marks = _sp_timed(eng, devices)
        out, chunk_ms, handoff_ms = [], [], []
        for p in bursts:  # the chunks' times of each burst apart
            for kind in marks:
                marks[kind].clear()
            out.append(_burst(eng, p))
            chunk_ms.append(_sp_ms(marks["chunk"]))
            handoff_ms.append(_sp_ms(marks["handoff"]))
        launched = _launch_counts()
        if any(launched.values()):
            raise AssertionError(f"[sp_serve] sp={sp} launched kernels: {launched}")
        staged = {}
        if sp > 1:
            for dev, kv in zip(eng._sp_devs, eng._sp_kv):
                staged[str(dev)] = staged.get(str(dev), 0) + sum(
                    t.nbytes for t in kv.values())
        eng.close()
        kv = out[-1]["snap"]["kv"]
        res[sp] = {"outs": [o["outs"] for o in out], "kv": kv,
                   "ttft": [o["ttft"] for o in out], "secs": [o["secs"] for o in out],
                   "chunk": chunk_ms, "handoff": handoff_ms,
                   "ring_steps": _metric("sparkdl_sp_ring_steps_total") - steps0,
                   "permute_bytes": _metric("sparkdl_sp_permute_bytes_total") - bytes0,
                   "staged": staged, "devices": [str(d) for d in devices]}
        if sp > 1:
            for b, (got, want) in enumerate(zip(res[sp]["outs"], res[1]["outs"])):
                _same_tokens(f"sp={sp} burst {b} vs sp=1", model, bursts[b], got, want)
            if kv["sp"]["handoffs"] != 2 * SP_REQS or kv["sp"]["staging_blocks_used"]:
                raise AssertionError(f"[sp_serve] sp={sp}: {kv['sp']['handoffs']} handoffs "
                                     f"for {2 * SP_REQS} requests, "
                                     f"{kv['sp']['staging_blocks_used']} staging blocks "
                                     "still used")
    # the oracle: batch-1 generate of the warm burst's prompts
    with torch.inference_mode():
        oracle = [generate(model, torch.as_tensor(p[None], device="cuda").long(),
                           SP_NEW)[0, len(p):].cpu().numpy() for p in bursts[1]]
    _same_tokens("sp=1 warm burst vs batch-1 generate", model, bursts[1],
                 res[1]["outs"][1], oracle)
    # the chaos contract: one failed exchange and one failed handoff gather
    for sp in sps:
        devices = _sp_placement(sp, cards)
        seen = len([e for e in flight_recorder().events()
                    if e.get("kind") == "sp.collective_failed"])
        faults.disarm()
        faults.arm(faults.FaultPlan.parse(SP_FAULTS))
        try:
            eng = _sp_engine(cfg, model, sp, None if cards else devices)
            chaos = _burst(eng, bursts[1])
            eng.close()
        finally:
            faults.disarm()
        failed = [e["site"] for e in flight_recorder().events()
                  if e.get("kind") == "sp.collective_failed"][seen:]
        _same_tokens(f"sp={sp} under {SP_FAULTS} vs sp=1", model, bursts[1],
                     chaos["outs"], res[1]["outs"][1])
        if sorted(failed) != ["sp.gather", "sp.permute"]:
            raise AssertionError(f"[sp_serve] sp={sp}: collective failures {failed}")
        res[sp]["chaos"] = failed
    # the final chunk's logits against the single-device chunk's
    prompt = bursts[1][0]
    ref = _sp_final_logits(cfg, model, prompt, 1, None)
    for sp in sps:
        devices = _sp_placement(sp, cards)
        run = lambda: res[sp].__setitem__(  # noqa: E731
            "logits", _sp_final_logits(cfg, model, prompt, sp, None if cards else devices))
        # over the cards: each card's kernel time, the evidence of its share
        res[sp]["kernel_ms"] = _kernel_ms_by_device(run) if cards else run() or {}
        # no chunk's queries ran whole on one device: every dense layer of
        # the prefill saw a shard's rows, on each shard's device alike
        rows = _linear_rows(lambda: _sp_final_logits(
            cfg, model, prompt, sp, None if cards else devices))
        res[sp]["rows"] = {d: (len(r), max(r)) for d, r in sorted(rows.items())}
        if (any(m > SP_CHUNK // sp for _, m in res[sp]["rows"].values())
                or len({n for n, _ in res[sp]["rows"].values()}) != 1
                or len(rows) != len(set(map(str, devices)))):
            raise AssertionError(f"[sp_serve] sp={sp}: dense-layer rows by device "
                                 f"{res[sp]['rows']}, wanted at most {SP_CHUNK // sp} "
                                 "a product and as many products on each device")
        diff = (res[sp]["logits"] - ref).abs().max().item()
        res[sp]["rel"] = diff / ref.abs().max().item()
        res[sp]["max_diff"] = diff
        res[sp]["bitwise"] = bool(torch.equal(res[sp]["logits"], ref))
        if res[sp]["rel"] > LOGIT_TOL:
            raise AssertionError(f"[sp_serve] sp={sp}: the final chunk's logits rel "
                                 f"{res[sp]['rel']:.3e} of sp=1's > {LOGIT_TOL}")
    if cards:  # the first token read across cards, behind a delayed card
        want = int(res[1]["outs"][1][0][0])
        for sp in sps:
            devices = _sp_placement(sp, cards)
            res[sp]["fetch_wait_ms"] = _fetch_waits_for_its_card(devices)
            res[sp]["late_token"] = _sp_late_shard_token(cfg, model, prompt, sp)
            if res[sp]["late_token"] != want:
                raise AssertionError(
                    f"[sp_serve] sp={sp}: the first token with the last real row's card "
                    f"delayed is {res[sp]['late_token']}, sp=1's is {want}")
    where = "one card a shard" if cards else "every shard on cuda:0"
    print(f"[sp_serve] ContinuousGPTEngine GPT-2 small ({cfg.num_layers}x{cfg.hidden_size}, "
          f"learned positions, float32, TF32 off, random init seed 0), n_slots {SP_SLOTS}, "
          f"max_len {SP_MAX_LEN}, kv_block_size {SP_BLOCK}, prefill_chunk {SP_CHUNK}; two "
          f"bursts of {SP_REQS} prompts of 512..960 tokens (two share a {SP_PREFIX}-token "
          f"prefix; the second burst new tokens, the same lengths), {SP_NEW} greedy tokens "
          f"each, through the daemon loop; sp in {(1, *sps)} ({where}); "
          f"CUBLAS_WORKSPACE_CONFIG unset for the phase; {card}")
    for sp, r in res.items():
        tt = r["ttft"][1]
        cold, warm = r["chunk"]
        chunk = "; ".join(f"{d} warm median {m:.3f} ms (cold sum {cold[d][1]:.1f} ms, warm "
                          f"sum {t:.1f})" for d, (m, t) in warm.items())
        hand = "; ".join(f"{d} warm median {m:.3f} ms" for d, (m, _)
                         in r["handoff"][1].items())
        print(f"[sp_serve] sp={sp} on {r['devices']}: warm TTFT p50 {pct(tt, 50):.1f} ms p99 "
              f"{pct(tt, 99):.1f} ms (cold p50 {pct(r['ttft'][0], 50):.1f} p99 "
              f"{pct(r['ttft'][0], 99):.1f}), warm {SP_REQS * SP_NEW / r['secs'][1]:.1f} "
              f"tokens/s, {r['kv']['prefill_chunks']} prefill chunks over both bursts, "
              f"prefix-hit tokens {r['kv']['prefix_hits']}; chunk (CUDA events on each "
              f"device's stream, {'graph replays' if sp == 1 else 'eager'}): {chunk}"
              + (f"; handoff {hand}; counters sparkdl_sp_ring_steps_total "
                 f"+{r['ring_steps']:.0f}, sparkdl_sp_permute_bytes_total "
                 f"+{r['permute_bytes']:.0f}; handoffs {r['kv']['sp']['handoffs']}, staging "
                 f"blocks used at the end {r['kv']['sp']['staging_blocks_used']}; staging "
                 f"bytes resident by device {r['staged']}; collective failures injected "
                 f"and re-queued {r['chaos']}" if sp > 1 else ""))
    for sp in sps:
        r = res[sp]
        kms = (", ".join(f"cuda:{i} {m:.2f} ms" for i, m in sorted(r["kernel_ms"].items()))
               if cards else "")
        print(f"[sp_serve] sp={sp}: tokens equal to sp=1's in {2 * SP_REQS}/{2 * SP_REQS} "
              f"(both bursts) and under the faults; sp=1 equal to batch-1 generate in "
              f"{SP_REQS}/{SP_REQS}; the final chunk's logits ({len(ref)} rows of the "
              f"{len(prompt)}-token prompt) vs sp=1's: rel {r['rel']:.3e} (tol {LOGIT_TOL}), "
              f"max diff {r['max_diff']:.3e}, bitwise {r['bitwise']}; dense products of that "
              f"prefill by device (count, most rows; a {SP_CHUNK}-token chunk splits "
              f"{SP_CHUNK // sp} a shard): {r['rows']}; kernel launches 0"
              + (f"; one prompt's prefill, kernel time by device (torch.profiler): "
                 f"{kms or 'not measured (no device events in the trace)'}; with every card "
                 f"but cuda:0 spinning {SP_DELAY_CYCLES} cycles after the final chunk, the "
                 f"first token (last real row on a later card) {r['late_token']} = sp=1's; "
                 f"start_fetch of a scalar on {r['devices'][-1]} with cuda:0 current read "
                 f"its value after {r['fetch_wait_ms']:.1f} ms" if cards else ""))
    print(f"[sp_serve] phase {time.perf_counter() - t_phase:.1f} s")
    del model
    torch.cuda.empty_cache()
    return {sp: {k: v for k, v in r.items() if k not in ("outs", "logits")}
            for sp, r in res.items()}


FLEET_REQS, FLEET_BURSTS = 64, 5   # [fabric]: bursts of _fleet_prompts, 2 hosts
DISAGG_REQS, DISAGG_BURSTS = 16, 3  # [disagg]: one request a slot of each tier
DISAGG_FAULTS = "handoff.export@3;handoff.install@2*2"  # one export, two installs
# three refused submits, apart: each request fails over once
FABRIC_FAULTS = "host.submit:OSError@5;host.submit:OSError@20;host.submit:OSError@41"
FABRIC_HTTP_REQS = 8
WIRE_RATIO = 3.5  # int8 wire against fp32: 4 / (1 + 4 / 768) at GPT-2 small


def _gpt2_small(device: str = "cuda"):
    """GPT-2 small (GPTConfig's widths, learned positions), float32,
    random init seed 0, on ``device``: [serve]'s model."""
    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, init_gpt_

    cfg = GPTConfig(positions="learned")
    model = GPTLMHeadModel(cfg, device=device)
    model.load_state_dict(init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict())
    return cfg, model.eval()


def _fleet_prompts(vocab: int, seed: int, n: int) -> list:
    """``n`` prompts: every fourth opens with ONE SERVE_PREFIX-token
    prefix (the same for every seed, so a later burst's sharers hit what
    an earlier burst cached) and a 1..SERVE_PREFIX-token tail; the others
    hold 8..SERVE_CHUNK random tokens. The lengths depend on ``n`` alone:
    every burst of ``n`` runs the programs an earlier one captured."""
    import numpy as np

    shape = np.random.default_rng(1000 + n)
    prefix = np.random.default_rng(0).integers(0, vocab, SERVE_PREFIX)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 4 == 0:
            tail = rng.integers(0, vocab, int(shape.integers(1, SERVE_PREFIX + 1)))
            out.append(np.concatenate([prefix, tail]))
        else:
            out.append(rng.integers(0, vocab, int(shape.integers(8, SERVE_CHUNK + 1))))
    return out


class _Tap:
    """Wraps a fabric host handle's ``submit`` to keep each engine-side
    Future (its ``ttft_s``) and the payload it was given."""

    def __init__(self, host):
        self.host, self.futs = host, []
        inner = host.submit

        def submit(payload, *, timeout_s=None):
            fut = inner(payload, timeout_s=timeout_s)
            self.futs.append((payload, fut))
            return fut

        host.submit = submit


@contextlib.contextmanager
def _loops_stopped(*engines):
    """The engines' background loops stopped (each ends its tick and
    exits; nothing is in flight) and started again on the way out, so
    the caller may touch their pools and tables alone."""
    for e in engines:
        e._stop.set()
        e._thread.join(30)
        if e._thread.is_alive():
            raise AssertionError(f"[disagg] {e.host_id}'s loop did not stop")
        e._thread = None
        e._stop.clear()
    try:
        yield
    finally:
        for e in engines:
            e.start()


def _handoff_times(pre, dec, handoffs) -> dict:
    """Export and install ms of each handoff on idle tiers, their loops
    stopped (between CUDA events on its tier's card, synchronized before
    and after): the export of as many of the prefill pool's blocks, the
    install of the handoff into as many freshly allocated decode-pool
    blocks. Medians a handoff, and ms a block over all of them, against
    the wire bytes of a block at the host link's rate."""
    import torch

    def event_ms(device, fn) -> float:
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
        return start.elapsed_time(end)

    exp, ins, blocks = [], [], 0
    with _loops_stopped(pre, dec):
        for h in handoffs:
            exp.append(event_ms(pre.device, lambda: pre._export(list(range(h.n_blocks)))))
            targets = dec._pool.allocate(h.n_blocks)
            if targets is None:
                raise AssertionError("[disagg] no decode-pool blocks to time an install")
            ins.append(event_ms(dec.device, lambda: dec._install(h, 0, targets)))
            dec._pool.release(dec._pool.deref(targets))
            blocks += h.n_blocks
    wire = sum(h.wire_bytes for h in handoffs)
    return {"export_ms": statistics.median(exp), "install_ms": statistics.median(ins),
            "export_block_ms": sum(exp) / blocks, "install_block_ms": sum(ins) / blocks,
            "block_bytes": wire / blocks,
            "block_bound_ms": wire / blocks / H100_HOST_BYTES_S * 1e3}


def _split_bursts(pre, dec, bursts, faults: "str | None" = None) -> list:
    """Each burst through a PhaseRouter over one PrefillWorker and one
    DecodeWorker (both loops running): all submitted at once, then the
    results. Per burst: the caller tokens, the handoffs in submit order,
    the prefill tier's TTFT per request (its first token is out at the
    export) and the wall seconds."""
    import numpy as np

    from sparkdl_torch.disagg import PhaseRouter
    from sparkdl_torch.fabric import InProcessHost
    from sparkdl_torch.reliability.faults import inject

    tp, td = _Tap(InProcessHost(pre)), _Tap(InProcessHost(dec))
    runs = []
    with PhaseRouter([tp.host], [td.host], auto_refresh=False,
                     max_handoff_retries=4) as pr, \
            (inject(faults) if faults else contextlib.nullcontext()):
        pre.start()
        dec.start()
        for prompts in bursts:
            first = len(tp.futs)
            t0 = time.perf_counter()
            futs = [pr.submit(p, SERVE_NEW) for p in prompts]
            outs = [np.asarray(f.result(timeout=600)) for f in futs]
            secs = time.perf_counter() - t0
            handoffs = [f.result(timeout=0) for _, f in tp.futs[first:first + len(prompts)]]
            runs.append({"outs": outs, "handoffs": handoffs, "secs": secs,
                         "ttft": [f.ttft_s for _, f in tp.futs[first:first + len(prompts)]]})
        runs[-1]["router"] = pr.snapshot()["disagg"]
    return runs


def _decode_only(cfg, model, handoff_bursts, **kw) -> list:
    """A fresh DecodeWorker fed each burst's handoffs in turn (its loop
    running): the tokens per burst."""
    import numpy as np

    from sparkdl_torch.disagg import DecodeWorker

    dec = DecodeWorker(cfg, model, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       kv_block_size=SERVE_BLOCK, prefill_chunk=SERVE_CHUNK,
                       auto_start=True, **kw)
    outs = []
    for hs in handoff_bursts:
        futs = [dec.submit_handoff(h) for h in hs]
        outs.append([np.asarray(f.result(timeout=600)) for f in futs])
    snap = dec.snapshot()
    dec.close()
    return outs, snap


def _same_outs(phase: str, name: str, got: list, want: list) -> None:
    for b, (gb, wb) in enumerate(zip(got, want)):
        for i, (x, y) in enumerate(zip(gb, wb)):
            if len(x) != len(y) or (x != y).any():
                raise AssertionError(f"[{phase}] {name}: burst {b} request {i} differs "
                                     f"from the colocated engine's ({x[:8]} vs {y[:8]})")


def phase_disagg(card: str) -> dict:
    """Disaggregated prefill/decode at GPT-2-small width with [serve]'s
    engine settings: per pool dtype (fp32, int8) DISAGG_BURSTS bursts of
    DISAGG_REQS requests (every fourth shares one prefix across bursts)
    through a PhaseRouter over a PrefillWorker and a DecodeWorker, the
    same handoffs again through chained and speculative DecodeWorkers —
    every stream bitwise the colocated engine's; the int8 wire's bytes
    against fp32's; export and install ms per handoff and per block
    against the host link's bound; TTFT split against colocated on the
    last (captured) burst; injected handoff.export/handoff.install
    faults lose nothing; with two or more cards, the tiers on two
    cards."""
    import numpy as np
    import torch

    from sparkdl_torch.disagg import DecodeWorker, PrefillWorker

    t_phase = time.perf_counter()
    cfg, model = _gpt2_small()
    bursts = [_fleet_prompts(cfg.vocab_size, s, DISAGG_REQS) for s in range(DISAGG_BURSTS)]
    tier_kw = dict(n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, kv_block_size=SERVE_BLOCK,
                   prefill_chunk=SERVE_CHUNK, auto_start=False)
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    _zero_counts()
    out, lines, wire = {}, [], {}
    for dt in ("fp32", "int8"):
        t0 = time.perf_counter()
        col = _serve_engine(cfg, model, kv_dtype=dt)
        colo = [_burst(col, b) for b in bursts]
        col.close()
        want = [r["outs"] for r in colo]
        pre = PrefillWorker(cfg, model, kv_dtype=dt, **tier_kw)
        dec = DecodeWorker(cfg, model, kv_dtype=dt, **tier_kw)
        split = _split_bursts(pre, dec, bursts)
        _same_outs("disagg", f"kv_dtype={dt} split, plain decode",
                   [r["outs"] for r in split], want)
        hits = (pre.snapshot()["kv"]["prefix_hits"], dec.snapshot()["kv"]["prefix_hits"])
        if not all(hits):
            raise AssertionError(f"[disagg] kv_dtype={dt}: prefix-hit tokens prefill/decode "
                                 f"{hits}: the shared prefix hit on neither side")
        times = _handoff_times(pre, dec, split[-1]["handoffs"])
        faults = None
        if dt == "fp32":
            # injected faults on the captured tiers, the last burst again
            faulted = _split_bursts(pre, dec, bursts[-1:], faults=DISAGG_FAULTS)
            _same_outs("disagg", "under injected handoff faults", [faulted[0]["outs"]],
                       want[-1:])
            r = faulted[0]["router"]
            faults = (r["requeues"], pre.snapshot()["disagg"]["export_aborts"],
                      dec.snapshot()["disagg"]["install_faults"], r["failed"])
            if faults != (2, 1, 2, 0) or r["completed"] != r["submitted"]:
                raise AssertionError(f"[disagg] faults {DISAGG_FAULTS}: requeues/export "
                                     f"aborts/install faults/failed {faults}, router {r}")
        pre.close()
        dec.close()
        handoffs = [r["handoffs"] for r in split]
        for name, kw in (("chain8", dict(chain_tokens=8)), ("spec4", dict(spec_k=4))):
            got, snap = _decode_only(cfg, model, handoffs, kv_dtype=dt, **kw)
            _same_outs("disagg", f"kv_dtype={dt} split, {name} decode", got, want)
        wire[dt] = sum(h.wire_bytes for hs in handoffs for h in hs)
        blocks = sum(h.n_blocks for hs in handoffs for h in hs)
        out[dt] = {**times, "ttft_split": split[-1]["ttft"],
                   "ttft_colocated": colo[-1]["ttft"]}
        lines.append(
            f"[disagg] kv_dtype={dt}: {DISAGG_BURSTS} bursts of {DISAGG_REQS}, tokens of "
            f"PhaseRouter(PrefillWorker -> KVHandoff -> DecodeWorker) bitwise the colocated "
            f"engine's in {DISAGG_BURSTS * DISAGG_REQS}/{DISAGG_BURSTS * DISAGG_REQS}, and "
            f"the same handoffs through chain_tokens=8 and spec_k=4 DecodeWorkers too; "
            f"prefix-hit tokens prefill tier {hits[0]}, decode tier {hits[1]}; "
            f"{blocks} blocks exported, {wire[dt] / 1e6:.2f} MB on the wire "
            f"({times['block_bytes'] / 1e3:.1f} kB a block); the last burst's {DISAGG_REQS} "
            f"handoffs again on idle tiers (CUDA events): export (gather + D2H into "
            f"page-locked memory) median {times['export_ms']:.3f} ms a handoff, install "
            f"(H2D + dequantize + _q_write) {times['install_ms']:.3f} ms; per block export "
            f"{times['export_block_ms']:.4f} ms, install {times['install_block_ms']:.4f} ms, "
            f"bound {times['block_bound_ms']:.4f} ms (the block's wire bytes at "
            f"{H100_HOST_BYTES_S / 1e9:.0f} GB/s); TTFT p50/p99 split "
            f"{pct(split[-1]['ttft'], 50) * 1e3:.1f}/{pct(split[-1]['ttft'], 99) * 1e3:.1f} "
            f"ms (first token out at the export) vs colocated "
            f"{pct(colo[-1]['ttft'], 50) * 1e3:.1f}/{pct(colo[-1]['ttft'], 99) * 1e3:.1f} ms, "
            f"end to end {split[-1]['secs']:.2f} s vs {colo[-1]['secs']:.2f} s a burst"
            + (f"; under {DISAGG_FAULTS}: {faults[0]} handoffs requeued at the prefill "
               f"tier, {faults[1]} export abort(s), {faults[2]} install faults, "
               f"{faults[3]} failed, tokens bitwise" if faults else "")
            + f"; {time.perf_counter() - t0:.1f} s")
    ratio = wire["fp32"] / wire["int8"]
    if ratio < WIRE_RATIO:
        raise AssertionError(f"[disagg] int8 wire {wire['int8']} B vs fp32 {wire['fp32']} B: "
                             f"{ratio:.2f}x, under {WIRE_RATIO}x")
    launched = _launch_counts()
    if any(launched.values()):
        raise AssertionError(f"[disagg] the tiers launched kernels: {launched}")
    cards = torch.cuda.device_count()
    if cards >= 2:
        t0 = time.perf_counter()
        _, model1 = _gpt2_small("cuda:1")
        pre = PrefillWorker(cfg, model, **tier_kw)
        dec = DecodeWorker(cfg, model1, **tier_kw)
        col = _serve_engine(cfg, model)
        want = [_burst(col, b)["outs"] for b in bursts]
        col.close()
        two = _split_bursts(pre, dec, bursts)
        times = _handoff_times(pre, dec, two[-1]["handoffs"])
        pre.close()
        dec.close()
        _same_outs("disagg", "PrefillWorker on cuda:0, DecodeWorker on cuda:1",
                   [r["outs"] for r in two], want)
        lines.append(f"[disagg] {cards} cards: PrefillWorker on cuda:0, DecodeWorker on "
                     f"cuda:1 (fp32): tokens bitwise the colocated engine's in "
                     f"{DISAGG_BURSTS * DISAGG_REQS}/{DISAGG_BURSTS * DISAGG_REQS}; idle "
                     f"tiers, a handoff's export {times['export_ms']:.3f} ms, install "
                     f"{times['install_ms']:.3f} ms; {time.perf_counter() - t0:.1f} s")
        del model1
    else:
        lines.append("[disagg] 1 card: the two-card placement (PrefillWorker on cuda:0, "
                     "DecodeWorker on cuda:1) is skipped")
    del model
    torch.cuda.empty_cache()
    print(f"[disagg] GPT-2 small ({cfg.num_layers}x{cfg.hidden_size}, learned positions, "
          f"float32, random init seed 0), each tier and the colocated engine n_slots "
          f"{SERVE_SLOTS}, max_len {SERVE_MAX_LEN}, block {SERVE_BLOCK}, prefill_chunk "
          f"{SERVE_CHUNK}; bursts of {DISAGG_REQS} prompts of 8..{SERVE_CHUNK} tokens "
          f"({DISAGG_REQS // 4} open with one {SERVE_PREFIX}-token prefix), {SERVE_NEW} greedy tokens each; {card}")
    for line in lines:
        print(line)
    print(f"[disagg] int8 wire {wire['int8'] / 1e6:.2f} MB vs fp32 {wire['fp32'] / 1e6:.2f} MB: "
          f"{ratio:.2f}x fewer bytes (bar {WIRE_RATIO}x); kernel launches 0 (the tiers "
          f"run the dense masked path); phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _fleet_burst(router, taps, prompts) -> dict:
    """All prompts through ``router`` at once: the tokens, wall seconds,
    TTFT per request and which host took each prompt."""
    import numpy as np

    first = [len(t.futs) for t in taps]
    t0 = time.perf_counter()
    futs = [router.submit({"prompt": p, "max_new_tokens": SERVE_NEW}) for p in prompts]
    outs = [np.asarray(f.result(timeout=600)) for f in futs]
    secs = time.perf_counter() - t0
    where, ttft = {}, []
    for t, n0 in zip(taps, first):
        for payload, f in t.futs[n0:]:
            where[id(payload["prompt"])] = t.host.host_id
            if f.done() and f.exception() is None:
                ttft.append(f.ttft_s)
    hosts = [where.get(id(p)) for p in prompts]
    return {"outs": outs, "secs": secs, "ttft": ttft, "hosts": hosts}


def phase_fabric(card: str) -> dict:
    """The router tier over two in-process hosts on the card (each a
    ContinuousGPTEngine at GPT-2-small width with [serve]'s settings):
    FLEET_BURSTS bursts of FLEET_REQS requests, every stream bitwise one
    engine's; the shared prefix lands on the host whose digest holds it;
    requests/s and TTFT p50/p99 over a captured burst; injected
    host.submit faults fail over; drain_host mid-burst transfers the
    drained host's unstarted requests and loses none; one HostServer on
    localhost answers through HttpHostHandle with the same tokens."""
    import numpy as np
    import torch

    from sparkdl_torch.fabric import HostServer, HttpHostHandle, InProcessHost, Router
    from sparkdl_torch.observability.registry import registry
    from sparkdl_torch.reliability.faults import inject

    t_phase = time.perf_counter()
    cfg, model = _gpt2_small()
    bursts = [_fleet_prompts(cfg.vocab_size, 10 + s, FLEET_REQS) for s in range(FLEET_BURSTS)]
    seed_prompt = _fleet_prompts(cfg.vocab_size, 9, 1)[0]
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    def failed() -> float:
        fam = registry().get("sparkdl_requests_failed_total")
        return sum(fam.snapshot_values().values()) if fam is not None else 0.0

    _zero_counts()
    t0 = time.perf_counter()
    ref = _serve_engine(cfg, model)
    want = [_burst(ref, b)["outs"] for b in [[seed_prompt], *bursts]]
    ref.close()
    ref_s = time.perf_counter() - t0
    engs = [_serve_engine(cfg, model, host_id=f"fleet-{i}") for i in range(2)]
    taps = [_Tap(InProcessHost(e)) for e in engs]
    for e in engs:
        e.start()
    router = Router([t.host for t in taps], auto_refresh=False)
    try:
        # one sharer alone first: exactly one host holds the prefix
        seed = router.submit({"prompt": seed_prompt, "max_new_tokens": SERVE_NEW})
        _same_outs("fabric", "seed request", [[np.asarray(seed.result(timeout=600))]],
                   [want[0]])
        holder = [t.host.host_id for t in taps if t.futs][0]
        runs = []
        for b, prompts in enumerate(bursts[:3]):
            router.refresh()
            runs.append(_fleet_burst(router, taps, prompts))
            _same_outs("fabric", f"burst {b}", [runs[-1]["outs"]], [want[1 + b]])
            strays = [h for i, h in enumerate(runs[-1]["hosts"]) if i % 4 == 0 and h != holder]
            if strays:
                raise AssertionError(f"[fabric] burst {b}: {len(strays)} shared-prefix "
                                     f"requests placed off {holder}, the host holding it")
        placed = {h: runs[-1]["hosts"].count(h) for h in sorted(set(runs[-1]["hosts"]))}
        hits = {e.host_id: e.snapshot()["kv"]["prefix_hits"] for e in engs}
        # injected refused submits: the router fails over
        fo0 = _metric("sparkdl_fabric_failovers_total")
        fail0 = failed()
        router.refresh()
        with inject(FABRIC_FAULTS):
            faulted = _fleet_burst(router, taps, bursts[3])
        _same_outs("fabric", f"under {FABRIC_FAULTS}", [faulted["outs"]], [want[4]])
        failovers = _metric("sparkdl_fabric_failovers_total") - fo0
        if failovers != len(FABRIC_FAULTS.split(";")) or failed() != fail0:
            raise AssertionError(f"[fabric] {FABRIC_FAULTS}: {failovers} failovers, "
                                 f"{failed() - fail0} requests failed")
        # drain one host mid-burst: its unstarted requests move, none is lost
        futs = [router.submit({"prompt": p, "max_new_tokens": SERVE_NEW})
                for p in bursts[4]]
        drained = [t.host.host_id for t in taps if t.host.host_id != holder][0]
        moved = router.drain_host(drained)
        drain_outs = [np.asarray(f.result(timeout=600)) for f in futs]
        _same_outs("fabric", f"drain_host({drained}) mid-burst", [drain_outs], [want[5]])
        lost = failed() - fail0
        if moved < 1 or lost:
            raise AssertionError(f"[fabric] drain_host: {moved} transferred, {lost} lost")
    finally:
        router.close()
    # one HostServer on localhost, answered through HttpHostHandle
    survivor = [e for e in engs if e.host_id == holder][0]
    http_ms, local_ms, http_outs = [], [], []
    with HostServer(survivor, host="127.0.0.1") as server:
        handle = HttpHostHandle(server.url)
        for p in bursts[2][:FABRIC_HTTP_REQS]:
            t1 = time.perf_counter()
            http_outs.append(np.asarray(handle.submit(
                {"prompt": p, "max_new_tokens": SERVE_NEW}).result(timeout=600)))
            http_ms.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            survivor.submit(p, SERVE_NEW).result(timeout=600)
            local_ms.append((time.perf_counter() - t1) * 1e3)
        host_id = handle.host_id
        handle.close()
    _same_outs("fabric", "HttpHostHandle", [http_outs], [want[3][:FABRIC_HTTP_REQS]])
    for e in engs:
        e.close(drain=False)
    launched = _launch_counts()
    if any(launched.values()):
        raise AssertionError(f"[fabric] the hosts launched kernels: {launched}")
    warm = runs[-1]
    del model
    torch.cuda.empty_cache()
    print(f"[fabric] Router(policy='affinity') over two InProcessHosts on the one card, "
          f"each a ContinuousGPTEngine GPT-2 small ({cfg.num_layers}x{cfg.hidden_size}, "
          f"float32, random init seed 0) with n_slots {SERVE_SLOTS}, max_len "
          f"{SERVE_MAX_LEN}, block {SERVE_BLOCK}, prefill_chunk {SERVE_CHUNK}; one sharer "
          f"first, then bursts of {FLEET_REQS} prompts of 8..{SERVE_CHUNK} tokens "
          f"({FLEET_REQS // 4} open with one {SERVE_PREFIX}-token prefix), {SERVE_NEW} greedy tokens each; {card}")
    print(f"[fabric] every stream of {1 + FLEET_BURSTS} bursts bitwise one engine's "
          f"({ref_s:.1f} s for the reference engine); shared-prefix requests on {holder} "
          f"(its digest held the prefix) in {3 * FLEET_REQS // 4}/{3 * FLEET_REQS // 4}; "
          f"third burst (programs captured by the first two): placements {placed}, "
          f"{FLEET_REQS / warm['secs']:.1f} requests/s ({warm['secs']:.2f} s), TTFT p50 "
          f"{pct(warm['ttft'], 50) * 1e3:.1f} ms p99 {pct(warm['ttft'], 99) * 1e3:.1f} ms; "
          f"prefix-hit tokens per host {hits}")
    print(f"[fabric] {FABRIC_FAULTS}: {failovers:.0f} failovers, 0 failed, tokens bitwise; "
          f"drain_host({drained}) right after a burst of {FLEET_REQS} was submitted: "
          f"{moved} unstarted requests transferred queue-to-queue, {lost:.0f} lost, tokens "
          f"bitwise; HostServer on 127.0.0.1 (host_id {host_id}) through HttpHostHandle: "
          f"{FABRIC_HTTP_REQS} requests bitwise, median {statistics.median(http_ms):.1f} ms "
          f"each against {statistics.median(local_ms):.1f} ms in process; kernel launches "
          f"0; phase {time.perf_counter() - t_phase:.1f} s")
    return {"requests_s": FLEET_REQS / warm["secs"], "moved": moved}


AUTOSCALE_CLIENT_REQS, AUTOSCALE_BURST = 64, 512  # (a): stages 1 and 3, stage 2
# (a): the latency objective: the burst's p50 (~1 s on the card) breaks it,
# the closed-loop stages' (~30 ms) keep it. Where a stage's tail breaks it
# after a scale-down, the scaler vetoes the move and reverts it: (a) allows that
AUTOSCALE_SLO_S, AUTOSCALE_SLO_WINDOW_S = 0.25, 2.0
AUTOSCALE_KV_STEP = 32   # (b): blocks one KV resize moves, 1/16 of [serve]'s pool
AUTOSCALE_TICK_S = 0.05  # (b)-(c): the scaler threads' cadence
AUTOSCALE_REQS, AUTOSCALE_TIER_REQS = 64, 16  # (b)-(c): the bursts
AUTOSCALE_WAIT_S = 60.0  # the longest the phase waits for one scale move
# one counted fault per actuator family, each the first hit of its site
AUTOSCALE_FAULTS = {"replicas": "replica.scale_down:OSError@1",
                    "kv": "kv_pool.resize:OSError@1",
                    "fabric": "autoscale.decide:RuntimeError@1"}


class _TimedRunner:
    """A replica's runner that counts the dispatches it serves, the
    pool's warmup batches (one a bucket) first. After the last of them,
    before the replica routes, ``stats`` takes its CUDA graphs, their
    capture seconds and the card's reserved GiB; at its first live
    batch, that batch's end (``time.time()``, the flight recorder's
    clock)."""

    def __init__(self, runner, stats: dict):
        self.runner, self.stats, self.calls = runner, stats, 0
        self.chunk_size = runner.chunk_size

    def run_batch(self, arrays):
        out = self.runner.run_batch(arrays)
        self.calls += 1
        if self.calls == len(self.runner._buckets):
            self.stats["graphs"], self.stats["capture_s"] = _graph_stats(self.runner)
            self.stats["reserved_gib"] = _reserved_gib()
        elif self.calls == len(self.runner._buckets) + 1:
            self.stats["first_live"] = time.time()
        return out


class _Signals:
    """The default signal reader (the real spine), reading /healthz
    first whenever the scaler's last pass was deferred: a fault leaves
    that state until the next pass, so each deferral is seen as an
    operator would see it."""

    def __init__(self, inner=None):
        from sparkdl_torch.autoscale import read_autoscale_signals

        self.inner = inner or read_autoscale_signals
        self.scaler = None
        self.deferred_healthz = []

    def __call__(self):
        from sparkdl_torch.observability.flight import healthz_report

        if self.scaler is not None and self.scaler.state == "deferred":
            self.deferred_healthz.append(healthz_report()["status"])
        return self.inner()


def _flight_seq() -> int:
    from sparkdl_torch.observability.flight import flight_recorder

    return flight_recorder().events_total


def _events(seq0: int, kind: str) -> list:
    """The flight recorder's ``kind`` events recorded after ``seq0``."""
    from sparkdl_torch.observability.flight import flight_recorder

    return [e for e in flight_recorder().events() if e["seq"] > seq0 and e["kind"] == kind]


def _decisions(seq0: int, scalers) -> list:
    """The autoscale.decision events since ``seq0``, each an (actuator,
    direction, reverted) triple; fails unless they are every decision
    ``scalers`` counted."""
    evs = _events(seq0, "autoscale.decision")
    counted = sum(s.decision_count for s in scalers)
    if len(evs) != counted:
        raise AssertionError(f"[autoscale] the flight recorder holds {len(evs)} decisions of "
                             f"the scalers' {counted}")
    return [(e["actuator"], e["direction"], e.get("reverted")) for e in evs]


def _net(decisions, actuator: str) -> tuple:
    """(adds, removes, lapsed) among ``actuator``'s decisions: its
    scale-ups and the vetoes' reverts that added back what a scale-down
    took, its scale-downs, and the reverts that could not add back."""
    reverts = [d[2] for d in decisions if d[:2] == (actuator, "revert")]
    return (sum(d[:2] == (actuator, "up") for d in decisions) + sum(map(bool, reverts)),
            sum(d[:2] == (actuator, "down") for d in decisions),
            reverts.count(False))


def _burst_until_rejoin(submit, prompts, scaler, rounds: int = 4) -> tuple:
    """``submit`` each prompt, and the same prompts again while a round
    ends before ``scaler`` has rejoined its parked host (a short burst
    can finish first): (futures, the prompt index of each, seconds). The
    host is back once its router holds ``max_hosts`` again: it leaves
    ``spare_hosts`` before ``add_host`` returns."""
    futs, sent, t0 = [], [], time.monotonic()
    back = lambda: len(scaler.router.hosts()) == scaler.policy.max_hosts  # noqa: E731
    for _ in range(rounds):
        futs += [submit(p) for p in prompts]
        sent += list(range(len(prompts)))
        _wait_for("requests done or a rejoin", lambda: back() or all(f.done() for f in futs))
        if not back() and not scaler.spare_hosts:  # a rejoin under way
            _wait_for("the rejoin", back, 10)
        if back():
            return futs, sent, time.monotonic() - t0
    raise AssertionError(f"[autoscale] {len(sent)} requests rejoined no parked host")


def _no_launches(part: str) -> str:
    """Fail unless no kernel launched since the counts were zeroed."""
    launched = _launch_counts()
    if any(launched.values()):
        raise AssertionError(f"[autoscale] {part} launched kernels: {launched}")
    return "kernel launches 0 (the dense masked path)"


def _wait_for(what: str, pred, timeout_s: float = AUTOSCALE_WAIT_S) -> float:
    """Poll ``pred`` until it holds; the seconds it took."""
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    if not pred():
        raise AssertionError(f"[autoscale] no {what} within {timeout_s:.0f} s")
    return time.monotonic() - t0


def _reserved_gib() -> float:
    """``torch.cuda.memory_reserved`` once collected garbage and the
    allocator's unused cache are released."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(0) / 2**30


def _graph_stats(runner) -> tuple:
    """(CUDA graphs, their capture seconds) a BatchedRunner holds."""
    graphs = runner._chainer._graphs.graphs()
    return len(graphs), sum(g.capture_s for g in graphs)


def _stage(eng, rows, n: int, clients: "int | None") -> dict:
    """``n`` single-image requests (request i sends ``rows[i % len]``):
    from ``clients`` closed-loop client threads, or, with None, all
    submitted at once. Answers and latencies by request, seconds."""
    import numpy as np

    got, lat, errs = {}, {}, []
    if clients is not None:
        got, errs, secs = _closed_loop(eng, rows, list(range(n)), clients, lat)
    else:
        t0 = time.perf_counter()
        futs = {}
        for i in range(n):
            sent = time.perf_counter()
            futs[i] = eng.submit(rows[i % len(rows)]["image"])
            futs[i].add_done_callback(
                lambda f, i=i, sent=sent: lat.__setitem__(i, time.perf_counter() - sent))
        for i, f in futs.items():
            try:
                got[i] = f.result(timeout=300)
            except Exception as e:  # counted as lost below
                errs.append(e)
        secs = time.perf_counter() - t0
        _wait_for("latency of every request", lambda: len(lat) == len(got), 10)
    ms = sorted(v * 1e3 for v in lat.values())
    return {"got": got, "errs": errs, "secs": secs, "n": n,
            "p50": float(np.percentile(ms, 50)) if ms else math.nan,
            "p99": float(np.percentile(ms, 99)) if ms else math.nan}


def _autoscale_replicas(card: str, served: dict) -> dict:
    """(a) The replica tier over the main path: a started AutoScaler over
    ServingEngine(ReplicaPool(n_replicas=1)) of DeepImageFeaturizer
    (InceptionV3) runners, through 2 closed-loop clients, a burst of
    single-image requests and 2 clients again; a scale-up (the new
    replica warmed over every bucket before it routes), then scale-downs
    back to one replica (the first attempt deferred by a counted fault;
    a scale-down the SLO's burn vetoes is reverted and tried again)."""
    import weakref

    import numpy as np
    import torch

    from sparkdl_torch.autoscale import AutoScaler, AutoscalePolicy
    from sparkdl_torch.models.registry import get_entry
    from sparkdl_torch.observability.flight import healthz_report
    from sparkdl_torch.observability.slo import SLO
    from sparkdl_torch.ops.stem_fused import inception_stem_fused
    from sparkdl_torch.reliability.faults import inject
    from sparkdl_torch.serving import ReplicaPool, ServingEngine
    from sparkdl_torch.transformers.named_image import (
        _image_to_rgb_array,
        _named_model_runner,
        _resize_host,
    )

    t0 = time.perf_counter()
    rows, want = served["rows"], served["want"]
    size = get_entry("InceptionV3").input_size
    extract = lambda s: {"img": _resize_host(_image_to_rgb_array(s), size)}  # noqa: E731
    made = []  # a weak reference to each replica's runner, by replica index
    stats = []  # by replica index: when its runner was built, and its _TimedRunner stats

    def make_runner(device):
        stats.append({"built": time.time()})
        runner = _TimedRunner(_named_model_runner.__wrapped__(
            "InceptionV3", "random", False, "features", BATCH, str(device)), stats[-1])
        made.append(weakref.ref(runner))
        return runner

    def batches() -> float:
        from sparkdl_torch.observability.registry import registry

        fam = registry().get("sparkdl_replica_batches_total")
        return sum(fam.snapshot_values().values()) if fam is not None else 0.0

    _zero_counts()
    batches0 = batches()
    pool = ReplicaPool(make_runner=make_runner, n_replicas=1,
                       devices=[torch.device("cuda:0")], max_failures=2,
                       probation_s=REPLICA_PROBATION_S)
    img = extract(rows[0]["image"])["img"]
    buckets = list(made[0]().runner._buckets)
    warm = [{"img": np.repeat(img[None], b, axis=0)} for b in buckets]
    for w in warm:  # the first replica's buckets before traffic
        pool.warmup(w)
    eng = ServingEngine(pool, max_wait_s=SERVE_WAIT_S, extract=extract,
                        max_queue_depth=4 * AUTOSCALE_BURST, slo=SLO(
        "autoscale", latency_threshold_s=AUTOSCALE_SLO_S, window_s=AUTOSCALE_SLO_WINDOW_S))
    sig = _Signals()
    scaler = AutoScaler(pool=pool, warmup_arrays=warm, signals=sig,
                        policy=AutoscalePolicy(min_replicas=1, max_replicas=2))
    sig.scaler = scaler
    seq0 = _flight_seq()
    reserved0 = _reserved_gib()
    scaler.start()
    try:
        stages = [_stage(eng, rows, AUTOSCALE_CLIENT_REQS, 2),
                  _stage(eng, rows, AUTOSCALE_BURST, None)]
        with inject(AUTOSCALE_FAULTS["replicas"]):
            t_down = time.time()
            stages.append(_stage(eng, rows, AUTOSCALE_CLIENT_REQS, 2))
            # back to one replica: a scale-up and a scale-down at least (a
            # vetoed scale-down's revert adds a replica back), its veto
            # window over and the scaler's state recovered
            _wait_for("scale-down to one replica", lambda: (
                scaler.decision_count >= 2 and len(pool.replicas) == 1
                and scaler.state == "ok"
                and not scaler.snapshot()["autoscaler"]["pending_vetoes"]))
        hz = healthz_report()
        final = (scaler.state, len(pool.replicas), hz["status"])
    finally:
        scaler.close()
        snap = eng.snapshot()
        eng.close()
        pool.close()
    stem_launches = inception_stem_fused.launches
    n_batches = batches() - batches0
    reserved_down = _reserved_gib()
    moved = _decisions(seq0, [scaler])
    adds, removes, lapsed = _net(moved, "replica")
    added = [e["replica"] for e in _events(seq0, "pool.scale_up")]
    victims = [e for e in _events(seq0, "pool.scale_down")]
    up, down = stats[added[0]] if added else {}, victims[0] if victims else {}
    victims_freed = all(made[e["replica"]]() is None for e in victims)
    lost = sum(s["n"] - len(s["got"]) + len(s["errs"]) for s in stages) + snap["failed"]
    unequal = sum(not np.array_equal(np.asarray(v), np.asarray(want[i % len(want)]))
                  for s in stages for i, v in s["got"].items())
    problems = []
    if not removes or lapsed or (adds, removes) != (len(added), len(victims)) \
            or 1 + adds - removes != final[1]:
        problems.append(f"decisions {moved}, {len(added)} replicas added and {len(victims)} "
                        f"removed: want a scale-up, then scale-downs (each vetoed one "
                        f"reverted) back to one replica")
    if final != ("ok", 1, "ok"):
        problems.append(f"at the end state/replicas/healthz {final}, want ok/1/ok")
    if lost or unequal:
        problems.append(f"{lost} requests lost, {unequal} answers not bitwise the "
                        "featurizer's rows")
    if stem_launches != n_batches:
        problems.append(f"stem launches {stem_launches} for {n_batches:.0f} batches")
    short = {i: stats[i].get("graphs") for i in added if stats[i].get("graphs") != len(buckets)}
    if short:
        problems.append(f"added replicas joined with CUDA graphs {short} for {len(buckets)} "
                        "buckets")
    if not sig.deferred_healthz or set(sig.deferred_healthz) != {"degraded"}:
        problems.append(f"{AUTOSCALE_FAULTS['replicas']}: healthz while deferred "
                        f"{sig.deferred_healthz}")
    if problems:
        raise AssertionError("[autoscale] (a) " + "; ".join(problems))
    first_live = up.get("first_live", math.nan) - up["built"]
    down_s = down["t"] - t_down
    names = ("2 clients", f"{AUTOSCALE_BURST} at once", "2 clients")
    print(f"[autoscale] (a) AutoScaler(pool=, warmup_arrays=every bucket {buckets}, "
          f"AutoscalePolicy(min_replicas=1, max_replicas=2)).start() (a tick every "
          f"{scaler.interval_s} s) over ServingEngine(ReplicaPool(n_replicas=1)) of "
          f"DeepImageFeaturizer(InceptionV3, weights='random') runners on cuda:0, "
          f"reading sparkdl_queue_depth and an SLOTracker (p95 under "
          f"{AUTOSCALE_SLO_S * 1e3:.0f} ms, {AUTOSCALE_SLO_WINDOW_S:.0f} s window); {card}: "
          + "; ".join(f"stage {k + 1} ({name}, {s['n']} requests) {s['n'] / s['secs']:.1f} "
                      f"requests/s, p50 {s['p50']:.1f} ms p99 {s['p99']:.1f} ms"
                      for k, (name, s) in enumerate(zip(names, stages))))
    print(f"[autoscale] (a) decisions {[d[:2] for d in moved]} ("
          f"{len(_events(seq0, 'autoscale.veto'))} vetoes); scale-up: add_replica "
          f"{_events(seq0, 'pool.scale_up')[0]['t'] - up['built']:.2f} s ({up['graphs']} "
          f"graphs captured in {up['capture_s']:.2f} s before it routed), up-decision to its "
          f"first served batch {first_live:.2f} s; scale-down of replica {down['replica']} "
          f"after {AUTOSCALE_FAULTS['replicas']} deferred the first attempt (healthz "
          f"{'/'.join(sig.deferred_healthz)} while deferred, {final[2]} after), "
          f"{down_s:.1f} s after stage 3 began, victims' runners "
          f"{'freed' if victims_freed else 'NOT freed'}; memory_reserved "
          f"{reserved0:.2f} GiB before the scale-up, {up['reserved_gib']:.2f} after it, "
          f"{reserved_down:.2f} after the scale-down; 0 lost, "
          f"{sum(len(s['got']) for s in stages)} answers bitwise the featurizer's rows; "
          f"kernel launches: inception_stem_fused {stem_launches} = {n_batches:.0f} "
          f"batches (warmups included); {time.perf_counter() - t0:.1f} s")
    return {"stages": [{"requests_s": s["n"] / s["secs"], "p50_ms": s["p50"],
                        "p99_ms": s["p99"]} for s in stages],
            "up_to_first_batch_s": first_live, "capture_s": up["capture_s"],
            "reserved_gib": (reserved0, up["reserved_gib"], reserved_down)}


def _pool_whole(pool) -> "str | None":
    """Why the block pool's ids do not add up (None when they do):
    free, spare and allocated-or-cached ids partition the real blocks,
    and the scratch block at the sentinel id is in none of them."""
    free, spare = list(pool._free), list(pool._spare)
    held = {b for b in range(pool.n_blocks) if not pool._is_free[b]}
    ids = set(free) | set(spare)
    if len(ids) != len(free) + len(spare) or ids & held:
        return "an id is listed twice"
    if ids | held != set(range(pool.n_blocks)):
        return f"{pool.n_blocks - len(ids | held)} blocks in no list"
    if pool.sentinel in ids:
        return f"the sentinel {pool.sentinel} is listed"
    return None


def _autoscale_kv(card: str, cfg, model, prompts, want) -> tuple:
    """(b) The KV tier: an AutoScaler on one engine's
    kv_autoscale_binding(); a quiet spell parks the serving share down,
    a burst defers admissions and the scaler grows it back."""
    import numpy as np

    from sparkdl_torch.autoscale import AutoScaler, AutoscalePolicy
    from sparkdl_torch.observability.flight import healthz_report
    from sparkdl_torch.reliability.faults import inject

    t0 = time.perf_counter()
    eng = _serve_engine(cfg, model, host_id="autoscale-0")
    pool, lock = eng.kv_autoscale_binding()
    eng.start()
    step = AUTOSCALE_KV_STEP
    parked_sentinel = []

    def shrunk_to_floor():
        if pool.sentinel in pool._spare:  # only a shrink parks blocks
            parked_sentinel.append("the sentinel block parked")
        return pool.spare_count and pool.free_count < max(1, pool.need_peak) + 2 * step

    sig = _Signals()
    scaler = AutoScaler(kv_pool=pool, kv_lock=lock, signals=sig, interval_s=AUTOSCALE_TICK_S,
                        policy=AutoscalePolicy(kv_step_blocks=step, cooldown_ticks=1))
    sig.scaler = scaler
    seq0 = _flight_seq()
    deferred0 = _metric("sparkdl_kv_admission_deferred_total")
    with inject(AUTOSCALE_FAULTS["kv"]):
        scaler.start()
        quiet_s = _wait_for("quiet-spell shrink to the floor", shrunk_to_floor)
    parked = pool.spare_count
    t1 = time.perf_counter()
    futs = [eng.submit(p, SERVE_NEW) for p in prompts]
    outs = [np.asarray(f.result(timeout=600)) for f in futs]
    burst_s = time.perf_counter() - t1
    hz = (scaler.state, healthz_report()["status"])
    scaler.close()
    deferred = _metric("sparkdl_kv_admission_deferred_total") - deferred0
    moved = [d[:2] for d in _decisions(seq0, [scaler])]
    # the quiet spell's shrinks, then the burst's grows
    downs = moved[:(moved + [("kv", "up")]).index(("kv", "up"))].count(("kv", "down"))
    with lock:
        spare_end = pool.spare_count
        pool.grow(spare_end)  # the whole pool back in service for (c)
        broken = _pool_whole(pool)
    _same_outs("autoscale", "(b) KV tier", [outs], [want])
    problems = parked_sentinel[:1]
    if not downs or ("kv", "up") not in moved or not deferred:
        problems.append(f"decisions {moved} with {deferred:.0f} deferred admissions: want "
                        "shrinks in the quiet spell, then a grow under deferrals")
    if broken:
        problems.append(broken)
    if set(sig.deferred_healthz) != {"degraded"} or hz != ("ok", "ok"):
        problems.append(f"{AUTOSCALE_FAULTS['kv']}: healthz {sig.deferred_healthz} while "
                        f"deferred, state/healthz {hz} after the burst")
    if problems:
        raise AssertionError("[autoscale] (b) " + "; ".join(problems))
    print(f"[autoscale] (b) AutoScaler(kv_pool=, kv_lock=) from kv_autoscale_binding() of a "
          f"ContinuousGPTEngine GPT-2 small ({SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}, "
          f"{pool.n_blocks} blocks of {SERVE_BLOCK}, chunk {SERVE_CHUNK}), "
          f"kv_step_blocks {step}, a tick every {AUTOSCALE_TICK_S} s; {card}: the quiet spell "
          f"parked {parked} blocks in {quiet_s:.2f} s ({downs} shrinks, the first deferred by "
          f"{AUTOSCALE_FAULTS['kv']}: healthz {'/'.join(sig.deferred_healthz)} then, {hz[1]} "
          f"after the burst); a burst of "
          f"{len(prompts)} prompts of 8..{SERVE_CHUNK} tokens deferred {deferred:.0f} "
          f"admissions and the scaler grew the pool back ({moved.count(('kv', 'up'))} grows, "
          f"{spare_end} blocks still spare when the burst ended) in {burst_s:.2f} s; tokens "
          f"bitwise an engine that never resized in {len(prompts)}/{len(prompts)}; the "
          f"sentinel block never parked, the pool's {pool.n_blocks} blocks whole; "
          f"{_no_launches('(b)')}; {time.perf_counter() - t0:.1f} s")
    return eng, {"parked": parked, "burst_s": burst_s}


def _autoscale_fleet(card: str, cfg, models, eng_b, prompts, want) -> dict:
    """(c) The fabric tier: an AutoScaler over Router(policy='affinity')
    of two InProcessHosts parks one in a quiet spell and rejoins it under
    a burst (its first pass deferred by a counted fault); then
    tier_autoscalers over a PhaseRouter of one PrefillWorker and two
    DecodeWorkers park a decode host and rejoin it under a burst. The
    fresh host of each is first in its tier, so the tie of an idle fleet
    parks it, and it captures its programs only after it rejoins."""
    from sparkdl_torch.autoscale import AutoScaler, AutoscalePolicy
    from sparkdl_torch.disagg import DecodeWorker, PhaseRouter, PrefillWorker, tier_autoscalers
    from sparkdl_torch.fabric import InProcessHost, Router
    from sparkdl_torch.observability.flight import healthz_report
    from sparkdl_torch.reliability.faults import inject

    import numpy as np

    t0 = time.perf_counter()
    model, model_f = models
    eng_f = _serve_engine(cfg, model_f, host_id="autoscale-1")
    taps = [_Tap(InProcessHost(e)) for e in (eng_f, eng_b)]
    eng_f.start()
    router = Router([t.host for t in taps], policy="affinity", auto_refresh=False)
    sig = _Signals()
    scaler = AutoScaler(router=router, signals=sig, interval_s=AUTOSCALE_TICK_S,
                        policy=AutoscalePolicy(min_hosts=1, max_hosts=2))
    sig.scaler = scaler
    seq0 = _flight_seq()
    deferred0 = _metric("sparkdl_autoscale_deferred_total")
    head = 3 * len(prompts) // 4
    try:
        with inject(AUTOSCALE_FAULTS["fabric"]):
            scaler.start()
            park_s = _wait_for("host parked", lambda: scaler.spare_hosts)
        parked = scaler.spare_hosts[0].host_id
        submit = lambda p: router.submit({"prompt": p, "max_new_tokens": SERVE_NEW})  # noqa: E731
        futs, sent, rejoin_s = _burst_until_rejoin(submit, prompts[:head], scaler)
        hz = (scaler.state, healthz_report()["status"])
        hosts_end = len(router.hosts())
        scaler.close()
        served0 = len(taps[0].futs)
        futs += [submit(p) for p in prompts[head:]]
        sent += list(range(head, len(prompts)))
        outs = [np.asarray(f.result(timeout=600)) for f in futs]
    finally:
        scaler.close()
        router.close()
    fabric_deferred = _metric("sparkdl_autoscale_deferred_total") - deferred0
    rejoined_served = len(taps[0].futs) - served0
    _same_outs("autoscale", "(c) fabric tier", [outs], [[want[i] for i in sent]])
    problems = []
    moved = _decisions(seq0, [scaler])
    adds, removes, lapsed = _net(moved, "host")
    if not removes or lapsed or adds != removes or hosts_end != 2 \
            or parked != eng_f.host_id:
        problems.append(f"decisions {moved}, {hosts_end} hosts at the end, parked {parked}: "
                        f"want {eng_f.host_id} parked and rejoined")
    if fabric_deferred != 1 or set(sig.deferred_healthz) != {"degraded"} or hz != ("ok", "ok"):
        problems.append(f"{AUTOSCALE_FAULTS['fabric']}: {fabric_deferred:.0f} deferred "
                        f"passes, healthz {sig.deferred_healthz} while deferred, state/"
                        f"healthz {hz} after")
    if not rejoined_served:
        problems.append(f"the rejoined {parked} served nothing")
    if problems:
        raise AssertionError("[autoscale] (c) fabric: " + "; ".join(problems))
    fabric = {"park_s": park_s, "rejoin_s": rejoin_s}
    line = (f"[autoscale] (c) AutoScaler(router=Router(policy='affinity') over two "
            f"InProcessHosts, {eng_f.host_id} on {eng_f.device} and {eng_b.host_id} on "
            f"{eng_b.device}), AutoscalePolicy(min_hosts=1, max_hosts=2); {card}: the first "
            f"pass deferred by {AUTOSCALE_FAULTS['fabric']} (nothing moved, healthz "
            f"{'/'.join(sig.deferred_healthz)}, then state {hz[0]}, healthz {hz[1]}); the "
            f"quiet spell drained {parked} into spare_hosts in {park_s:.2f} s with 0 lost; "
            f"{len(sent) - len(prompts) + head} prompts rejoined it (reopen + add_host) "
            f"{rejoin_s:.2f} s after the first was submitted, and it served "
            f"{rejoined_served} of the last {len(prompts) - head}; tokens bitwise one "
            f"engine's in {len(sent)}/{len(sent)}")
    # the disaggregated tiers, each scaled on its own signal
    tier_kw = dict(n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, kv_block_size=SERVE_BLOCK,
                   prefill_chunk=SERVE_CHUNK, auto_start=True)
    pre = PrefillWorker(cfg, model, host_id="autoscale-p0", **tier_kw)
    decs = [DecodeWorker(cfg, model_f, host_id="autoscale-d1", **tier_kw),
            DecodeWorker(cfg, model, host_id="autoscale-d0", **tier_kw)]
    tp = _Tap(InProcessHost(pre))
    tds = [_Tap(InProcessHost(d)) for d in decs]
    tier_prompts = prompts[:AUTOSCALE_TIER_REQS]
    head = 3 * len(tier_prompts) // 4
    pr = PhaseRouter([tp.host], [t.host for t in tds], auto_refresh=False,
                     max_handoff_retries=4)
    pre_s, dec_s = tier_autoscalers(
        pr, prefill_policy=AutoscalePolicy(),
        decode_policy=AutoscalePolicy(min_hosts=1, max_hosts=2), interval_s=AUTOSCALE_TICK_S)
    seq0 = _flight_seq()
    try:
        pre_s.start()
        dec_s.start()
        tier_park_s = _wait_for("decode host parked", lambda: dec_s.spare_hosts)
        tier_parked = dec_s.spare_hosts[0].host_id
        futs, sent, tier_rejoin_s = _burst_until_rejoin(
            lambda p: pr.submit(p, SERVE_NEW), tier_prompts[:head], dec_s)
        tier_hosts_end = len(pr.decode.hosts())
        pre_s.close()
        dec_s.close()
        served0 = len(tds[0].futs)
        futs += [pr.submit(p, SERVE_NEW) for p in tier_prompts[head:]]
        sent += list(range(head, len(tier_prompts)))
        outs = [np.asarray(f.result(timeout=600)) for f in futs]
        tier_served = len(tds[0].futs) - served0
    except BaseException:
        pre_s.close()
        dec_s.close()
        pr.close()
        for e in (pre, *decs):
            e.close(drain=False)
        raise
    _same_outs("autoscale", "(c) disaggregated tiers", [outs], [[want[i] for i in sent]])
    tier_moves = _decisions(seq0, [pre_s, dec_s])
    adds, removes, lapsed = _net(tier_moves, "host")
    if pre_s.decision_count or not removes or lapsed or adds != removes or tier_hosts_end != 2 \
            or tier_parked != decs[0].host_id or not tier_served:
        raise AssertionError(f"[autoscale] (c) tiers: decisions {tier_moves} "
                             f"({pre_s.decision_count} of the prefill tier's), "
                             f"{tier_hosts_end} decode hosts at the end, parked "
                             f"{tier_parked}, it served {tier_served} after its rejoin")
    print(line)
    print(f"[autoscale] (c) tier_autoscalers over PhaseRouter(PrefillWorker {pre.host_id} on "
          f"{pre.device} -> DecodeWorkers {decs[0].host_id} on {decs[0].device}, "
          f"{decs[1].host_id} on {decs[1].device}); {card}: the quiet spell parked decode "
          f"host {tier_parked} in {tier_park_s:.2f} s (the prefill tier, one host at "
          f"min_hosts, moved nothing); {len(sent) - len(tier_prompts) + head} split "
          f"requests rejoined it {tier_rejoin_s:.2f} s after the first was submitted, and "
          f"it decoded {tier_served} of the last {len(tier_prompts) - head}; tokens bitwise "
          f"the colocated engine's in {len(sent)}/{len(sent)}; "
          f"{_no_launches('(c)')}; {time.perf_counter() - t0:.1f} s")
    return {**fabric, "tiers": (pr, pre, decs, tp), "engines": (eng_f,),
            "tier_park_s": tier_park_s, "tier_rejoin_s": tier_rejoin_s}


def _fleet_families(text: str) -> list:
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith("# TYPE") or ln.startswith("sparkdl_fleet_host_up"))


def _autoscale_scraper(card: str, tiers, prompt, want_tokens) -> dict:
    """(d) The fleet scraper over (c)'s tiers, tracing on: one split
    request's fleet_trace is one trace of both tiers' spans, whose
    stitched phases stand beside its measured TTFT; FleetServer on
    127.0.0.1 answers /fleet/trace/<id>, /fleet/metrics and
    /fleet/healthz as the in-process calls do."""
    import urllib.request

    import numpy as np

    from sparkdl_torch.observability import tracing
    from sparkdl_torch.observability.fleet import FleetScraper, FleetServer

    t0 = time.perf_counter()
    pr, pre, decs, tp = tiers
    tracing.clear_trace()
    tracing.enable_tracing()
    try:
        sent = time.perf_counter()
        out = np.asarray(pr.submit(prompt, SERVE_NEW).result(timeout=600))
        e2e = time.perf_counter() - sent
        ttft = tp.futs[-1][1].ttft_s
        wire = [e for e in tracing.trace_events() if e["name"] == "handoff.wire"]
        if len(wire) != 1:
            raise AssertionError(f"[autoscale] (d) {len(wire)} handoff.wire spans for one "
                                 "split request")
        rid = wire[0]["args"]["request_id"]
        scraper = FleetScraper.from_phase_router(pr)
        stitched = scraper.fleet_trace(rid)
        names = [e["name"] for e in stitched["spans"]]
        phases = stitched["phases"]
        with FleetServer(scraper, host="127.0.0.1") as srv:
            def get(path):
                with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                            timeout=30) as r:
                    return r.read().decode()

            local = {"trace": json.loads(json.dumps(scraper.fleet_trace(rid), default=repr)),
                     "healthz": json.loads(json.dumps(scraper.fleet_healthz(), default=repr)),
                     "metrics": _fleet_families(scraper.fleet_metrics())}
            http = {"trace": json.loads(get(f"/fleet/trace/{rid}")),
                    "healthz": json.loads(get("/fleet/healthz")),
                    "metrics": _fleet_families(get("/fleet/metrics"))}
        offsets = scraper.clock_offsets()
    finally:
        tracing.disable_tracing()
        tracing.clear_trace()
    _same_outs("autoscale", "(d) traced split request", [[out]], [[want_tokens]])
    hosts = {scraper.tier_of(h) for h in scraper.hosts()}
    problems = []
    if names.count("handoff.wire") != 1 or not {"disagg.handoff_export",
                                                "disagg.handoff_install"} <= set(names):
        problems.append(f"the stitched trace holds {sorted(set(names))}")
    if hosts != {"prefill", "decode"} or phases is None:
        problems.append(f"tiers {hosts}, phases {phases}")
    for k in local:
        if local[k] != http[k]:
            problems.append(f"/fleet/{k} differs from the in-process call")
    if problems:
        raise AssertionError("[autoscale] (d) " + "; ".join(problems))
    by = {f"{p['phase']} {p['tier']}": p["seconds"] * 1e3 for p in phases}
    print(f"[autoscale] (d) FleetScraper.from_phase_router over (c)'s tiers "
          f"({len(scraper.hosts())} hosts), tracing on; {card}: one split request's "
          f"fleet_trace is one trace of {len(names)} spans over both tiers (one "
          f"handoff.wire, export and install); stitched phases "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in by.items())
          + f" (sum {sum(by.values()):.1f} ms) beside its TTFT {ttft * 1e3:.1f} ms (first "
          f"token out at the export) and end to end {e2e * 1e3:.1f} ms; FleetServer on "
          f"127.0.0.1 served /fleet/trace/{rid}, /fleet/metrics and /fleet/healthz equal "
          f"to the in-process calls; clock_offsets() "
          + ", ".join(f"{h} {o:+.1f} us" for h, o in offsets.items())
          + f"; {_no_launches('(d)')}; {time.perf_counter() - t0:.1f} s")
    return {"phases_ms": by, "ttft_ms": ttft * 1e3, "e2e_ms": e2e * 1e3}


def phase_autoscale(card: str, served: dict) -> dict:
    """The fleet's autoscaler on the card: (a) the replica tier over the
    featurizer's runners (the stem kernel's path), (b) the KV tier of a
    continuous engine, (c) the fabric's and the disaggregated tiers'
    hosts, each scale move lossless and every answer bitwise an unscaled
    run's, each counted fault deferring once; (d) the fleet scraper's
    stitched trace of a split request, in process and over HTTP."""
    import torch

    t_phase = time.perf_counter()
    out = {"replicas": _autoscale_replicas(card, served)}
    cfg, model = _gpt2_small()
    cards = torch.cuda.device_count()
    model_f = _gpt2_small("cuda:1")[1] if cards >= 2 else model
    prompts = _fleet_prompts(cfg.vocab_size, 30, AUTOSCALE_REQS + 1)
    _zero_counts()
    t0 = time.perf_counter()
    ref = _serve_engine(cfg, model)
    want = _burst(ref, prompts)["outs"]
    ref.close()
    print(f"[autoscale] (b)-(d) GPT-2 small ({cfg.num_layers}x{cfg.hidden_size}, float32, "
          f"random init seed 0) at [serve]'s settings; {len(prompts)} prompts of "
          f"8..{SERVE_CHUNK} tokens, {SERVE_NEW} greedy tokens each, through one engine that "
          f"never scales: the reference, {time.perf_counter() - t0:.1f} s; "
          + (f"{cards} cards: the fresh fabric host and decode worker on cuda:1, so each "
             "rejoin captures there" if cards >= 2 else
             "1 card: the two-card placement (the fresh fabric host and decode worker on "
             "cuda:1, each rejoin capturing there) is skipped"))
    eng_b, out["kv"] = _autoscale_kv(card, cfg, model, prompts[:-1], want[:-1])
    try:
        out["fleet"] = fleet = _autoscale_fleet(card, cfg, (model, model_f), eng_b,
                                                prompts[:-1], want[:-1])
        pr, pre, decs, _ = fleet["tiers"]
        try:
            out["scraper"] = _autoscale_scraper(card, fleet["tiers"], prompts[-1], want[-1])
        finally:
            pr.close()
            for e in (pre, *decs, *fleet["engines"]):
                e.close(drain=False)
    finally:
        eng_b.close(drain=False)
    del model, model_f
    torch.cuda.empty_cache()
    print(f"[autoscale] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_profile(card: str) -> dict:
    """trace() around one featurizer batch, in a fresh process (as an
    operator captures one): the Chrome trace names the stem kernel's
    symbol and the annotate()d range, and a second window around a
    CUDA-graph replay of the batch shows the replay's kernels. The same
    two windows in this process, after every earlier phase, are printed
    beside them."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sparkdl-chip-trace-") as logdir:
        child = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--profile-child", logdir],
                               capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            raise AssertionError(f"[profile] the tracing process failed: "
                                 f"{child.stderr[-2000:]}")
        fresh = json.loads(child.stdout.strip().splitlines()[-1])
        here = _profile_batch(logdir)
    first = fresh[0]
    if not (first["stem"] and first["ranges"] and first["finite"]
            and first["launches"] == 1):
        raise AssertionError(
            f"[profile] trace of {first['events']} events: {first['kernels']} kernels, "
            f"{len(first['stem'])} stem kernel(s) for {first['launches']} launch(es), "
            f"{len(first['ranges'])} annotated range(s)")
    stem = first["stem"][0]
    seen = lambda w: (f"{w['kernels']} kernels ({w['device_ms']:.2f} ms device) and "  # noqa: E731
                      f"{w['memcpys']} copies, stem kernel "
                      f"{'seen' if w['stem'] else 'NOT seen'} for {w['launches']} "
                      "launch(es)")
    print(f"[profile] trace() around one DeepImageFeaturizer(InceptionV3) batch of "
          f"{BATCH} on an eager runner (chain_k=1), in a fresh process; {card}: Chrome "
          f"trace {first['mb']:.1f} MB, {first['events']} events, {seen(first)} "
          f"({stem['name'][:48]} {stem['dur'] / 1e3:.3f} ms), annotated range "
          f"'sparkdl.featurize_batch' {first['ranges'][0].get('dur', 0) / 1e3:.1f} ms; "
          f"the same batch as a CUDA-graph replay: {seen(fresh[1])}; in this process "
          f"after the earlier phases: eager {seen(here[0])}, replay {seen(here[1])}; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"stem_ms": stem["dur"] / 1e3}


def _launch_counts() -> dict:
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from sparkdl_torch.ops.flash_decode import flash_decode
    from sparkdl_torch.ops.fused_gemm_bn import gemm_bn_stats
    from sparkdl_torch.ops.stem_fused import inception_stem_fused

    return {"inception_stem_fused": inception_stem_fused.launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_bwd_dq": flash_attention_bwd.launches_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd.launches_dkv,
            "flash_decode": flash_decode.launches, "gemm_bn_stats": gemm_bn_stats.launches}


def main() -> int:
    # a fixed cuBLAS workspace, which deterministic algorithms need
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    card = phase_card()
    import sparkdl_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_build()
    stem = phase_stem()
    attn = phase_flash_attention(card)
    decode = phase_flash_decode(card)
    dq, dkv, bert_fwd = phase_flash_attention_bwd(card)
    gemm = phase_fused_gemm_bn(card)
    bn = phase_bn_train(card)
    images_s = phase_main_path(stem, card)
    tokens_s = phase_generate(card, attn, decode)
    examples_s, bert_step_ms = phase_train_bert(card, dq, dkv, bert_fwd)
    train_dp = phase_train_dp(card, bert_step_ms)
    parallel = phase_parallel(card, attn, decode)
    dp = phase_dp(card, stem)
    train_images_s = phase_train_resnet(card, gemm)
    zoo_rates = phase_zoo(card)
    zoo_bf16 = phase_zoo_bf16(card, stem, attn)
    keras_side = phase_keras(card)
    tf_side = phase_tf_graph(card)
    phase_vit(card, attn)
    text_rate = phase_text(card, attn)
    hpo = phase_hpo(card)
    serve = phase_serve(card)
    pool = phase_replicas(card, serve)
    tiers = phase_tiers(card)
    sp_serve = phase_sp_serve(card)
    fabric = phase_fabric(card)
    disagg = phase_disagg(card)
    phase_autoscale(card, serve)
    phase_profile(card)
    kernels = [stem, attn, dq, dkv, decode, gemm, bn]
    print(f"[summary] {card}: zoo featurizer images/s "
          + ", ".join(f"{n} {r:.1f}" for n, r in zoo_rates.items())
          + "; zoo at bfloat16 a batch of 64 "
          + ", ".join(f"{n} {z['bf16_ms']:.2f} ms vs {z['f32_ms']:.2f} ms float32 (rel err "
                      f"{z['rel_err']:.1e})" for n, z in zoo_bf16.items())
          + f"; registerKerasImageUDF ResNet50 {keras_side['rows_s']:.1f} rows/s"
          + f"; TFImageTransformer ResNet50 graph {tf_side['rows_s']:.1f} rows/s "
          f"({tf_side['ms']:.2f} ms a batch of {TF_BATCH}), TFTransformer MLP "
          f"{tf_side['mlp_rows_s']:.1f} rows/s"
          + f"; DeepTextFeaturizer BERT-base {text_rate:.1f} examples/s; flash_attention "
          f"at ViT-B/16 B={BATCH} L=197 {attn['vit_ms']:.4f} ms (plain "
          f"{attn['vit_plain_ms']:.4f}, SDPA {attn['vit_library_ms']:.4f}, bound "
          f"{attn['vit_bound_ms']:.4f}), at BERT-base inference B={TEXT_BATCH} "
          f"L={TEXT_LEN} masked {attn['text_ms']:.4f} ms (plain {attn['text_plain_ms']:.4f}, "
          f"SDPA {attn['text_library_ms']:.4f}, bound {attn['text_bound_ms']:.4f}); HPO "
          f"trials {', '.join(f'{s:.1f}' for s in hpo['seconds'])} s; ContinuousGPTEngine "
          f"GPT-2 small {serve['tokens_s']:.1f} tokens/s; ServingEngine InceptionV3 "
          f"{serve['requests_s']:.1f} requests/s, over ReplicaPool({REPLICAS}) "
          f"{pool['requests_s']:.1f} requests/s (p50 {pool['p50_ms']:.1f} ms, p99 "
          f"{pool['p99_ms']:.1f} ms); KV park/unpark per block "
          + ", ".join(f"{dt} {t['park_ms']:.3f}/{t['unpark_ms']:.3f} ms (bound "
                      f"{t['bound_ms']:.4f})" for dt, t in tiers.items())
          + "; ContinuousGPTEngine warm TTFT p50 " + ", ".join(
              f"sp={sp} {statistics.median(r['ttft'][1]) * 1e3:.1f} ms"
              for sp, r in sp_serve.items()) + " (sp=2 both shards on the one card)")
    print(f"[summary] {card}: featurizer {images_s:.1f} images/s; generator "
          f"{tokens_s:.1f} tokens/s; BERT-base fine-tune {examples_s:.1f} examples/s; "
          f"ResNet50 training {train_images_s:.1f} images/s; MoE GPT-2 small "
          f"{parallel['moe_tokens_s']:.1f} tokens/s (an MoE layer {parallel['moe_ms']:.3f} "
          f"ms vs a dense MLP {parallel['dense_ms']:.3f}); [dp] featurizer "
          f"{dp['images_s']:.1f} images/s over {dp['cards']} card(s), two replicas on one "
          f"{dp['pair_images_s']:.1f} (runner.run), generator {dp['tokens_s']:.1f} "
          f"tokens/s; [train_dp] BERT-base "
          f"through TorchRunner/finetune_classifier with checkpoints every "
          f"{TRAIN_DP_EVERY} steps {train_dp['loop_examples_s']:.1f} examples/s over the "
          f"whole call (saves included); step-only {train_dp['examples_s']:.1f} "
          f"examples/s, MFU {train_dp['mfu']:.4f} (f32 peak), step "
          f"{train_dp['step_ms']:.2f} ms ({train_dp['bare_step_ms']:.2f} with no "
          f"checkpoints); one checkpoint save {train_dp['save_ms']:.1f} ms / "
          f"wait {train_dp['wait_ms']:.1f} ms / restore {train_dp['restore_ms']:.1f} ms; "
          f"flash_attention at the "
          f"GPT-2 prefill {attn['ms']:.4f} ms (SDPA {attn['library_ms']:.4f}, bound "
          f"{attn['bound_ms']:.4f}), at the "
          f"BERT training shape {bert_fwd['ms']:.4f} ms (plain {bert_fwd['plain_ms']:.4f}, "
          f"SDPA {bert_fwd['library_ms']:.4f}, bound {bert_fwd['bound_ms']:.4f}), "
          f"{bert_fwd['bert_launches']} launches in [train_bert]; gemm_bn_stats "
          f"{gemm['ms']:.3f} ms a ResNet50 step (plain {gemm['plain_ms']:.3f}, bare matmul "
          f"{gemm['matmul_ms']:.3f}, bound {gemm['bound_ms']:.3f}); kernel ms vs bound ms: "
          + ", ".join(f"{k['name']} {k['ms']:.4f} vs {k['bound_ms']:.4f}" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profile-child"]:  # phase_profile's fresh process
        import torch

        torch.backends.cudnn.allow_tf32 = False  # as phase_card sets them
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(_profile_batch(sys.argv[2])))
    else:
        sys.exit(main())
