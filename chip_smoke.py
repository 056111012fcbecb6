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
- the fused ResNet50 train step at 224 px, batch 64 (the fused 1x1-conv
  GEMM + BN-stats kernel), one CUDA graph a step;
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

    ms = _time_ms(lambda: inception_stem_fused(x_f32, folded))
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
    return BERT_STEPS * b / secs


def phase_train_resnet(card: str, gemm_entry: dict) -> float:
    """The fused ResNet50 train step (bench_train.py's recipe) at 224 px,
    batch 64, as a CUDA graph: against the eager step (bitwise) and
    against make_vision_train_step over the plain module."""
    import copy

    import numpy as np
    import torch

    from sparkdl_torch.models.common import init_zoo_
    from sparkdl_torch.models.resnet import ResNet50
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
          f"launches {launches} = 25 x {RESNET_STEPS} ({_launch_names(graph.launches)} "
          f"a replay); graphed vs eager over {RESNET_STEPS} steps under deterministic "
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

    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
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
    rng = np.random.default_rng(11)
    images, rows = _image_rows(rng, SIZE)
    want = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="InceptionV3",
                               weights="random", batchSize=BATCH).transform(
        LocalDataFrame.from_rows(rows, N_PARTS)).collect()
    want = {r["id"]: r["f"] for r in want}
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
    return {"tokens_s": total / warm["secs"], "requests_s": N_ROWS / secs,
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


def _closed_loop(eng, rows, ids, threads: int) -> tuple:
    """``ids`` requests from ``threads`` closed-loop client threads:
    (answers by id, errors, seconds)."""
    got, errs = {}, []

    def client(part):
        try:
            for i in part:
                got[i] = eng.submit(rows[i]["image"]).result(timeout=120)
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
        raise AssertionError("[replicas] a client thread did not finish")
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
    images_s = phase_main_path(stem, card)
    tokens_s = phase_generate(card, attn, decode)
    examples_s = phase_train_bert(card, dq, dkv, bert_fwd)
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
    phase_profile(card)
    kernels = [stem, attn, dq, dkv, decode, gemm]
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
                      f"{t['bound_ms']:.4f})" for dt, t in tiers.items()))
    print(f"[summary] {card}: featurizer {images_s:.1f} images/s; generator "
          f"{tokens_s:.1f} tokens/s; BERT-base fine-tune {examples_s:.1f} examples/s; "
          f"ResNet50 training {train_images_s:.1f} images/s; flash_attention at the "
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
