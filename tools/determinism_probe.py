#!/usr/bin/env python3
"""Are the training paths bitwise reproducible on one GPU, eager and graphed?

    python3 tools/determinism_probe.py

Runs the fused ResNet50 train step (224 px, B=64, SGD momentum, random
weights, seed 0) and BERT-base fine-tuning (``attn_impl="flash"``, 8
batches of 32 x 128, AdamW capturable) three times from the same start:
eager, eager again, and graphed (`train/vision.py`'s and
``finetune_classifier``'s CUDA graphs). It does so twice: with PyTorch's
default algorithms, then with deterministic ones
(``torch.use_deterministic_algorithms(True)``, ``cudnn.deterministic``,
a fixed cuBLAS workspace). For each it prints one JSON object: whether
the losses (BERT: the loss and accuracy history), the final parameters
and (ResNet50) the BatchNorm statistics of the second eager run and of
the graphed run equal the first eager run's bitwise, the first step at
which the losses part, and the host-driven ms a step of each run (host
wall to the device's completion, after its first steps).

The card's name and power limit are printed first. Needs CUDA.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESNET_STEPS, BERT_STEPS, TIMED = 6, 8, 5


def _first_difference(a: list, b: list) -> "int | None":
    return next((i + 1 for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _resnet(torch, np, deterministic: bool) -> dict:
    from sparkdl_torch.models.common import init_zoo_
    from sparkdl_torch.models.resnet import ResNet50
    from sparkdl_torch.train import vision

    base = init_zoo_(ResNet50(num_classes=1000), seed=0)
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.random((64, 224, 224, 3), dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, 64)).cuda()
    runs = []
    for graphed in (False, False, True):
        m = copy.deepcopy(base)
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        step = vision._make_step(m, vision.resnet50_fused_loss_fn(
            m, num_classes=1000, dtype=torch.float32), opt)
        if graphed:
            step = vision._graphed(step, opt, "probe")
        losses = [float(step(x, y)) for _ in range(RESNET_STEPS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            step(x, y)
        torch.cuda.synchronize()
        runs.append((losses, [p.detach().clone() for p in m.parameters()],
                     [b.clone() for b in m.buffers()],
                     (time.perf_counter() - t0) / TIMED * 1e3))
        del m, opt, step
        torch.cuda.empty_cache()
    ref = runs[0]
    out = {"path": "resnet50_fused", "deterministic": deterministic,
           "steps": RESNET_STEPS}
    for name, run in (("eager_again", runs[1]), ("graphed", runs[2])):
        out[name] = {
            "losses_equal": run[0] == ref[0],
            "first_step_apart": _first_difference(run[0], ref[0]),
            "params_equal": all(map(torch.equal, run[1], ref[1])),
            "bn_stats_equal": all(map(torch.equal, run[2], ref[2])),
            "step_ms": run[3]}
    out["eager_step_ms"] = ref[3]
    return out


def _bert(torch, np, deterministic: bool) -> dict:
    from sparkdl_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
        init_bert_,
    )
    from sparkdl_torch.train import finetune_classifier
    from sparkdl_torch.train.finetune import classification_train_step

    cfg = BertConfig.base(attn_impl="flash")
    state = init_bert_(BertForSequenceClassification(cfg, num_labels=2, device="cpu"),
                       seed=0).state_dict()
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(BERT_STEPS):
        mask = np.arange(128)[None, :] < rng.integers(16, 129, 32)[:, None]
        batches.append({"input_ids": rng.integers(0, cfg.vocab_size, (32, 128)) * mask,
                        "attention_mask": mask, "labels": rng.integers(0, 2, 32)})
    runs = []
    for graphed in (False, False, True):
        m = BertForSequenceClassification(cfg, num_labels=2, device="cuda")
        m.load_state_dict(state)
        if graphed:
            _, history = finetune_classifier(m, batches, learning_rate=2e-5,
                                             input_prefetch=0)
            got = [(h["loss"], h["accuracy"]) for h in history]
            ms = float(np.median([h["step_time_s"] for h in history[1:]])) * 1e3
        else:
            opt = torch.optim.AdamW(m.parameters(), lr=2e-5, weight_decay=0.01,
                                    eps=1e-8, capturable=True)
            step = classification_train_step(m, opt)
            got, times = [], []
            for b in batches:
                t0 = time.perf_counter()
                out = step({k: torch.as_tensor(v).cuda() for k, v in b.items()})
                got.append((float(out["loss"]), float(out["accuracy"])))
                times.append(time.perf_counter() - t0)
            ms = float(np.median(times[1:])) * 1e3
        runs.append((got, [p.detach().clone() for p in m.parameters()], ms))
        del m
        torch.cuda.empty_cache()
    ref = runs[0]
    out = {"path": "bert_base_finetune", "deterministic": deterministic,
           "steps": BERT_STEPS}
    for name, run in (("eager_again", runs[1]), ("graphed", runs[2])):
        out[name] = {"history_equal": run[0] == ref[0],
                     "first_step_apart": _first_difference(run[0], ref[0]),
                     "params_equal": all(map(torch.equal, run[1], ref[1])),
                     "step_ms": run[2]}
    out["eager_step_ms"] = ref[2]
    return out


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    import torch.utils.deterministic

    if not torch.cuda.is_available():
        raise SystemExit("determinism_probe: CUDA is not available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        torch.backends.cudnn.deterministic = deterministic
        torch.utils.deterministic.fill_uninitialized_memory = False
        for run in (_resnet, _bert):
            print(json.dumps(run(torch, np, deterministic)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
