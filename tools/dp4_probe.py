#!/usr/bin/env python3
"""BERT-base fine-tuning across four GPUs of one host, against one GPU.

    python3 tools/dp4_probe.py

``TorchRunner(np=-4)`` starts four NCCL ranks, one card each; each feeds
a quarter of every global batch (B=32, L=128, 8 steps) through
``finetune_classifier`` under ZeRO on a dp=2 x fsdp=2 mesh, then under
plain dp=4. Prints each run's losses against the same fine-tune on one
card (max relative difference), the median step ms, the flash kernels'
launches and train dispatches of rank 0, and the optimizer-state bytes
a rank holds. Needs four cards.
"""
import json, math, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import chip_smoke as cs

STEPS = 8


def batches():
    import numpy as np
    from sparkdl_torch.models.bert import BertConfig
    cfg = BertConfig.base()
    rng = np.random.default_rng(9)
    out = []
    for _ in range(STEPS):
        lens = rng.integers(16, 129, 32)
        mask = (np.arange(128)[None, :] < lens[:, None]).astype(np.int64)
        out.append({"input_ids": rng.integers(0, cfg.vocab_size, (32, 128)) * mask,
                    "attention_mask": mask, "labels": rng.integers(0, 2, 32)})
    return out


def model(device):
    import torch
    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification, init_bert_
    cfg = BertConfig.base(attn_impl="flash")
    m = init_bert_(BertForSequenceClassification(cfg, num_labels=2, device="cpu"), seed=0)
    return m.to(device)


def rank_body():
    import torch, torch.distributed as dist
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from sparkdl_torch.partition import DataParallelPartitioner, make_mesh
    from sparkdl_torch.observability.registry import registry
    from sparkdl_torch.runtime.dispatch import dispatch_count
    from sparkdl_torch.train import finetune_classifier
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, w = dist.get_rank(), dist.get_world_size()
    n = 32 // w
    local = [{k: v[r * n:(r + 1) * n] for k, v in b.items()} for b in batches()]
    out = {}
    for name, part in (("zero", DataParallelPartitioner(make_mesh(dp=2, fsdp=2), zero_axis="fsdp")),
                       ("dp", DataParallelPartitioner(make_mesh(dp=4)))):
        cs._zero_counts()
        d0 = dispatch_count("train")
        t0 = time.perf_counter()
        _, h = finetune_classifier(model("cuda"), local, learning_rate=2e-5, partitioner=part)
        torch.cuda.synchronize()
        out[name] = {"losses": [x["loss"] for x in h], "wall_s": time.perf_counter() - t0,
                     "step_ms": sorted(x["step_time_s"] for x in h[1:])[(STEPS - 1) // 2] * 1e3,
                     "launches": (flash_attention.launches, flash_attention_bwd.launches_dq,
                                  flash_attention_bwd.launches_dkv),
                     "dispatches": int(dispatch_count("train") - d0)}
    fam = registry().get("sparkdl_opt_state_bytes").labelled_values("axis")
    out["bytes"] = fam
    return out


if __name__ == "__main__":
    import torch
    from sparkdl_torch import TorchRunner
    from sparkdl_torch.train import finetune_classifier
    t0 = time.time()
    card = cs.phase_card()
    cs.phase_build()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dp4_probe  # by reference: each rank imports it
    got = TorchRunner(np=-4, local_platform="cuda", timeout_s=600).run(dp4_probe.rank_body)
    _, ref = finetune_classifier(model("cuda"), batches(), learning_rate=2e-5)
    ref = [x["loss"] for x in ref]
    for name in ("zero", "dp"):
        g = got[name]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(g, ref))
        print(f"[dp4] {card}: {name} over 4 cards, losses {g}, one card {ref}, max rel {rel:.3e}; "
              f"step {got[name]['step_ms']:.2f} ms (B=8 a rank), wall {got[name]['wall_s']:.1f} s, "
              f"launches {got[name]['launches']}, dispatches {got[name]['dispatches']}")
    print("[dp4] opt_state_bytes per rank", json.dumps(got["bytes"]))
    print("probe seconds", time.time() - t0)
