"""sparkdl_torch stands alone: it imports nothing of JAX, Flax,
ml_dtypes or sparkdl_tpu (importing sparkdl_tpu pulls in JAX and sets
KERAS_BACKEND), and neither does chip_smoke.py."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "sparkdl_tpu")

_FEATURIZE_ONE = """
import sys
import numpy as np
import torch
from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
from sparkdl_torch.image import imageArrayToStructBGR
img = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
df = LocalDataFrame.from_rows([{"image": imageArrayToStructBGR(img)}])
out = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="InceptionV3",
                          weights="random", batchSize=1, device="cpu").transform(df)
f = out.first()["f"]
assert f.shape == (2048,) and np.isfinite(f).all()
from sparkdl_torch.native.bridge import FEED_STATS
assert FEED_STATS["ring_batches"] >= 1 and not FEED_STATS["fallback_streams"]
from sparkdl_torch.transformers._inference import BatchedRunner
runner = BatchedRunner(lambda b: b["x"] * 2, batch_size=4, device="cpu",
                       async_fetch=True, autotune=True)
got = list(runner.run({"x": np.full(3, i, np.float32)} for i in range(10)))
assert len(got) == 10 and float(got[9][0]) == 18.0
from sparkdl_torch.ingest import default_tuner
default_tuner().stop()
import io
from PIL import Image
from sparkdl_torch.image import native_decode_bytes
buf = io.BytesIO()
Image.fromarray(img).save(buf, format="PNG")
assert native_decode_bytes(buf.getvalue())["height"] == 32
from sparkdl_torch import DeepTextGenerator
from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, init_gpt_
cfg = GPTConfig.tiny(attn_impl="flash", flash_decode=True)
sd = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
df = LocalDataFrame.from_rows([{"p": [5, 3, 9]}, {"p": [1]}, {"p": []}])
rows = DeepTextGenerator(inputCol="p", outputCol="g", model=(cfg, sd), maxNewTokens=3,
                         device="cpu").transform(df).collect()
assert [len(r["g"]) for r in rows[:2]] == [3, 3] and rows[2]["g"] is None
from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification, init_bert_
from sparkdl_torch.train import finetune_classifier
bert = init_bert_(BertForSequenceClassification(BertConfig.tiny(attn_impl="flash"),
                                                device="cpu"), seed=0)
batch = {"input_ids": np.arange(16).reshape(2, 8) % 128, "attention_mask": np.ones((2, 8)),
         "labels": np.array([0, 1])}
_, history = finetune_classifier(bert, [batch], input_prefetch=2)
assert len(history) == 1 and np.isfinite(history[0]["loss"])
from sparkdl_torch.ops.fused_gemm_bn import conv1x1_bn_stats
y, mean, var = conv1x1_bn_stats(torch.randn(2, 4, 4, 128), torch.randn(128, 8))
assert y.shape == (2, 4, 4, 8) and mean.shape == var.shape == (8,)
from sparkdl_torch import DeepTextFeaturizer, Pipeline
from sparkdl_torch.models.bert import BertModel
tcfg = BertConfig.tiny()
tsd = init_bert_(BertModel(tcfg, device="cpu"), seed=0).state_dict()
feat = DeepTextFeaturizer(inputCol="p", outputCol="f", model=(tcfg, tsd), maxLength=8,
                          device="cpu")
rows = Pipeline(stages=[feat]).fit(df).transform(df).collect()
assert rows[0]["f"].shape == (32,) and np.isfinite(rows[2]["f"]).all()
from sparkdl_torch.hpo import fmin, hp
assert 0 <= fmin(lambda p: p["x"], {"x": hp.uniform("x", 0, 1)}, max_evals=3)["x"] <= 1
from sparkdl_torch.serving import ContinuousGPTEngine, ServingEngine
with ContinuousGPTEngine(cfg, sd, device="cpu", n_slots=2, max_len=16, kv_block_size=4,
                         spec_k=2, kv_dtype="int8") as eng:
    assert len(eng.submit([5, 3, 9], 3).result(timeout=60)) == 3
with ServingEngine(BatchedRunner(lambda b: b["x"] + 1, batch_size=4, device="cpu")) as srv:
    assert float(srv.submit({"x": np.zeros(2, np.float32)}).result(timeout=60)[0]) == 1.0
from sparkdl_torch.serving import ReplicaPool
with ReplicaPool(lambda b: b["x"] + 1, batch_size=4, devices=[torch.device("cpu")] * 2) as pool:
    pool.warmup({"x": np.zeros((2, 2), np.float32)})
    with ServingEngine(pool) as srv:
        assert float(srv.submit({"x": np.zeros(2, np.float32)}).result(timeout=60)[0]) == 1.0
with ContinuousGPTEngine(cfg, sd, device="cpu", n_slots=2, max_len=16, kv_block_size=4,
                         kv_dtype="bf16", host_kv_blocks=2, disk_kv_blocks=8,
                         auto_start=False) as eng:
    fut = eng.submit([5, 3, 9, 2, 7], 3)
    while not fut.done():
        eng.tick()
    assert eng.park_cold() > 0 and eng.export_parked_sessions()["sessions"]
from sparkdl_torch.observability import annotate, trace
import tempfile
with tempfile.TemporaryDirectory() as logdir:
    with trace(logdir) as cap, annotate("probe"):
        torch.ones(4).sum()
    assert cap.path
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in FORBIDDEN)
print("LOADED", loaded)
"""


def test_featurize_in_fresh_interpreter_loads_no_jax():
    """One featurize (over the staging ring, with async readback) and one
    text-generation transform, an autotuned runner stream, a native
    decode, one BERT fine-tune step with input readahead, one fused
    1x1-conv call, a continuous GPT engine (paged, speculative, int8), a
    micro-batching ServingEngine, one over a ReplicaPool, a tiered bf16
    engine that parks, spills and exports, and a profiler trace in a
    fresh interpreter load no module of JAX, Flax, ml_dtypes or
    sparkdl_tpu: the copied observability, reliability, ingest and
    serving modules pull in nothing of it."""
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run(
        [sys.executable, "-c", _FEATURIZE_ONE.replace("FORBIDDEN", repr(FORBIDDEN))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def _port_files():
    files = sorted((REPO / "sparkdl_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [REPO / "chip_smoke.py"]


def test_the_scan_covers_the_package_root():
    """Modules at the package root (the HPO search and its worker) are
    scanned like the subpackages'."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"sparkdl_torch/hpo.py", "sparkdl_torch/_trial_worker.py",
            "sparkdl_torch/__init__.py", "chip_smoke.py"} <= names


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                  "import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports_in_the_port(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("module", [
    "sparkdl_torch.serving.replicas", "sparkdl_torch.serving.kv_tiers",
    "sparkdl_torch.serving.kv_codec", "sparkdl_torch.observability.profiling",
    "sparkdl_torch.reliability.breaker"])
def test_serving_core_modules_import_alone_without_jax(module):
    """Each of the pool, tier, codec, profiler and breaker modules, imported
    first in a fresh interpreter, loads no JAX and no ml_dtypes (the
    reference decodes bfloat16 through ml_dtypes; the port does not)."""
    code = (f"import sys, {module}\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


_TRANSLATE_CODE_BUILT = """
import sys
import numpy as np
import chip_smoke
from sparkdl_torch.graph.tf2torch import translate_graph
graph = chip_smoke.resnet50_tf_graph(seed=0, size=32)
x = np.random.default_rng(0).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
(f,) = translate_graph(graph, ["input_1"], ["avg_pool/Mean"], device="cpu")(x)
assert f.shape == (2, 2048) and bool(f.isfinite().all())
flow = chip_smoke.control_flow_tf_graph(width=4)
(y,) = translate_graph(flow, ["x"], ["loop:1"], device="cpu")(np.ones((2, 4), np.float32))
assert y.shape == (2, 4)
print(sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN
             or m.startswith(("tensorflow", "google.protobuf", "keras"))))
"""


def _fresh(code: str):
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_translating_a_code_built_graph_loads_no_tensorflow():
    """chip_smoke's TFGraphs (ResNet50 at 32 px, the If/While graph),
    translated and run in a fresh interpreter, load no TensorFlow, no
    protobuf, no Keras and nothing of JAX: the run half of ingestion is
    what the card's machine (which has no TF) can do."""
    assert _fresh(_TRANSLATE_CODE_BUILT.replace("FORBIDDEN", repr(FORBIDDEN))) == "[]"


def test_importing_the_graph_package_loads_no_tensorflow():
    """``import sparkdl_torch.graph`` (GraphFunction, IsolatedSession,
    TFInputGraph, TFGraph) imports TF only when an artifact is read."""
    code = ("import sys, sparkdl_torch.graph, sparkdl_torch.graph.tf2torch, "
            "sparkdl_torch.graph.reader, sparkdl_torch.graph.pieces, "
            "sparkdl_torch.transformers.tf_image\n"
            "print(sorted(m for m in sys.modules if m.startswith(('tensorflow', "
            f"'google.protobuf')) or m.split('.')[0] in {FORBIDDEN!r}))")
    assert _fresh(code) == "[]"
