"""sparkdl_torch stands alone: it imports nothing of JAX, Flax or
sparkdl_tpu (importing sparkdl_tpu pulls in JAX and sets KERAS_BACKEND),
and neither does chip_smoke.py."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparkdl_tpu")

_FEATURIZE_ONE = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
from sparkdl_torch.image import imageArrayToStructBGR
img = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
df = LocalDataFrame.from_rows([{"image": imageArrayToStructBGR(img)}])
out = DeepImageFeaturizer(inputCol="image", outputCol="f", modelName="InceptionV3",
                          weights="random", batchSize=1, device="cpu").transform(df)
f = out.first()["f"]
assert f.shape == (2048,) and np.isfinite(f).all()
from sparkdl_torch import DeepTextGenerator
from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, init_gpt_
cfg = GPTConfig.tiny(attn_impl="flash", flash_decode=True)
sd = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
df = LocalDataFrame.from_rows([{"p": [5, 3, 9]}, {"p": [1]}, {"p": []}])
rows = DeepTextGenerator(inputCol="p", outputCol="g", model=(cfg, sd), maxNewTokens=3,
                         device="cpu").transform(df).collect()
assert [len(r["g"]) for r in rows[:2]] == [3, 3] and rows[2]["g"] is None
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in FORBIDDEN)
print("LOADED", loaded)
"""


def test_featurize_in_fresh_interpreter_loads_no_jax():
    """One featurize and one text-generation transform in a fresh
    interpreter load no module of JAX, Flax or sparkdl_tpu."""
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
