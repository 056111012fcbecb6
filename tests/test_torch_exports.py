"""The port's public surface against the reference's: every name that a
``sparkdl_tpu`` package ``__init__`` exports is exported by the matching
``sparkdl_torch`` one, apart from a listed set, each with its reason;
``import sparkdl_torch`` (and every subpackage, and each lazy top-level
name) works where pyarrow, Keras and TensorFlow are not installed; and
``ops.resize_images`` matches the reference's resize."""

import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

#: Reference names the port does not export, and why.
NOT_EXPORTED = {
    ("sparkdl_tpu", "TPURunner"): "the port's runner is TorchRunner "
                                  "(HorovodRunner is exported by both)",
    ("sparkdl_tpu.runner", "TPURunner"): "as above",
    ("sparkdl_tpu.models", "build_flax_model"): "no Flax: the port builds "
                                                "torch modules (build_torch_model)",
    ("sparkdl_tpu.train", "TrainState"): "torch optimizers keep their own "
                                         "state; a checkpoint's state is "
                                         "train.finetune.train_state(...)",
    # a package attribute cannot be both a submodule and a function; the
    # port keeps the submodules, which its tests and tools import as such
    ("sparkdl_tpu.ops", "flash_attention"): "the module; the wrapper is "
                                            "ops.flash_attention.flash_attention",
    ("sparkdl_tpu.models", "registry"): "the zoo's module; its entries are "
                                        "get_entry and SUPPORTED_MODELS",
}

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_packages():
    out = []
    base = os.path.join(_ROOT, "sparkdl_tpu")
    for here, _, files in os.walk(base):
        if "__init__.py" in files and "__pycache__" not in here:
            rel = os.path.relpath(here, _ROOT)
            out.append(rel.replace(os.sep, "."))
    return sorted(out)


@pytest.mark.parametrize("package", _reference_packages())
def test_reference_exports_are_exported(package):
    ref = importlib.import_module(package)
    port = importlib.import_module(
        package.replace("sparkdl_tpu", "sparkdl_torch", 1))
    missing = sorted(
        n for n in ref.__all__
        if (package, n) not in NOT_EXPORTED
        and (n not in port.__all__ or getattr(port, n, None) is None))
    assert not missing, f"{port.__name__} lacks {missing}"
    # every listed exception is still a difference
    for (pkg, name), why in NOT_EXPORTED.items():
        if pkg == package:
            assert name not in port.__all__, why


_BLOCKED = ("pyarrow", "keras", "tensorflow", "jax", "flax", "sparkdl_tpu")

_IMPORT_SCRIPT = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None  # `import name` now raises ImportError
import sparkdl_torch
for pkg in ("models", "ops", "runtime", "observability", "dataframe",
            "image", "native", "serving", "transformers", "train",
            "runner", "partition", "parallel", "graph", "estimators",
            "udf", "checkpoint", "param", "ingest", "reliability",
            "autoscale", "fabric", "disagg"):
    __import__("sparkdl_torch." + pkg)
names = [n for n in sparkdl_torch.__all__ if n != "__version__"]
for n in names:
    getattr(sparkdl_torch, n)
print(len(names))
"""


def test_import_needs_no_pyarrow_keras_or_tensorflow():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import sparkdl_torch

    assert int(out.stdout.split()[-1]) == len(sparkdl_torch.__all__) - 1


def test_top_level_names():
    import sparkdl_torch
    from sparkdl_torch.image import imageIO
    from sparkdl_torch.serving import ContinuousGPTEngine, ServingEngine

    assert sparkdl_torch.imageIO is imageIO
    assert sparkdl_torch.ContinuousGPTEngine is ContinuousGPTEngine
    assert sparkdl_torch.ServingEngine is ServingEngine


#: float32 bilinear weights and sums computed in different orders
RESIZE_TOL = 1e-5


@pytest.mark.parametrize("shape, size", [
    ((2, 7, 9, 3), (14, 20)),      # upsample, batch dim
    ((2, 3, 13, 11, 3), (5, 6)),   # downsample, two batch dims
    ((8, 8, 1), (3, 17)),          # no batch dim, mixed
])
def test_resize_images_matches_the_reference(shape, size):
    from sparkdl_torch.ops import resize_images
    from sparkdl_tpu.ops import resize_images as jax_resize

    x = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), *size))
    got = resize_images(torch.from_numpy(x), *size).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < RESIZE_TOL, err
    with pytest.raises(ValueError, match="bilinear"):
        resize_images(torch.from_numpy(x), *size, method="bicubic")
