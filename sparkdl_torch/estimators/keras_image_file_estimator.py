"""KerasImageFileEstimator — transfer learning / HPO over image URIs.

The port of ``sparkdl_tpu.estimators.keras_image_file_estimator``:
``fit(df, paramMaps)`` materializes (X, y) once via the user's
``imageLoader``, then trains one model per param map. The reference
compiles the Keras model and calls ``model.fit``; the port reads the model
file into a ``KerasGraph``, trains it as torch ops
(``models/keras_graph.KerasGraphModule``) on ``device`` with
:func:`fit_keras_graph`, writes the tuned weights back into the Keras
model (``models/keras_loader.write_keras_weights``) and returns it as a
``KerasImageFileTransformer``.

Keras' semantics that the torch loop keeps:

- optimizer names map to torch optimizers with Keras' defaults
  (:data:`KERAS_OPTIMIZERS`): Adam lr 1e-3, betas (0.9, 0.999) and
  epsilon 1e-7 (torch's default is 1e-8; Keras adds epsilon after its
  bias correction, torch before, which differs by epsilon x
  (1 - sqrt(1 - beta2^t)) in the denominator), SGD lr 1e-2, and
  RMSprop lr 1e-3, rho 0.9, epsilon 1e-7 as Keras computes it
  (:class:`KerasRMSprop`: torch's RMSprop adds epsilon outside the square
  root, Keras inside, which moves a first step by tens of percent where
  gradients are ~1e-3);
- loss names map to Keras' formulas (:data:`KERAS_LOSSES`): probabilities
  are renormalized over the last axis and clipped to [1e-7, 1 - 1e-7]
  before the log, and the per-example losses are averaged over the batch;
- ``kerasFitParams`` takes ``epochs`` (1), ``shuffle`` (True: a seeded
  ``torch.Generator`` permutation each epoch; Keras' own order cannot be
  reproduced), ``batch_size`` (the ``batchSize`` Param) and ``verbose``;
  batches run in order and the last, partial one is kept;
- BatchNormalization trains on the batch mean and biased variance and
  moves its moving statistics by the layer's momentum.

Anything else (another fit key, an optimizer or loss outside the maps)
raises ``NotImplementedError`` naming ROADMAP A3.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Sequence

import numpy as np
import torch

from sparkdl_torch.param import (
    Estimator,
    HasBatchSize,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
    Param,
    SparkDLTypeConverters,
)
from sparkdl_torch.transformers.keras_image import CanLoadImage, KerasImageFileTransformer

_EPSILON = 1e-7  # keras.config.epsilon()


class KerasRMSprop(torch.optim.Optimizer):
    """Keras' RMSprop (no momentum, not centered): v = rho v + (1 - rho) g^2,
    p -= lr g / sqrt(v + epsilon)."""

    def __init__(self, params, lr: float = 1e-3, rho: float = 0.9,
                 epsilon: float = 1e-7):
        super().__init__(params, dict(lr=lr, rho=rho, epsilon=epsilon))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                v = self.state[p].setdefault("velocity", torch.zeros_like(p))
                v.mul_(group["rho"]).addcmul_(p.grad, p.grad, value=1.0 - group["rho"])
                p.sub_(group["lr"] * p.grad / torch.sqrt(v + group["epsilon"]))


KERAS_OPTIMIZERS: dict[str, Callable[[Any], torch.optim.Optimizer]] = {
    "adam": lambda ps: torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-7),
    "sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2),
    "rmsprop": lambda ps: KerasRMSprop(ps),
}


def _categorical_crossentropy(y_pred, y_true):
    p = y_pred / y_pred.sum(dim=-1, keepdim=True)
    p = p.clamp(_EPSILON, 1.0 - _EPSILON)
    return -(y_true * torch.log(p)).sum(dim=-1)


def _sparse_categorical_crossentropy(y_pred, y_true):
    p = y_pred / y_pred.sum(dim=-1, keepdim=True)
    p = p.clamp(_EPSILON, 1.0 - _EPSILON)
    labels = y_true.reshape(p.shape[:-1]).long()
    return -torch.log(p).gather(-1, labels.unsqueeze(-1)).squeeze(-1)


def _binary_crossentropy(y_pred, y_true):
    p = y_pred.clamp(_EPSILON, 1.0 - _EPSILON)
    return -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p)).mean(dim=-1)


def _mean_squared_error(y_pred, y_true):
    return ((y_pred - y_true) ** 2).mean(dim=-1)


#: Keras loss name -> per-example loss (y_pred, y_true) -> [B]
KERAS_LOSSES: dict[str, Callable] = {
    "categorical_crossentropy": _categorical_crossentropy,
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
    "mean_squared_error": _mean_squared_error,
    "mse": _mean_squared_error,
}

_FIT_KEYS = frozenset({"epochs", "shuffle", "batch_size", "verbose"})


def _lookup(table: dict, name, what: str):
    key = name.lower() if isinstance(name, str) else name
    if key not in table:
        raise NotImplementedError(
            f"{what} {name!r} is not ported to sparkdl_torch (ROADMAP A3); "
            f"supported: {sorted(table)}")
    return table[key]


def keras_loss(name: str) -> Callable:
    """The per-example loss function of the Keras loss ``name``."""
    return _lookup(KERAS_LOSSES, name, "kerasLoss")


def fit_keras_graph(module, x: np.ndarray, y: np.ndarray, optimizer: str = "adam",
                    loss: str = "categorical_crossentropy", epochs: int = 1,
                    batch_size: int = 32, shuffle: bool = True, verbose: int = 0,
                    seed: int = 0) -> dict:
    """Train the ``KerasGraphModule`` ``module`` in place on (x, y) as Keras'
    ``model.fit`` would, on the module's device. Returns Keras' history
    shape: ``{"loss": [mean loss over each epoch's examples]}``."""
    dev = next(module.parameters()).device
    opt = _lookup(KERAS_OPTIMIZERS, optimizer, "kerasOptimizer")(
        [p for p in module.parameters() if p.requires_grad])
    loss_fn = keras_loss(loss)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    yt = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    n = xt.shape[0]
    gen = torch.Generator().manual_seed(seed)
    history: dict[str, list] = {"loss": []}
    for epoch in range(int(epochs)):
        order = torch.randperm(n, generator=gen) if shuffle else torch.arange(n)
        total = torch.zeros((), device=dev)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size].to(dev)
            value = loss_fn(module(xt[idx], training=True), yt[idx]).mean()
            opt.zero_grad(set_to_none=True)
            value.backward()
            opt.step()
            total += value.detach() * idx.numel()
        history["loss"].append(float(total) / n)
        if verbose:
            print(f"Epoch {epoch + 1}/{epochs} - loss: {history['loss'][-1]:.4f}")
    return history


class KerasImageFileEstimator(
    Estimator, CanLoadImage, HasInputCol, HasOutputCol, HasLabelCol, HasBatchSize
):
    modelFile = Param(
        None, "modelFile", "path to the Keras model to start training from",
        SparkDLTypeConverters.toExistingFilePath,
    )
    kerasOptimizer = Param(
        None, "kerasOptimizer", "Keras optimizer name (e.g. 'adam')",
        SparkDLTypeConverters.toKerasOptimizer,
    )
    kerasLoss = Param(
        None, "kerasLoss", "Keras loss name (e.g. 'categorical_crossentropy')",
        SparkDLTypeConverters.toKerasLoss,
    )
    kerasFitParams = Param(
        None, "kerasFitParams",
        "dict of Keras Model.fit arguments: epochs, shuffle, batch_size, verbose",
    )
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    def __init__(self, inputCol=None, outputCol=None, labelCol=None,
                 modelFile=None, imageLoader=None, kerasOptimizer=None,
                 kerasLoss=None, kerasFitParams=None, batchSize=None, device=None):
        super().__init__()
        self._setDefault(
            kerasOptimizer="adam", kerasFitParams={"verbose": 0}, batchSize=32,
            device="cuda",
        )
        self._set(inputCol=inputCol, outputCol=outputCol, labelCol=labelCol,
                  modelFile=modelFile, imageLoader=imageLoader,
                  kerasOptimizer=kerasOptimizer, kerasLoss=kerasLoss,
                  kerasFitParams=kerasFitParams, batchSize=batchSize, device=device)

    # -- data materialization (reference: imageLoader UDF -> numpy) --------
    def _collect_xy(self, dataset) -> tuple[np.ndarray, "np.ndarray | None"]:
        input_col = self.getInputCol()
        label_col = self.getOrDefault("labelCol") if self.isDefined("labelCol") else None
        uris, labels = [], []
        rows = dataset.collect() if hasattr(dataset, "collect") else list(dataset)
        for r in rows:
            uris.append(r[input_col])
            if label_col is not None:
                labels.append(r[label_col])
        x = np.stack([self._load_one(u) for u in uris])
        y = np.asarray(labels, dtype=np.float32) if labels else None
        return x, y

    def _load_one(self, uri: str) -> np.ndarray:
        arr = np.asarray(self.loadImage(uri), dtype=np.float32)
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        return arr

    # -- fitting -----------------------------------------------------------
    def _fit(self, dataset) -> KerasImageFileTransformer:
        return self.fitMultiple(dataset, [{}])[0]

    def fitMultiple(self, dataset, paramMaps: Sequence[dict]) -> list:
        """One tuned model per param map, trained over the shared (X, y)."""
        x, y = self._collect_xy(dataset)
        if y is None:
            raise ValueError("labelCol must be set (and present) to fit")
        return [self._fit_one(pm, x, y) for pm in paramMaps]

    def _fit_one(self, param_map: dict, x: np.ndarray, y: np.ndarray):
        from sparkdl_torch.models.keras_graph import KerasGraphModule
        from sparkdl_torch.models.keras_loader import read_keras_model, write_keras_weights

        est: KerasImageFileEstimator = self.copy(param_map) if param_map else self
        fit_params: dict[str, Any] = dict(est.getOrDefault("kerasFitParams"))
        extra = sorted(set(fit_params) - _FIT_KEYS)
        if extra:
            raise NotImplementedError(
                f"kerasFitParams {extra} are not ported to sparkdl_torch "
                f"(ROADMAP A3); supported: {sorted(_FIT_KEYS)}")
        if not est.isDefined("kerasLoss"):
            raise ValueError("kerasLoss must be set to fit")
        model_file = est.getOrDefault("modelFile")
        device = est.getOrDefault("device")
        module = KerasGraphModule(read_keras_model(model_file), device=device)
        fit_keras_graph(
            module, x, y, optimizer=est.getOrDefault("kerasOptimizer"),
            loss=est.getOrDefault("kerasLoss"),
            epochs=fit_params.get("epochs", 1),
            batch_size=fit_params.get("batch_size", est.getBatchSize()),
            shuffle=fit_params.get("shuffle", True),
            verbose=fit_params.get("verbose", 0),
        )
        fd, path = tempfile.mkstemp(suffix=".keras", prefix="sparkdl_tuned_")
        os.close(fd)
        write_keras_weights(model_file, module, path)
        return KerasImageFileTransformer(
            inputCol=est.getInputCol(),
            outputCol=est.getOutputCol(),
            modelFile=path,
            imageLoader=est.getImageLoader(),
            batchSize=est.getBatchSize(),
            device=device,
        )
