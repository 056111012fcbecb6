"""Gated TensorFlow import for the ingestion layer.

TF is ONLY used at ingestion time (load/freeze/read an artifact, on the
host); a read graph runs as torch ops with no TF. Everything else in the
package must work without TF installed (the card's machine has none), so
every TF touch goes through :func:`require_tf`.
"""

from __future__ import annotations

import os


def require_tf():
    """Import tensorflow (CPU-pinned, quiet) or raise a clear error."""
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
    try:
        import tensorflow as tf
    except Exception as e:  # pragma: no cover - env without TF
        raise ImportError(
            "TensorFlow is required only for ingesting TF artifacts "
            "(TFInputGraph / GraphFunction / IsolatedSession). Install "
            "tensorflow-cpu on the host that reads the graph, or build a "
            "TFGraph in code (sparkdl_torch.graph.tfgraph), which does not "
            "need it."
        ) from e
    try:
        # Ingestion must never grab an accelerator TF might see.
        tf.config.set_visible_devices([], "GPU")
    except Exception:
        pass
    return tf
