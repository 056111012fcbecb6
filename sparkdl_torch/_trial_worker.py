"""Subprocess entry for process-isolated HPO trials (``hpo.fmin``
``trial_runner='processes'``): unpickle (objective, params), evaluate,
write the result dict back. A fresh interpreter per trial gives each one
its own CUDA context on the card ``CUDA_VISIBLE_DEVICES`` pins it to.

    python -m sparkdl_torch._trial_worker PAYLOAD RESULT
"""

from __future__ import annotations

import sys


def main(payload_path: str, result_path: str) -> int:
    from sparkdl_torch.hpo import _pickler

    pickler = _pickler()
    with open(payload_path, "rb") as f:
        payload = pickler.load(f)
    objective, params = payload["objective"], payload["params"]
    try:
        out = objective(params)
        loss = out["loss"] if isinstance(out, dict) else float(out)
        extra = out if isinstance(out, dict) else {}
        result = {"loss": float(loss), "status": "ok",
                  **{k: v for k, v in extra.items()
                     if k not in ("loss", "status")}}
    except Exception as e:  # the parent records the failure, sweep survives
        result = {"loss": None, "status": "fail", "error": repr(e)}
    with open(result_path, "wb") as f:
        pickler.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
