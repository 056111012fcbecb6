"""Fixture: env-pin POSITIVE — direct reads of pin-managed and
unlisted SPARKDL_TORCH_* variables."""

import os

_CHUNK = os.environ.get("SPARKDL_TORCH_PREFILL_CHUNK")  # VIOLATION: pin-managed

_NEW_KNOB = "SPARKDL_TORCH_MADE_UP_KNOB"


def read_knob():
    return os.getenv(_NEW_KNOB)  # VIOLATION: not on the allowlist


def read_sp():
    return os.environ["SPARKDL_TORCH_SP"]  # VIOLATION: pin-managed
