"""Fixture: env-pin NEGATIVE — resolver-internal and allowlisted reads."""

import os


def resolve_pin(explicit, env_var, default, *, what):
    raw = os.environ.get(env_var)  # the resolver owns the contract
    return int(raw) if raw else default


def tracing_enabled():
    return bool(os.environ.get("SPARKDL_TORCH_TRACE"))  # allowlisted


def jax_knob():
    return os.environ.get("SPARKDL_TPU_PREFILL_CHUNK")  # not the port's


def unrelated():
    return os.environ.get("HOME")  # not a SPARKDL_TORCH_* var
