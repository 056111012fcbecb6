"""HTTP transport: one engine behind HostServer, the router on
HttpHostHandle — the contracts must be indistinguishable from the
in-process handle (same typed errors, same digest grid, same drain
semantics), because every fabric behavior is transport-agnostic by
construction.
"""

import numpy as np
import pytest


from sparkdl_torch.fabric import (
    HostDrainingError,
    HostServer,
    HostUnavailableError,
    HttpHostHandle,
    InProcessHost,
    Router,
)
import torch

from sparkdl_torch.models.gpt import generate
from sparkdl_torch.serving import ContinuousGPTEngine

MAX_LEN = 32
BS = 4


@pytest.fixture(scope="module")
def bundle():
    from torch_parity import gpt_pair

    _, _, module = gpt_pair(0)
    return module.config, module


@pytest.fixture()
def served(bundle):
    cfg, module = bundle
    eng = ContinuousGPTEngine(
        cfg, module, n_slots=2, max_len=MAX_LEN, kv_block_size=BS,
        idle_wait_s=0.001, host_id="http-host")
    with HostServer(eng) as server:
        yield eng, server
    eng.close(drain=False)


def _oracle(module, prompt, max_new):
    # the port's generate: held to the JAX package's in test_torch_gpt
    out = generate(module, torch.as_tensor([prompt]), max_new)
    return out[0, len(prompt):].numpy()


def test_http_submit_roundtrip_oracle(bundle, served):
    cfg, module = bundle
    eng, server = served
    handle = HttpHostHandle(server.url)
    assert handle.host_id == "http-host"  # discovered from snapshot
    prompt = [5, 1, 4, 4, 2]
    fut = handle.submit({"prompt": prompt, "max_new_tokens": 3})
    np.testing.assert_array_equal(
        fut.result(30), _oracle(module, prompt, 3))
    handle.close()


def test_http_snapshot_capacity_digest_healthz(served):
    eng, server = served
    handle = HttpHostHandle(server.url, host_id="http-host")
    snap = handle.snapshot()
    assert snap["host_id"] == "http-host"
    cap = handle.capacity()
    assert cap["kv_blocks_total"] > 0 and cap["n_slots"] == 2
    # digest round-trips the wire on the same grid the engine publishes
    handle.submit({"prompt": [9, 2, 7, 7, 3, 1, 8, 8, 4],
                   "max_new_tokens": 2}).result(30)
    dig = handle.prefix_digest()
    local = eng.prefix_digest()
    assert dig["block_size"] == BS
    assert set(dig["hashes"]) == set(local["hashes"])
    health = handle.health()
    assert health["status"] in ("ok", "degraded")
    assert health["draining"] is False
    handle.close()


def test_http_typed_errors_cross_the_wire(served):
    eng, server = served
    handle = HttpHostHandle(server.url, host_id="http-host")
    # ValueError (bad request) comes back as ValueError, not a blind 500
    fut = handle.submit({"prompt": list(range(40)),
                         "max_new_tokens": 60})
    with pytest.raises(ValueError, match="max_len"):
        fut.result(30)
    handle.close()


def test_http_unmapped_remote_error_is_request_level(served):
    """Regression: an unmapped remote exception (a KeyError from
    a malformed payload, a model RuntimeError) must cross the wire as a
    REQUEST-level error — promoting it to HostUnavailableError would
    let one poison request quarantine every healthy host it touches."""
    from sparkdl_torch.fabric import HostUnavailableError

    _, server = served
    handle = HttpHostHandle(server.url, host_id="http-host")
    # a body missing max_new_tokens raises KeyError INSIDE the server
    # handler — an exception outside the typed map, answered as 500
    with pytest.raises(RuntimeError) as exc_info:
        handle._request("/fabric/submit", {"prompt": [1, 2]})
    assert not isinstance(exc_info.value, HostUnavailableError), \
        exc_info.value
    assert "KeyError" in str(exc_info.value)
    handle.close()


def test_http_unreachable_is_host_level(served):
    _, server = served
    handle = HttpHostHandle(server.url, host_id="http-host")
    server.close()
    fut = handle.submit({"prompt": [1, 2], "max_new_tokens": 1})
    with pytest.raises((HostUnavailableError, ConnectionError)):
        fut.result(30)
    assert handle.health()["status"] == "unhealthy"
    handle.close()


def test_http_drain_reroutes_to_survivor(bundle, wait_until):
    """POST /fabric/drain: the remote host stops admission and fails its
    unstarted requests with HostDrainingError — the router's failover
    re-places them on the surviving host, so callers see results, not
    errors, and nothing is double-counted."""
    cfg, module = bundle
    remote_eng = ContinuousGPTEngine(
        cfg, module, n_slots=2, max_len=MAX_LEN, kv_block_size=BS,
        idle_wait_s=0.001, host_id="draining-remote", auto_start=False)
    local_eng = ContinuousGPTEngine(
        cfg, module, n_slots=2, max_len=MAX_LEN, kv_block_size=BS,
        idle_wait_s=0.001, host_id="survivor-local")
    with HostServer(remote_eng) as server:
        remote = HttpHostHandle(server.url, host_id="draining-remote")
        survivor = InProcessHost(local_eng)
        with Router([remote, survivor], auto_refresh=False) as router:
            # pin placement onto the remote (engine not running: its
            # queue holds the requests unstarted)
            with router._lock:
                router._hosts["survivor-local"].outstanding += 10
            cases = [([4, 2, 7], 2), ([9, 1, 3, 3], 3)]
            futs = [router.submit(
                {"prompt": p, "max_new_tokens": n}) for p, n in cases]
            # the POSTs land from client worker threads: wait until
            # both sit unstarted in the remote's queue before draining
            wait_until(lambda: remote_eng.queue.depth == 2,
                       timeout_s=10.0)
            with router._lock:
                router._hosts["survivor-local"].outstanding -= 10
            moved = router.drain_host("draining-remote")
            assert moved == 0  # transport drains fail-and-refail, not transfer
            for (p, n), fut in zip(cases, futs):
                np.testing.assert_array_equal(
                    fut.result(30), _oracle(module, p, n))
            # the drained remote refuses new submits, typed
            fut = remote.submit({"prompt": [1, 2], "max_new_tokens": 1})
            with pytest.raises(HostDrainingError):
                fut.result(30)
        remote.close()
    remote_eng.close(drain=False)
    local_eng.close(drain=False)
