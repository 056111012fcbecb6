"""The port's profiler hookup on the CPU: host stack sampling
(``profile_block``, collapsed output, the ``SPARKDL_TORCH_PROFILE`` hook)
as the reference's tests/observability/test_profiling.py drives it, the
collapsed file byte-identical to the reference's for the same samples,
``trace`` writing a Chrome trace that holds an ``annotate``d range, and
the live trace server answering on localhost.
"""

import contextlib
import http.client
import json
import threading
import time

import pytest
import torch

from sparkdl_torch.observability.profiling import (
    StackProfile,
    annotate,
    maybe_profile,
    profile_block,
    start_trace_server,
    trace,
)


def _burn(stop):
    while not stop.is_set():
        sum(i * i for i in range(200))


def test_samples_running_threads(tmp_path):
    stop = threading.Event()
    t = threading.Thread(target=_burn, args=(stop,), name="burner", daemon=True)
    t.start()
    try:
        path = tmp_path / "out.folded"
        with profile_block(path, interval_s=0.002) as prof:
            time.sleep(0.15)
    finally:
        stop.set()
        t.join()
    assert prof.n_samples >= 5
    lines = path.read_text().splitlines()
    assert lines
    for line in lines:
        stack, count = line.rsplit(" ", 1)
        assert int(count) >= 1 and ";" in stack
    burner = [ln for ln in lines if ln.startswith("burner;")]
    assert any("test_torch_profiling.py:_burn" in ln for ln in burner)


def test_sampler_excludes_itself():
    with profile_block(None, interval_s=0.002) as prof:
        time.sleep(0.05)
    assert prof.n_samples >= 1
    assert not any("sparkdl-stack-sampler" in s for s in prof.samples)


def test_manual_sampling():
    prof = StackProfile()
    prof.sample_once()
    prof.sample_once()
    assert prof.n_samples == 2
    assert any("test_torch_profiling.py:test_manual_sampling" in s
               for s in prof.samples)
    with pytest.raises(ValueError, match="interval_s"):
        StackProfile(interval_s=0.0)


def test_collapsed_file_matches_the_reference(tmp_path):
    from sparkdl_tpu.observability.profiling import StackProfile as JaxProfile

    for cls, name in ((StackProfile, "t"), (JaxProfile, "j")):
        prof = cls()
        prof.samples.update({"main;a.py:f;b.py:g": 3, "worker;c.py:h": 1,
                             "main;a.py:f": 2})
        assert prof.write_collapsed(tmp_path / f"{name}.folded") == 3
    assert ((tmp_path / "t.folded").read_bytes()
            == (tmp_path / "j.folded").read_bytes())


@pytest.mark.parametrize("value", [None, "0"])
def test_disabled_is_noop(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("SPARKDL_TORCH_PROFILE", raising=False)
    else:
        monkeypatch.setenv("SPARKDL_TORCH_PROFILE", value)
    monkeypatch.setenv("SPARKDL_TPU_PROFILE", "1")  # the reference's: ignored
    ctx = maybe_profile("unit")
    assert isinstance(ctx, contextlib.nullcontext)
    with ctx as prof:
        assert prof is None


def test_bad_hz_fails_loud(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKDL_TORCH_PROFILE", "1")
    monkeypatch.setenv("SPARKDL_TORCH_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("SPARKDL_TORCH_PROFILE_HZ", "0")
    with pytest.raises(ValueError, match="SPARKDL_TORCH_PROFILE_HZ"):
        maybe_profile("unit")


def test_enabled_writes_folded_file(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SPARKDL_TORCH_PROFILE", "1")
    monkeypatch.setenv("SPARKDL_TORCH_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("SPARKDL_TORCH_PROFILE_HZ", "500")
    with maybe_profile("unit") as prof:
        time.sleep(0.05)
    assert prof is not None and prof.n_samples >= 1
    files = list(tmp_path.glob("sparkdl-profile-unit-*.folded"))
    assert len(files) == 1 and files[0].read_text()
    assert str(files[0]) in capsys.readouterr().err  # stdout stays clean


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "logs") as cap:
        with annotate("sparkdl.unit_range"):
            (x @ x).sum()
    assert cap.path is not None and cap.path.startswith(str(tmp_path / "logs"))
    names = {e.get("name") for e in _events(cap.path)}
    assert "sparkdl.unit_range" in names
    assert any(n and n.startswith("aten::") for n in names)
    table = cap.profiler.key_averages()
    assert any(e.key == "sparkdl.unit_range" for e in table)
    with trace(tmp_path / "logs") as second:
        pass
    assert second.path != cap.path  # one file per capture


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_trace_server_answers_on_localhost(tmp_path):
    server = start_trace_server(0, logdir=tmp_path)
    stop = threading.Event()

    def work():
        x = torch.randn(32, 32)
        while not stop.is_set():
            with annotate("sparkdl.server_work"):
                x @ x

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    try:
        assert server.port > 0 and server.server_address[0] == "127.0.0.1"
        status, body = _get(server.port, "/trace?seconds=0.2")
        assert status == 200
        reply = json.loads(body)
        assert reply["seconds"] == 0.2
        assert reply["path"].startswith(str(tmp_path))
        assert isinstance(_events(reply["path"]), list)
        assert _get(server.port, "/trace?seconds=61")[0] == 400  # over the cap
        assert _get(server.port, "/trace?seconds=x")[0] == 400
        assert _get(server.port, "/nope")[0] == 404
    finally:
        stop.set()
        worker.join()
        server.close()


def test_default_trace_server_logdir_is_temporary():
    import os
    import shutil

    server = start_trace_server(0)
    try:
        assert server.logdir and os.path.isdir(server.logdir)
    finally:
        server.close()
        shutil.rmtree(server.logdir)
