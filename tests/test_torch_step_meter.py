"""The port's meters and pre-flight probe (sparkdl_torch/observability
metrics.py and health.py) against the JAX package's, from the reference's
tests/observability/test_observability.py StepMeter and health cases.

- The same recorded step times, examples and infeed waits through both
  StepMeters give the same summary (the same Python arithmetic: exact).
- ``compiled_flops`` of the tiny BERT step (forward + backward) equals
  the analytic GEMM + attention count exactly, on the CPU (the plain
  route) and on meta tensors. XLA's cost analysis of the JAX step counts
  elementwise work too: the port's count (7,235,072) is 0.858x of it
  (8,429,406) on this step, asserted within 0.8x..0.9x.
- ``device_peak_flops`` is None on the CPU and reads the H100 table by
  the card's name.
- ``check_health``/``preflight`` pass on one process and on two ranks.
"""

import numpy as np
import torch

from sparkdl_torch import TorchRunner
from sparkdl_torch.observability import metrics as tm
from sparkdl_torch.observability.health import (
    HealthReport,
    check_health,
    preflight,
    preflight_env_opts,
)
from sparkdl_tpu.observability import metrics as jm

# tiny BERT: hidden, MLP, length, batch, heads, head dim, classes
H, I, L, B, NH, HD, C = 32, 64, 16, 4, 2, 16, 2


def _record(meter, times, examples, infeed):
    for t, e, w in zip(times, examples, infeed):
        meter.record(t, examples=e)
        meter.note_infeed_wait(w)


def test_same_records_give_the_same_summary():
    rng = np.random.default_rng(0)
    times = list(rng.uniform(0.01, 0.05, 30))
    examples = [32] * 30
    infeed = list(rng.uniform(0, 0.002, 30))
    for kw in (dict(flops_per_step=2.0e12), dict(flops_per_example=6.0e10)):
        got = tm.StepMeter(n_chips=2, peak_flops_per_chip=67e12, window=20,
                           warmup_steps=2, **kw)
        want = jm.StepMeter(n_chips=2, peak_flops_per_chip=67e12, window=20,
                            warmup_steps=2, **kw)
        _record(got, times, examples, infeed)
        _record(want, times, examples, infeed)
        assert got.summary() == want.summary()
        assert got.step_time_percentiles() == want.step_time_percentiles()
        assert got.mfu() is not None and 0 < got.mfu() < 1
    empty = tm.StepMeter(n_chips=1, peak_flops_per_chip=None)
    assert empty.summary()["mfu"] is None and empty.infeed_starvation_pct() is None


def test_aggregate_across_hosts_matches_the_reference_on_one_process():
    metrics = {"a": 1.5, "b": None, "c": 3, "d": float("nan")}
    assert tm.aggregate_across_hosts(metrics) == jm.aggregate_across_hosts(metrics)


def _tiny_bert_step():
    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification

    torch.manual_seed(0)
    model = BertForSequenceClassification(
        BertConfig.tiny(attn_impl="flash"), num_labels=C, device="cpu")
    batch = {"input_ids": torch.randint(0, 100, (B, L)),
             "attention_mask": torch.ones(B, L, dtype=torch.long),
             "labels": torch.zeros(B, dtype=torch.long)}
    return model, batch


def _fwd_bwd(model, batch):
    logits = model(batch["input_ids"], batch["attention_mask"])
    torch.nn.functional.cross_entropy(logits, batch["labels"]).backward()


def _analytic():
    """Forward 2MKN and backward 4MKN for every linear layer, 4 and 10
    B·H·Lq·Lk·D for attention's forward and backward products."""
    per_layer = 6 * (4 * H * H + 2 * H * I) * B * L + 14 * B * NH * L * L * HD
    return 2 * per_layer + 6 * B * (H * H + H * C)


def test_compiled_flops_is_the_analytic_count_on_both_routes():
    model, batch = _tiny_bert_step()
    assert tm.compiled_flops(_fwd_bwd, model, batch) == _analytic()
    meta = model.to("meta")
    assert tm.compiled_flops(
        _fwd_bwd, meta, {k: v.to("meta") for k, v in batch.items()}) == _analytic()
    assert tm.compiled_flops(lambda: None) is None


def test_compiled_flops_against_xla_cost_analysis():
    import flax
    import jax
    import jax.numpy as jnp
    import optax

    from sparkdl_tpu.models.bert import BertConfig, BertForSequenceClassification

    model = BertForSequenceClassification(BertConfig.tiny(), num_labels=C)
    ids = jnp.zeros((B, L), jnp.int32)
    mask = jnp.ones((B, L), jnp.int32)
    params = flax.core.meta.unbox(model.init(jax.random.PRNGKey(0), ids, mask))

    def loss_and_grad(p):
        def loss(p):
            logits = model.apply(p, ids, mask)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.zeros((B,), jnp.int32)).mean()
        return jax.value_and_grad(loss)(p)

    xla = jm.compiled_flops(loss_and_grad, params)
    assert xla is not None
    ratio = _analytic() / xla
    assert 0.8 <= ratio <= 0.9, ratio


def test_kernel_flops_are_noted_only_inside_a_tally():
    from sparkdl_torch.ops._dispatch import flop_tally, note_flops

    note_flops(5.0)  # no tally open: dropped
    with flop_tally() as outer:
        note_flops(2.0)
        with flop_tally() as inner:
            note_flops(3.0)
    assert outer == [2.0] and inner == [3.0]


def test_device_peak_flops(monkeypatch):
    assert tm.device_peak_flops() is None
    assert tm.device_peak_flops(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cuda = torch.device("cuda", 0)
    assert tm.device_peak_flops(cuda) == 989.4e12
    assert tm.device_peak_flops(cuda, dtype="float32") == 67e12
    assert tm.device_peak_flops(cuda, dtype="tf32") == 494.7e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Some GPU")
    assert tm.device_peak_flops(cuda) is None


def test_check_health_and_preflight_on_one_process(capsys, monkeypatch):
    report = check_health()
    assert isinstance(report, HealthReport)
    assert report.ok and report.collective_ok and report.process_count == 1
    assert report.platform == "cpu" and report.error is None
    assert "OK" in report.summary()
    assert preflight(skip=True) is None
    assert preflight().ok
    assert "[health] OK" in capsys.readouterr().err
    assert check_health(expect_local_devices=3).ok is False
    monkeypatch.setenv("SPARKDL_TORCH_SKIP_HEALTH_CHECK", "1")
    monkeypatch.setenv("SPARKDL_TORCH_PROFILER_PORT", "9012")
    assert preflight_env_opts() == {"skip": True, "profiler_port": 9012}


def test_check_health_and_preflight_on_two_ranks():
    import torch_dist_jobs as jobs

    out = TorchRunner(np=-2, local_platform="cpu", timeout_s=120,
                      driver_log_verbosity="none").run(jobs.health_job)
    assert out == {"ok": True, "collective_ok": True, "count": 2,
                   "platform": "cpu"}
