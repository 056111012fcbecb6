"""Reading a trace: busy time, the device's top operations, idle gaps by
what the host was doing."""

from benchmark import trace


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    events = [("k1", 0.0, 1.0), ("Memcpy HtoD", 1.0, 1.5), ("k2", 3.0, 4.0)]
    busy = trace.busy_intervals(events, 0.0, 5.0)
    assert busy == [(0.0, 1.5), (3.0, 4.0)]
    spans = {0: [("partition.extract", 1.5, 2.5, {}), ("bench.partition", 0.0, 5.0, {}),
                 ("batch.pack", 2.6, 2.9, {})],
             1: [("fetch.wait", 4.2, 4.8, {})]}
    gaps = dict(map(tuple, trace.idle_gaps(busy, spans, 0.0, 5.0)))
    assert gaps["partition.extract"] == 1.5     # 1.5..3.0, midpoint in extract
    assert gaps["bench.partition+fetch.wait"] == 1.0  # 4.0..5.0, midpoint 4.5


def test_device_ops_sum_by_name_inside_the_window():
    events = [("a", 0.0, 1.0), ("b", 0.5, 3.0), ("a", 2.0, 2.5)]
    assert trace.device_ops(events, 0.0, 2.0) == [["b", 1.5], ["a", 1.0]]
    assert not trace.is_kernel("Memset (Device)") and trace.is_kernel("stem_fused_kernel")
