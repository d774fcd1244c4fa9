"""The port's host metrics registry (istio_tpu_torch/utils/metrics.py)
against the JAX package's (istio_tpu/utils/metrics.py).

The same operations on a registry of each package must render the same
Prometheus exposition text, byte for byte: the registry-level cases of
tests/test_metrics_exposition.py (an observed histogram with and without
labels, an unobserved histogram's zero series, counters and gauges with
help text) and a mixed script of every metric kind; counts, sums and
values read the same numbers. The canary's nine
`mixer_canary_*` families expose the same zero series on a fresh
registry of each package.
"""
import pytest

from istio_tpu.canary import gate as ref_gate
from istio_tpu.utils import metrics as ref_metrics

from istio_tpu_torch.canary import gate as pt_gate
from istio_tpu_torch.utils import metrics as pt_metrics


def _observed_histogram(m):
    reg = m.Registry()
    h = reg.histogram("lat_seconds", "latency", buckets=(0.001, 0.01, 1.0))
    for v in (0.0005, 0.005, 0.5, 2.0):
        h.observe(v)
        h.observe(v, stage="device")
    return reg, (h.count(), h.count(stage="device"), h.sum(),
                 h.sum(stage="device"))


def _unobserved_histogram(m):
    reg = m.Registry()
    h = reg.histogram("never_seen_seconds", "nothing yet",
                      buckets=(0.1, 1.0))
    return reg, (h.count(), h.sum())


def _counter_gauge(m):
    reg = m.Registry()
    c = reg.counter("reqs_total", "requests")
    g = reg.gauge("depth", "queue depth")
    c.inc(3, front="grpc")
    g.set(7.5)
    return reg, (c.value(front="grpc"), c.value(), g.value())


def _mixed(m):
    """Every kind, several label sets each, help-less families, default
    buckets, values on bucket edges and past the last one."""
    reg = m.Registry()
    c = reg.counter("a_total")
    c.inc(0.0)
    c.inc(2, kind="x")
    c.inc(1.5, kind="y", verdict="veto")
    g = reg.gauge("b", "gauge help")
    g.set(-1.25, shard="0")
    g.set(3)
    h = reg.histogram("c_seconds", "")
    for v in (1e-6, 2.5e-6, 0.0, 5.0, 7.0, 0.3):
        h.observe(v)
        h.observe(v * 2, lane="b")
    h2 = reg.histogram("d_seconds", "edges", buckets=(1.0, 0.5, 2.0))
    for v in (0.5, 1.0, 2.0, 2.0000001):
        h2.observe(v)
    return reg, (c.value(kind="x"), g.value(shard="0"), h.count(lane="b"),
                 h.sum(lane="b"), h2.count(), h2.sum())


CASES = {"observed_histogram": _observed_histogram,
         "unobserved_histogram": _unobserved_histogram,
         "counter_gauge": _counter_gauge, "mixed": _mixed}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exposition_text_equals_the_reference(case):
    ref_reg, ref_reads = CASES[case](ref_metrics)
    pt_reg, pt_reads = CASES[case](pt_metrics)
    assert pt_reg.expose_text() == ref_reg.expose_text()
    assert pt_reads == ref_reads


def test_exposition_contract_of_the_reference_cases():
    """The reference test's own expectations, on the port."""
    reg, (n, n_dev, total, *_rest) = _observed_histogram(pt_metrics)
    text = reg.expose_text()
    assert n == 4 and n_dev == 4 and abs(total - 2.5055) < 1e-9
    assert 'lat_seconds_bucket{le="+Inf",stage="device"} 4' in text
    reg, _ = _unobserved_histogram(pt_metrics)
    text = reg.expose_text()
    assert "never_seen_seconds_count 0" in text
    assert 'never_seen_seconds_bucket{le="+Inf"} 0' in text
    reg, _ = _counter_gauge(pt_metrics)
    text = reg.expose_text()
    assert "# HELP reqs_total requests" in text
    assert "# TYPE reqs_total counter" in text
    assert 'reqs_total{front="grpc"} 3.0' in text
    assert "depth 7.5" in text


def test_canary_families_zero_series_equal_the_reference():
    """The nine mixer_canary_* families, registered on a fresh registry
    of each package, expose the same zero-touched series; the port's
    module-level FAMILIES live on its default registry."""
    ref_reg, pt_reg = ref_metrics.Registry(), pt_metrics.Registry()
    ref_fams = ref_gate.register_families(ref_reg)
    pt_fams = pt_gate.register_families(pt_reg)
    assert sorted(pt_fams) == sorted(ref_fams)
    assert pt_reg.expose_text() == ref_reg.expose_text()
    text = pt_metrics.default_registry.expose_text()
    for fam in ("mixer_canary_replays_total",
                "mixer_canary_replay_rows_total",
                "mixer_canary_divergences_total",
                "mixer_canary_verdicts_total",
                "mixer_canary_errors_total",
                "mixer_canary_last_divergence_rate",
                "mixer_canary_recorder_entries",
                "mixer_canary_replay_seconds",
                "mixer_canary_publish_delay_seconds"):
        assert f"# TYPE {fam} " in text, fam
