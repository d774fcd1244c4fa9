"""Self-metrics: counters / gauges / histograms with Prometheus text
exposition.

Port of istio_tpu/utils/metrics.py's registry and text exposition
(standard library only; it never imports prometheus_client, which the
card's machine lacks). Role of the reference's Prometheus self-monitoring
(mixer/pkg/runtime/monitor.go:34-88, pilot discovery.go:53-113).
Host-side only. The config canary registers its mixer_canary_* families
on `default_registry` (canary/gate.py), the sharded serving plane its
mixer_shard_stage_seconds and mixer_replica_* families
(runtime/monitor.py); the /metrics scrape that would
serve `expose_text()` waits for the introspect plane, and with it the
reference's quantile readers and SlidingWindow (runtime/monitor.py keeps
its own live window).
"""
from __future__ import annotations

import bisect
import threading
from typing import Iterable

_DEFAULT_BUCKETS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


def _label_key(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted((labels or {}).items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> Iterable[str]:
        if self.help:
            yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        with self._lock:
            snapshot = sorted(self._values.items())
        for key, v in snapshot:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> Iterable[str]:
        if self.help:
            yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        with self._lock:
            snapshot = sorted(self._values.items())
        for key, v in snapshot:
            yield f"{self.name}{_fmt_labels(key)} {v}"


class Histogram:
    def __init__(self, name: str, help_: str = "",
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self._buckets = tuple(sorted(buckets))
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = {}
        self._n: dict[tuple, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        idx = bisect.bisect_left(self._buckets, value)
        with self._lock:
            if key not in self._counts:
                self._counts[key] = [0] * (len(self._buckets) + 1)
                self._sum[key] = 0.0
                self._n[key] = 0
            self._counts[key][idx] += 1
            self._sum[key] += value
            self._n[key] += 1

    @property
    def buckets(self) -> tuple[float, ...]:
        return self._buckets

    def count(self, **labels: str) -> int:
        return self._n.get(_label_key(labels), 0)

    def sum(self, **labels: str) -> float:
        return self._sum.get(_label_key(labels), 0.0)

    def state(self, **labels: str) -> tuple[list[int], float, int]:
        """(per-bucket counts copy, sum, n) for one label set — the
        subtraction token for windowed readings: two states taken
        around a phase delta to that phase's own histogram (histograms
        are process-lifetime cumulative by design)."""
        key = _label_key(labels)
        with self._lock:
            counts = list(self._counts.get(key, ()))
            return (counts, self._sum.get(key, 0.0),
                    self._n.get(key, 0))

    def expose(self) -> Iterable[str]:
        if self.help:
            yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        with self._lock:
            items = sorted((k, list(v), self._sum[k], self._n[k])
                           for k, v in self._counts.items())
        if not items:
            # exposition conformance: a histogram with no observations
            # must still emit its full zero series (_bucket ladder with
            # le="+Inf", _sum, _count) — scrapers treat a bare # TYPE
            # line with no samples as a malformed family
            items = [((), [0] * (len(self._buckets) + 1), 0.0, 0)]
        for key, counts, total, n in items:
            cum = 0
            for i, c in enumerate(counts[:-1]):
                cum += c
                lk = dict(key)
                lk["le"] = repr(self._buckets[i])
                yield f"{self.name}_bucket{_fmt_labels(_label_key(lk))} {cum}"
            lk = dict(key)
            lk["le"] = "+Inf"
            yield f"{self.name}_bucket{_fmt_labels(_label_key(lk))} {n}"
            yield f"{self.name}_sum{_fmt_labels(key)} {total}"
            yield f"{self.name}_count{_fmt_labels(key)} {n}"


class Registry:
    """Collects metrics for a /metrics endpoint (reference: mixer
    monitoring server on :9093, mixer/pkg/server/monitoring.go)."""

    def __init__(self) -> None:
        self._metrics: list[Counter | Gauge | Histogram] = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        m = Counter(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name: str, help_: str = "") -> Gauge:
        m = Gauge(name, help_)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple[float, ...] = _DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(name, help_, buckets)
        with self._lock:
            self._metrics.append(m)
        return m

    def expose_text(self) -> str:
        lines: list[str] = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"


default_registry = Registry()
