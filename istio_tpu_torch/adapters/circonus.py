"""circonus — metric aggregation + httptrap submission.

Reference: mixer/adapter/circonus/circonus.go — the handler feeds a
circonus-gometrics aggregator (counters, gauges, log-linear
histograms) that a ScheduleDaemon ticker flushes to the configured
httptrap submission URL every `submission_interval` (min 1s,
circonus.go:146-150); HandleMetric dispatches on the per-metric
configured type (GAUGE stores last value, COUNTER increments,
DISTRIBUTION records a timing sample, circonus.go:159-182). Validate
cross-checks the metric config against the inferred metric types both
ways (circonus.go:124-144).

This build re-implements the aggregation + wire payload natively: the
flush produces the httptrap JSON body (`{name: {"_type": ..,
"_value": ..}}`, histograms as circllhist "H[m.me±e]=n" bin strings)
and hands it to an injectable `transport(url, payload)` — the only
network hop.

Port of istio_tpu/adapters/circonus.py: host code, the reference's own.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Mapping, Sequence
from urllib.parse import urlparse

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import (AdapterUnavailable, Builder,
                                          Env, Handler, Info)

GAUGE, COUNTER, DISTRIBUTION = "gauge", "counter", "distribution"


def histogram_bin(value: float) -> str:
    """circllhist log-linear bin label: two significant decimal digits
    times a power of ten, e.g. 0.0034 → 'H[+34e-4]'."""
    if value == 0 or not math.isfinite(value):
        return "H[0]"
    sign = "+" if value > 0 else "-"
    mag = abs(value)
    exp = math.floor(math.log10(mag)) - 1
    mant = int(mag / (10.0 ** exp))
    if mant >= 100:            # rounding pushed into the next decade
        mant //= 10
        exp += 1
    return f"H[{sign}{mant}e{exp:+03d}]"


class MetricAggregator:
    """The circonus-gometrics accumulation model: counters sum,
    gauges keep the last value, histograms count samples per
    log-linear bin. flush() drains to an httptrap JSON payload."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, dict[str, int]] = {}

    def increment(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def timing(self, name: str, value: float) -> None:
        with self._lock:
            bins = self._hists.setdefault(name, {})
            b = histogram_bin(value)
            bins[b] = bins.get(b, 0) + 1

    def flush(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            out: dict[str, dict[str, Any]] = {}
            for name, v in self._counters.items():
                out[name] = {"_type": "L", "_value": v}
            for name, v in self._gauges.items():
                out[name] = {"_type": "n", "_value": v}
            for name, bins in self._hists.items():
                out[name] = {"_type": "h",
                             "_value": [f"{b}={n}" for b, n in
                                        sorted(bins.items())]}
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            return out


class CirconusHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env):
        self.env = env
        self.url = str(config.get("submission_url", ""))
        self.metrics: dict[str, str] = {
            m["name"]: m.get("type", COUNTER)
            for m in config.get("metrics", ())}
        self.transport: Callable[[str, Mapping[str, Any]], Any] | None = \
            config.get("transport")
        self.agg = MetricAggregator()
        self._stop = threading.Event()
        interval = float(config.get("submission_interval_s", 10.0))
        self._ticker = threading.Thread(
            target=self._run, args=(interval,), daemon=True,
            name="circonus-flush")
        self._ticker.start()

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self._flush()
            except AdapterUnavailable:
                pass               # keep aggregating; drain on close
            except Exception:
                self.env.logger.exception("circonus flush failed")

    def _flush(self) -> None:
        if self.transport is None:
            # keep aggregating rather than dropping the drained batch
            raise AdapterUnavailable(
                "circonus: no egress in this build; inject `transport` "
                "to submit to an httptrap")
        payload = self.agg.flush()
        if payload:
            try:
                self.transport(self.url, payload)
            except Exception:
                self._restore(payload)   # retry next tick, don't drop
                raise

    def _restore(self, payload: Mapping[str, Any]) -> None:
        for name, entry in payload.items():
            if entry["_type"] == "L":
                self.agg.increment(name, entry["_value"])
            elif entry["_type"] == "n":
                with self.agg._lock:
                    self.agg._gauges.setdefault(name, entry["_value"])
            else:
                with self.agg._lock:
                    bins = self.agg._hists.setdefault(name, {})
                    for s in entry["_value"]:
                        b, n = s.rsplit("=", 1)
                        bins[b] = bins.get(b, 0) + int(n)

    def handle_report(self, template: str,
                      instances: Sequence[Mapping[str, Any]]) -> None:
        for inst in instances:
            name = str(inst.get("name", ""))
            mtype = self.metrics.get(name)
            if mtype == GAUGE:
                self.agg.gauge(name, float(inst.get("value", 0)))
            elif mtype == DISTRIBUTION:
                # durations normalize to seconds upstream; record raw
                self.agg.timing(name, float(inst.get("value", 0.0)))
            elif mtype == COUNTER:
                self.agg.increment(name)
            # unconfigured metrics are dropped (circonus.go switch
            # default: no case → no record)

    def close(self) -> None:
        self._stop.set()
        self._ticker.join(timeout=2.0)
        try:
            self._flush()          # final drain, circonus.go:94-96
        except AdapterUnavailable:
            pass


class CirconusBuilder(Builder):
    def validate(self) -> list[str]:
        errs: list[str] = []
        url = str(self.config.get("submission_url", ""))
        parsed = urlparse(url)
        if not (parsed.scheme and parsed.netloc):
            errs.append(f"submission_url: not a valid URL: {url!r}")
        if float(self.config.get("submission_interval_s", 10.0)) < 1.0:
            errs.append("submission_interval_s: must be at least 1 second")
        configured = {m.get("name") for m in self.config.get("metrics", ())}
        for m in self.config.get("metrics", ()):
            if m.get("type", COUNTER) not in (GAUGE, COUNTER, DISTRIBUTION):
                errs.append(f"metrics: bad type for {m.get('name')}")
        declared = set(getattr(self, "types", {}) or ())
        for name in declared - configured:
            errs.append(f"metrics: missing metric configuration {name}")
        for name in configured - declared:
            if declared:
                errs.append(f"metrics: missing metric type for {name}")
        return errs

    def build(self) -> Handler:
        return CirconusHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="circonus",
    supported_templates=("metric",),
    builder=CirconusBuilder,
    description="metric aggregation → circonus httptrap"))
