"""prometheus — expose metric instances as Prometheus metrics.

Port of istio_tpu/adapters/prometheus_adapter.py (reference:
mixer/adapter/prometheus): each configured metric maps a metric
instance to a counter/gauge/histogram with label names drawn from the
instance's dimensions. The reference backs this with prometheus_client;
the port keeps the values in its own small in-process series table, so
the package does not need that library. The handler builds and
validates like the reference's, so a served store that names it loads
unchanged.
"""
from __future__ import annotations

import threading
from typing import Any, Mapping, Sequence

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import (AdapterError, Builder, Handler,
                                          Info)

KINDS = ("COUNTER", "GAUGE", "DISTRIBUTION")


def _label_value(v: Any) -> str:
    return str(v)


class PrometheusHandler(Handler):
    def __init__(self, config: Mapping[str, Any]):
        # metric name → (kind, exported name, label names)
        self._metrics: dict[str, tuple[str, str, list[str]]] = {}
        # (metric name, label values) → counter/gauge value, or the list
        # of observations of a DISTRIBUTION
        self.series: dict[tuple[str, tuple[str, ...]], Any] = {}
        self._lock = threading.Lock()
        namespace = config.get("namespace", "istio_tpu")
        for m in config.get("metrics", ()):
            name = m["name"]
            kind = m.get("kind", "COUNTER")
            if kind not in KINDS:
                raise AdapterError(f"unknown metric kind {kind}")
            pname = f"{namespace}_{name}".replace(".", "_").replace("-", "_")
            self._metrics[name] = (kind, pname,
                                   list(m.get("label_names", ())))

    def handle_report(self, template: str,
                      instances: Sequence[Mapping[str, Any]]) -> None:
        with self._lock:
            for inst in instances:
                name = inst.get("name", "")
                entry = self._metrics.get(name)
                if entry is None:
                    continue
                kind, _, labels = entry
                dims = inst.get("dimensions", {}) or {}
                key = (name, tuple(_label_value(dims.get(l, ""))
                                   for l in labels))
                value = inst.get("value", 0)
                if isinstance(value, bool):
                    value = int(value)
                if kind == "COUNTER":
                    self.series[key] = self.series.get(key, 0.0) + \
                        float(value)
                elif kind == "GAUGE":
                    self.series[key] = float(value)
                else:
                    self.series.setdefault(key, []).append(float(value))


class PrometheusBuilder(Builder):
    def validate(self) -> list[str]:
        errs = []
        for m in self.config.get("metrics", ()):
            if "name" not in m:
                errs.append("metric missing name")
            if m.get("kind", "COUNTER") not in KINDS:
                errs.append(f"{m.get('name')}: unknown kind")
        return errs

    def build(self) -> Handler:
        return PrometheusHandler(self.config)


INFO = adapter_registry.register(Info(
    name="prometheus",
    supported_templates=("metric",),
    builder=PrometheusBuilder,
    description="metric instances as prometheus counters/gauges/"
                "histograms"))
