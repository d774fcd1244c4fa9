"""stackdriver — metrics/logs/traces to Google Cloud operations.

Reference: mixer/adapter/stackdriver — three sub-handlers sharing one
adapter entry (stackdriver.go):
  * metric/metric.go: HandleMetric converts instances to monitoring
    TimeSeries (custom.googleapis.com/<name> type, per-config kind and
    value type, distribution values bucketed by linear/exponential/
    explicit BucketsDefinition with under+overflow buckets,
    distribution.go:26-150), defaulting the monitored resource to
    `global` (metric.go:218-228); a buffered client merges same-series
    points per push window — DELTA munged to CUMULATIVE with a ≥1µs
    interval (merge.go:36-56) — and pushes on a ticker
    (bufferedClient.go, default interval 1m, metric.go:146-149).
  * log/log.go: HandleLogEntry maps instances to logging entries with
    severity parsing, label extraction and the HttpRequestMapping
    (log.go:119-215).
  * tracespan: span conversion (same shape as utils/tracing.py spans).

The translation/merge/bucketing logic is implemented natively below;
the one network hop (CreateTimeSeries / WriteLogEntries RPCs) is an
injectable `transport(method, payload)`.

Port of istio_tpu/adapters/stackdriver.py: host code, the reference's
own.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Mapping, Sequence

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import (AdapterUnavailable, Builder,
                                          Env, Handler, Info)

GAUGE, DELTA, CUMULATIVE = "GAUGE", "DELTA", "CUMULATIVE"

_SEVERITIES = ("DEFAULT", "DEBUG", "INFO", "NOTICE", "WARNING", "ERROR",
               "CRITICAL", "ALERT", "EMERGENCY")


class _Missing(dict):
    def __missing__(self, key):
        return ""


def _safe_format(template: str, variables: Mapping[str, Any]) -> str:
    """Template expansion that never throws on a missing variable or a
    malformed template — one bad log config must not fail the report
    call (log.go tolerates partial entries)."""
    try:
        return template.format_map(_Missing(variables))
    except (ValueError, IndexError):
        return template


# ---------------------------------------------------------------------------
# distribution bucketing (metric/distribution.go)
# ---------------------------------------------------------------------------

def bucket_count(buckets: Mapping[str, Any]) -> int:
    """Total bucket slots incl. underflow + overflow."""
    if "linear" in buckets:
        return int(buckets["linear"]["num_finite_buckets"]) + 2
    if "exponential" in buckets:
        return int(buckets["exponential"]["num_finite_buckets"]) + 2
    if "explicit" in buckets:
        return len(buckets["explicit"]["bounds"]) + 1
    return 0


def bucket_index(value: float, buckets: Mapping[str, Any]) -> int:
    """Index of the bucket `value` falls into (0 = underflow,
    last = overflow) — distribution.go index()."""
    if "linear" in buckets:
        lin = buckets["linear"]
        offset, width = float(lin["offset"]), float(lin["width"])
        n = int(lin["num_finite_buckets"])
        if value < offset:
            return 0
        i = int((value - offset) // width) + 1
        return min(i, n + 1)
    if "exponential" in buckets:
        ex = buckets["exponential"]
        scale, growth = float(ex["scale"]), float(ex["growth_factor"])
        n = int(ex["num_finite_buckets"])
        if value < scale:
            return 0
        i = 1 + int(math.log(value / scale, growth))
        return min(i, n + 1)
    if "explicit" in buckets:
        bounds = [float(b) for b in buckets["explicit"]["bounds"]]
        for i, bound in enumerate(bounds):
            if value < bound:
                return i
        return len(bounds)
    return 0


def to_distribution(value: float, buckets: Mapping[str, Any]) -> dict:
    counts = [0] * bucket_count(buckets)
    if counts:
        counts[bucket_index(value, buckets)] = 1
    return {"count": 1, "bucketOptions": dict(buckets),
            "bucketCounts": counts}


# ---------------------------------------------------------------------------
# time-series building + merging (metric/metric.go + merge.go)
# ---------------------------------------------------------------------------

def metric_type(name: str) -> str:
    return f"custom.googleapis.com/{name}"


def _series_key(ts: Mapping[str, Any]) -> tuple:
    metric = ts["metric"]
    res = ts.get("resource", {})
    return (metric["type"],
            tuple(sorted((metric.get("labels") or {}).items())),
            res.get("type", ""),
            tuple(sorted((res.get("labels") or {}).items())))


def merge_series(series: Sequence[Mapping[str, Any]]) -> list[dict]:
    """One point per series per push window: group by (metric,
    resource), sum mergeable values, widen the interval. DELTA becomes
    CUMULATIVE with end > start by ≥1µs (merge.go:36-56: stackdriver
    rejects DELTA custom metrics and zero-width cumulative windows)."""
    grouped: dict[tuple, list[dict]] = {}
    for ts in series:
        ts = {**ts}
        if ts.get("metricKind") in (DELTA, CUMULATIVE):
            pt = ts["points"][0]
            iv = pt["interval"]
            if iv["endTime"] <= iv["startTime"]:
                iv = {**iv, "endTime": iv["startTime"] + 1e-6}
                ts["points"] = [{**pt, "interval": iv}]
            ts["metricKind"] = CUMULATIVE
        grouped.setdefault(_series_key(ts), []).append(ts)

    out = []
    for group in grouped.values():
        cur = group[0]
        if cur.get("metricKind") == GAUGE:
            # gauge: last write wins, no additive merge
            out.append(group[-1])
            continue
        point = dict(cur["points"][0])
        start = point["interval"]["startTime"]
        end = point["interval"]["endTime"]
        for ts in group[1:]:
            nxt = ts["points"][0]
            point["value"] = _merge_value(point["value"], nxt["value"])
            start = min(start, nxt["interval"]["startTime"])
            end = max(end, nxt["interval"]["endTime"])
        point["interval"] = {"startTime": start, "endTime": end}
        out.append({**cur, "points": [point]})
    return out


def _merge_value(a: Mapping[str, Any], b: Mapping[str, Any]) -> dict:
    if "int64Value" in a:
        return {"int64Value": a["int64Value"] + b.get("int64Value", 0)}
    if "doubleValue" in a:
        return {"doubleValue": a["doubleValue"] + b.get("doubleValue", 0.0)}
    if "distributionValue" in a:
        da, db = a["distributionValue"], b["distributionValue"]
        counts = [x + y for x, y in
                  zip(da["bucketCounts"], db["bucketCounts"])]
        return {"distributionValue": {
            "count": da["count"] + db["count"],
            "bucketOptions": da["bucketOptions"],
            "bucketCounts": counts}}
    return dict(a)                 # bool/string: last write wins


class _BufferedPusher:
    """bufferedClient.go: accumulate under a lock, merge + push on the
    ticker; Close drains."""

    def __init__(self, env: Env, method: str,
                 transport: Callable[[str, Any], Any] | None,
                 interval_s: float, merge=None):
        self.env = env
        self.method = method
        self.transport = transport
        self.merge = merge
        self._lock = threading.Lock()
        self._buf: list[dict] = []
        self._stop = threading.Event()
        self._ticker = threading.Thread(
            target=self._run, args=(max(interval_s, 0.05),), daemon=True,
            name=f"stackdriver-{method}")
        self._ticker.start()

    def record(self, items: Sequence[Mapping[str, Any]]) -> None:
        with self._lock:
            self._buf.extend(dict(i) for i in items)

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.flush()
            except AdapterUnavailable:
                pass               # keep buffering; drain on close
            except Exception:
                self.env.logger.exception("stackdriver push failed")

    def flush(self) -> None:
        if self.transport is None:
            with self._lock:
                pending = len(self._buf)
            if pending:
                raise AdapterUnavailable(
                    "stackdriver: no egress in this build; inject "
                    "`transport` to push")
            return
        with self._lock:
            batch, self._buf = self._buf, []
        if batch:
            if self.merge is not None:
                batch = self.merge(batch)
            self.transport(self.method, batch)

    def close(self) -> None:
        self._stop.set()
        self._ticker.join(timeout=2.0)
        try:
            self.flush()
        except AdapterUnavailable:
            pass


class StackdriverHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env):
        self.env = env
        self.project = str(config.get("project_id", ""))
        self.metric_info: dict[str, dict] = {
            str(k): dict(v)
            for k, v in (config.get("metric_info") or {}).items()}
        self.log_info: dict[str, dict] = {
            str(k): dict(v)
            for k, v in (config.get("log_info") or {}).items()}
        transport = config.get("transport")
        interval = float(config.get("push_interval_s", 60.0))
        self._metrics = _BufferedPusher(env, "monitoring.createTimeSeries",
                                        transport, interval,
                                        merge=merge_series)
        self._logs = _BufferedPusher(env, "logging.writeLogEntries",
                                     transport, interval)
        self._traces = _BufferedPusher(env, "cloudtrace.batchWriteSpans",
                                       transport, interval)
        self.now = config.get("now", time.time)

    # -- metrics (metric/metric.go HandleMetric) --

    def _typed_value(self, value: Any, info: Mapping[str, Any]) -> dict:
        if info.get("value") == "DISTRIBUTION":
            return {"distributionValue":
                    to_distribution(float(value), info.get("buckets", {}))}
        if isinstance(value, bool):
            return {"boolValue": value}
        if isinstance(value, int):
            return {"int64Value": value}
        if isinstance(value, float):
            return {"doubleValue": value}
        return {"stringValue": str(value)}

    def handle_report(self, template: str,
                      instances: Sequence[Mapping[str, Any]]) -> None:
        if template == "metric":
            self._handle_metrics(instances)
        elif template == "logentry":
            self._handle_logs(instances)
        elif template == "tracespan":
            self._handle_traces(instances)

    def _handle_metrics(self, instances) -> None:
        now = self.now()
        data = []
        for inst in instances:
            name = str(inst.get("name", ""))
            info = self.metric_info.get(name)
            if info is None:
                continue           # not configured → cannot publish
            resource = ({"type": inst["monitored_resource_type"],
                         "labels": {
                             str(k): str(v) for k, v in
                             (inst.get("monitored_resource_dimensions")
                              or {}).items()}}
                        if inst.get("monitored_resource_type")
                        else {"type": "global",
                              "labels": {"project_id": self.project}})
            data.append({
                "metric": {"type": metric_type(name),
                           "labels": {str(k): str(v) for k, v in
                                      (inst.get("dimensions")
                                       or {}).items()}},
                "metricKind": info.get("kind", GAUGE),
                "valueType": info.get("value", "INT64"),
                "resource": resource,
                "points": [{"interval": {"startTime": now,
                                         "endTime": now},
                            "value": self._typed_value(
                                inst.get("value"), info)}]})
        if data:
            self._metrics.record(data)

    # -- logs (log/log.go HandleLogEntry) --

    def _handle_logs(self, instances) -> None:
        entries = []
        for inst in instances:
            name = str(inst.get("name", "istio"))
            info = self.log_info.get(name, {})
            variables = dict(inst.get("variables") or {})
            severity = str(inst.get("severity", "DEFAULT")).upper()
            if severity not in _SEVERITIES:
                severity = "DEFAULT"
            entry: dict[str, Any] = {
                "logName": f"projects/{self.project}/logs/{name}",
                "timestamp": inst.get("timestamp", self.now()),
                "severity": severity,
                "labels": {str(k): str(v) for k, v in variables.items()},
            }
            payload_tmpl = info.get("payload_template")
            if payload_tmpl:
                entry["textPayload"] = _safe_format(str(payload_tmpl),
                                                    variables)
            else:
                entry["jsonPayload"] = variables
            req_map = info.get("http_mapping")
            if req_map:
                entry["httpRequest"] = {
                    dst: variables[src]
                    for dst, src in req_map.items() if src in variables}
            entries.append(entry)
        if entries:
            self._logs.record(entries)

    # -- traces (tracespan template over the shared span shape) --

    def _handle_traces(self, instances) -> None:
        spans = []
        for inst in instances:
            spans.append({
                "name": (f"projects/{self.project}/traces/"
                         f"{inst.get('trace_id', '')}/spans/"
                         f"{inst.get('span_id', '')}"),
                "spanId": inst.get("span_id", ""),
                "parentSpanId": inst.get("parent_span_id", ""),
                "displayName": inst.get("span_name", ""),
                "startTime": inst.get("start_time"),
                "endTime": inst.get("end_time"),
                "attributes": dict(inst.get("span_tags") or {}),
            })
        if spans:
            self._traces.record(spans)

    def close(self) -> None:
        self._metrics.close()
        self._logs.close()
        self._traces.close()


class StackdriverBuilder(Builder):
    def validate(self) -> list[str]:
        errs: list[str] = []
        if not self.config.get("project_id"):
            errs.append("project_id: required")
        for name, info in (self.config.get("metric_info") or {}).items():
            kind = info.get("kind", GAUGE)
            if kind not in (GAUGE, DELTA, CUMULATIVE):
                errs.append(f"metric_info[{name}].kind: {kind!r}")
            if info.get("value") == "DISTRIBUTION" \
                    and bucket_count(info.get("buckets", {})) == 0:
                errs.append(f"metric_info[{name}]: distribution needs "
                            "linear/exponential/explicit buckets")
        return errs

    def build(self) -> Handler:
        return StackdriverHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="stackdriver",
    supported_templates=("metric", "logentry", "tracespan"),
    builder=StackdriverBuilder,
    description="metrics/logs/traces → Google Cloud operations suite"))
