"""servicecontrol — Google Service Control check/report/quota.

Reference: mixer/adapter/servicecontrol (~3,000 LoC):
  * apikey check (checkprocessor.go): empty key/operation →
    INVALID_ARGUMENT; consumer id is `api_key:<key>`; Check responses
    are cached per (google service, consumer, operation) with the
    configured expiration; HTTP status + the first CheckError map to
    rpc codes (utils.go toRPCCode / serviceControlErrorToRPCCode).
  * report (reportprocessor.go + reportbuilder.go + metrics.go): each
    instance becomes one Operation (uuid id, RFC3339 start/end) with
    MetricValueSets from the supported-metric table — label generator
    functions per /protocol, /response_code, /response_code_class,
    /status_code, /credential_id — plus an endpoints_log entry whose
    severity is ERROR for response codes ≥400 (error cause AUTH for
    401/403, APPLICATION otherwise); sends are scheduled off the
    request path (env.ScheduleWork, reportprocessor.go:60).
  * quota (quotaprocessor.go): AllocateQuota with quota mode NORMAL or
    BEST_EFFORT, granted amount read back from the
    serviceruntime allocation-result metric.

The processors are implemented natively; the network client is an
injectable `transport(method, service, payload) -> response dict`
(`:check`, `:report`, `:allocateQuota`) — without it, check/quota fail
closed (UNAVAILABLE) and reports buffer until close.

Port of istio_tpu/adapters/servicecontrol.py: host code, the
reference's own.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, Mapping, Sequence

from istio_tpu_torch.adapters.registry import adapter_registry
from istio_tpu_torch.adapters.sdk import (Builder, CheckResult, Env,
                                          Handler, Info, QuotaArgs,
                                          QuotaResult)
from istio_tpu_torch.utils.cache import TTLCache

OK, INVALID_ARGUMENT, NOT_FOUND = 0, 3, 5
PERMISSION_DENIED, RESOURCE_EXHAUSTED = 7, 8
FAILED_PRECONDITION, UNIMPLEMENTED = 9, 12
INTERNAL, UNAVAILABLE, UNAUTHENTICATED = 13, 14, 16
ALREADY_EXISTS, CANCELLED, DEADLINE_EXCEEDED, UNKNOWN = 6, 1, 4, 2

_HTTP_TO_RPC = {200: OK, 400: INVALID_ARGUMENT, 401: UNAUTHENTICATED,
                403: PERMISSION_DENIED, 404: NOT_FOUND,
                409: ALREADY_EXISTS, 429: RESOURCE_EXHAUSTED,
                499: CANCELLED, 500: INTERNAL, 501: UNIMPLEMENTED,
                503: UNAVAILABLE, 504: DEADLINE_EXCEEDED}

_SC_ERROR_TO_RPC = {
    "NOT_FOUND": NOT_FOUND,
    "PERMISSION_DENIED": PERMISSION_DENIED,
    "SECURITY_POLICY_VIOLATED": PERMISSION_DENIED,
    "RESOURCE_EXHAUSTED": RESOURCE_EXHAUSTED,
    "BUDGET_EXCEEDED": RESOURCE_EXHAUSTED,
    "LOAD_SHEDDING": RESOURCE_EXHAUSTED,
    "ABUSER_DETECTED": PERMISSION_DENIED,
    "API_KEY_INVALID": INVALID_ARGUMENT,
    "API_KEY_EXPIRED": INVALID_ARGUMENT,
    "SERVICE_NOT_ACTIVATED": PERMISSION_DENIED,
    "PROJECT_DELETED": PERMISSION_DENIED,
    "PROJECT_INVALID": INVALID_ARGUMENT,
    "BILLING_DISABLED": PERMISSION_DENIED,
}

_ALLOCATION_RESULT_METRIC = \
    "serviceruntime.googleapis.com/api/consumer/quota_used_count"


def http_to_rpc(code: int) -> int:
    """utils.go toRPCCode."""
    if code in _HTTP_TO_RPC:
        return _HTTP_TO_RPC[code]
    if 200 <= code <= 300:
        return OK
    if 400 <= code <= 500:
        return FAILED_PRECONDITION
    return UNKNOWN


def consumer_id(api_key: str) -> str:
    return f"api_key:{api_key}"


def _rfc3339(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


# ---------------------------------------------------------------------------
# report building (reportbuilder.go + metrics.go)
# ---------------------------------------------------------------------------

_ERROR_TYPES = ["0xx", "1xx", "2xx", "3xx", "4xx",
                "5xx", "6xx", "7xx", "8xx", "9xx"]


def _labels_for(inst: Mapping[str, Any],
                wanted: Sequence[str]) -> dict[str, str] | None:
    """Label generator table (reportbuilder.go:84-138). Returns None
    when a wanted label cannot be produced (metric skipped)."""
    out: dict[str, str] = {}
    code = int(inst.get("response_code", 0))
    for label in wanted:
        if label == "/credential_id":
            key = str(inst.get("api_key", ""))
            if not key:
                return None
            out[label] = "apiKey:" + key
        elif label == "/protocol":
            proto = str(inst.get("api_protocol", ""))
            if not proto:
                return None
            out[label] = proto
        elif label == "/response_code":
            out[label] = str(code)
        elif label == "/response_code_class":
            if not 0 <= code < 1000:
                return None
            out[label] = _ERROR_TYPES[code // 100]
        elif label == "/status_code":
            out[label] = str(http_to_rpc(code))
        else:
            return None
    return out


# (name, value kind, label set) — metrics.go supportedMetrics
SUPPORTED_METRICS: tuple[tuple[str, str, tuple[str, ...]], ...] = (
    ("serviceruntime.googleapis.com/api/producer/request_count",
     "count", ("/protocol", "/response_code", "/response_code_class",
               "/status_code")),
    ("serviceruntime.googleapis.com/api/producer/backend_latencies",
     "latency", ()),
    ("serviceruntime.googleapis.com/api/producer/request_sizes",
     "size", ()),
    ("serviceruntime.googleapis.com/api/producer/by_consumer/request_count",
     "count", ("/credential_id", "/protocol", "/response_code",
               "/response_code_class", "/status_code")),
    ("serviceruntime.googleapis.com/api/consumer/request_count",
     "count", ("/credential_id", "/protocol", "/response_code",
               "/response_code_class", "/status_code")),
    ("serviceruntime.googleapis.com/api/consumer/backend_latencies",
     "latency", ("/credential_id",)),
)


def _latency_s(inst: Mapping[str, Any]) -> float | None:
    """Template field `response_latency` (DURATION → timedelta from the
    instance builder); plain seconds also accepted."""
    latency = inst.get("response_latency", inst.get("request_latency_s"))
    if latency is None:
        return None
    if hasattr(latency, "total_seconds"):
        return latency.total_seconds()
    return float(latency)


def _epoch_s(value: Any, default: float | None = None) -> float:
    """Template TIMESTAMP fields arrive as datetime; floats accepted."""
    if value is None:
        return time.time() if default is None else default
    if hasattr(value, "timestamp"):
        return value.timestamp()
    return float(value)


def _metric_value(kind: str, inst: Mapping[str, Any]) -> dict | None:
    if kind == "count":
        return {"int64Value": 1}
    if kind == "latency":
        latency = _latency_s(inst)
        if latency is None:
            return None
        # ESP time distribution: 29 exponential buckets, growth 2, scale 1e-6
        return {"distributionValue": _dist_value(
            latency, buckets=29, growth=2.0, scale=1e-6)}
    if kind == "size":
        size = inst.get("request_bytes", inst.get("request_size"))
        if size is None:
            return None
        return {"distributionValue": _dist_value(
            float(size), buckets=8, growth=10.0, scale=1.0)}
    return None


def _dist_value(value: float, buckets: int, growth: float,
                scale: float) -> dict:
    """distValueBuilder.go: one-sample exponential distribution with
    ESP's bucket parameters."""
    import math
    counts = [0] * (buckets + 2)
    if value >= scale:
        idx = min(1 + int(math.log(value / scale, growth)), buckets + 1)
    else:
        idx = 0
    counts[idx] = 1
    return {"count": 1, "minimum": value, "maximum": value, "mean": value,
            "sumOfSquaredDeviation": 0.0,
            "exponentialBuckets": {"numFiniteBuckets": buckets,
                                   "growthFactor": growth, "scale": scale},
            "bucketCounts": counts}


def build_operation(inst: Mapping[str, Any]) -> dict:
    """reportprocessor.go initializeOperation + reportBuilder.build.
    Field names follow the servicecontrolreport template
    (templates/builtin.py; template.proto:51-65): request_method/
    request_path/request_bytes/response_bytes/response_latency."""
    start = _epoch_s(inst.get("request_time"))
    end = _epoch_s(inst.get("response_time"), default=start)
    op: dict[str, Any] = {
        "operationId": str(uuid.uuid4()),
        "operationName": str(inst.get("api_operation", "")),
        "consumerId": consumer_id(str(inst["api_key"]))
        if inst.get("api_key") else "",
        "startTime": _rfc3339(start),
        "endTime": _rfc3339(end),
        "metricValueSets": [],
        "logEntries": [],
    }
    for name, kind, wanted in SUPPORTED_METRICS:
        labels = _labels_for(inst, wanted)
        if labels is None:
            continue
        value = _metric_value(kind, inst)
        if value is None:
            continue
        if labels:
            value = {**value, "labels": labels}
        op["metricValueSets"].append(
            {"metricName": name, "metricValues": [value]})

    # endpoints_log entry (reportbuilder.go logPayload); template →
    # payload key mapping: request_path→url, request_method→
    # http_method, request_bytes→request_size_in_bytes
    code = int(inst.get("response_code", 0))
    severity = "ERROR" if code >= 400 else "INFO"
    payload: dict[str, Any] = {}
    for key, src in (("url", "request_path"),
                     ("api_name", "api_service"),
                     ("api_version", "api_version"),
                     ("api_operation", "api_operation"),
                     ("api_key", "api_key"),
                     ("http_method", "request_method"),
                     ("request_size_in_bytes", "request_bytes"),
                     ("response_size_in_bytes", "response_bytes"),
                     ("location", "location"),
                     ("log_message", "log_message")):
        if inst.get(src):
            payload[key] = inst[src]
    payload["http_response_code"] = code
    payload["timestamp"] = _rfc3339(end)
    latency = _latency_s(inst)
    if latency is not None:
        payload["request_latency_in_ms"] = int(latency * 1000)
    if code >= 400:
        payload["error_cause"] = ("AUTH" if code in (401, 403)
                                  else "APPLICATION")
    op["logEntries"].append({"name": "endpoints_log",
                             "severity": severity,
                             "structPayload": payload})
    return op


# ---------------------------------------------------------------------------
# handler
# ---------------------------------------------------------------------------

class ServiceControlHandler(Handler):
    def __init__(self, config: Mapping[str, Any], env: Env):
        self.env = env
        self.transport: Callable[[str, str, Any], Any] | None = \
            config.get("transport")
        runtime = dict(config.get("runtime_config") or {})
        expiration = float(runtime.get("check_result_expiration_s", 60.0))
        self.check_expiration = expiration
        self._cache = TTLCache(
            ttl_seconds=expiration,
            capacity=int(runtime.get("check_cache_size", 10_000)))
        # mesh service name → {google_service_name, quotas: {name: cfg}}
        self.services: dict[str, dict] = {}
        for setting in config.get("service_configs", ()):
            entry = {"google_service_name":
                     str(setting.get("google_service_name", "")),
                     "quotas": {str(q.get("name")): dict(q)
                                for q in setting.get("quotas", ())}}
            self.services[str(setting.get("mesh_service_name", ""))] = entry
        self.default_service = next(iter(self.services.values()), None)
        self._lock = threading.Lock()
        self._pending_reports: list[tuple[str, dict]] = []

    def _service_for(self, inst: Mapping[str, Any]) -> dict | None:
        """Route by the template's api_service field (handler.go keys
        its serviceConfigIndex by mesh service name; the dispatcher
        here carries it on the instance)."""
        mesh = str(inst.get("api_service", "")
                   or inst.get("mesh_service", ""))
        return self.services.get(mesh) or self.default_service

    def _call(self, method: str, service: str, payload: Any) -> Any:
        if self.transport is None:
            raise ConnectionError(
                "servicecontrol: no egress in this build; inject "
                "`transport` to reach the Service Control API")
        return self.transport(method, service, payload)

    # -- apikey check (checkprocessor.go ProcessCheck) --

    def handle_check(self, template: str,
                     instance: Mapping[str, Any]) -> CheckResult:
        api_key = str(instance.get("api_key", ""))
        operation = str(instance.get("api_operation", ""))
        if not api_key or not operation:
            return self._result(
                INVALID_ARGUMENT,
                "api key and api operation must not be empty")
        svc = self._service_for(instance)
        if svc is None:
            return self._result(FAILED_PRECONDITION,
                                "no service_configs configured")
        google = svc["google_service_name"]
        cid = consumer_id(api_key)
        key = (google, cid, operation)
        response = self._cache.get(key)
        if response is None:
            request = {"operation": {
                "operationId": str(uuid.uuid4()),
                "operationName": operation,
                "consumerId": cid,
                "startTime": _rfc3339(
                    float(instance.get("timestamp", time.time())))}}
            try:
                response = self._call(":check", google, request)
            except Exception as exc:
                # fail closed like the reference (PERMISSION_DENIED on
                # client error, checkprocessor.go:63-66) — but surface
                # transport-missing as UNAVAILABLE
                code = UNAVAILABLE if isinstance(exc, ConnectionError) \
                    else PERMISSION_DENIED
                return self._result(code, str(exc))
            self._cache.set(key, response)
        return self._response_to_result(response)

    def _response_to_result(self, response: Mapping[str, Any]) -> CheckResult:
        http_status = int(response.get("httpStatusCode", 200))
        if http_status != 200:
            return self._result(http_to_rpc(http_status),
                                f"HTTP {http_status}")
        errors = response.get("checkErrors") or ()
        if errors:
            first = errors[0]
            code = str(first.get("code", "UNKNOWN"))
            return self._result(
                _SC_ERROR_TO_RPC.get(code, UNKNOWN),
                f"{code}: {first.get('detail', '')}")
        return self._result(OK, "")

    def _result(self, code: int, message: str) -> CheckResult:
        return CheckResult(status_code=code, status_message=message,
                           valid_duration_s=self.check_expiration,
                           valid_use_count=2**31 - 1)

    # -- report (reportprocessor.go ProcessReport) --

    def handle_report(self, template: str,
                      instances: Sequence[Mapping[str, Any]]) -> None:
        for inst in instances:
            svc = self._service_for(inst)
            if svc is None:
                continue
            op = build_operation(inst)
            if not op["metricValueSets"] and not op["logEntries"]:
                continue
            google = svc["google_service_name"]
            if self.transport is None:
                # buffer for a late-bound transport (set_transport);
                # bounded — oldest dropped first
                with self._lock:
                    self._pending_reports.append((google, op))
                    del self._pending_reports[:-1000]
                continue
            self.env.schedule_work(
                lambda g=google, o=op: self._send_report(g, o))

    def set_transport(self,
                      transport: Callable[[str, str, Any], Any]) -> None:
        """Late-bind the network client (e.g. once platform credentials
        resolve) and drain reports buffered while offline."""
        self.transport = transport
        with self._lock:
            pending, self._pending_reports = self._pending_reports, []
        for google, op in pending:
            self.env.schedule_work(
                lambda g=google, o=op: self._send_report(g, o))

    def _send_report(self, google: str, op: dict) -> None:
        try:
            self._call(":report", google, {"operations": [op]})
        except Exception:
            self.env.logger.exception("servicecontrol report failed")

    # -- quota (quotaprocessor.go ProcessQuota) --

    def handle_quota(self, template: str, instance: Mapping[str, Any],
                     args: QuotaArgs) -> QuotaResult:
        svc = self._service_for(instance)
        quota_name = str(instance.get("name", ""))
        quota_cfg = (svc or {}).get("quotas", {}).get(quota_name)
        if svc is None or quota_cfg is None:
            return QuotaResult(status_code=INVALID_ARGUMENT,
                               status_message=f"unknown quota name: "
                                              f"{quota_name}",
                               valid_duration_s=60.0)
        expiration = float(quota_cfg.get("expiration_s", 60.0))
        dims = dict(instance.get("dimensions") or {})
        api_key = str(dims.get("api_key", ""))
        operation = str(dims.get("api_operation", ""))
        if not api_key or not operation:
            return QuotaResult(
                status_code=INVALID_ARGUMENT,
                status_message="dimensions api_key/api_operation required",
                valid_duration_s=expiration)
        metric = str(quota_cfg.get("google_quota_metric_name", "")) \
            or quota_name
        request = {"allocateOperation": {
            "operationId": str(uuid.uuid4()),
            "methodName": operation,
            "consumerId": consumer_id(api_key),
            "quotaMetrics": [{"metricName": metric,
                              "metricValues":
                                  [{"int64Value": args.quota_amount}]}],
            "quotaMode": "BEST_EFFORT" if args.best_effort else "NORMAL"}}
        try:
            response = self._call(
                ":allocateQuota", svc["google_service_name"], request)
        except Exception as exc:
            return QuotaResult(status_code=UNAVAILABLE,
                               status_message=str(exc),
                               valid_duration_s=expiration)
        errors = response.get("allocateErrors") or ()
        if errors:
            first = errors[0]
            code = str(first.get("code", ""))
            granted = 0 if code == "RESOURCE_EXHAUSTED" \
                else args.quota_amount
            status = RESOURCE_EXHAUSTED if granted == 0 else OK
            return QuotaResult(granted_amount=granted, status_code=status,
                               status_message=str(first.get("detail", "")),
                               valid_duration_s=expiration)
        granted = args.quota_amount
        for mvs in response.get("quotaMetrics") or ():
            if mvs.get("metricName") == _ALLOCATION_RESULT_METRIC:
                for value in mvs.get("metricValues") or ():
                    labels = value.get("labels") or {}
                    if labels.get("/quota_name") == metric:
                        granted = int(value.get("int64Value", granted))
                        break
        return QuotaResult(granted_amount=granted,
                           valid_duration_s=expiration)

    def close(self) -> None:
        if self.transport is not None:
            with self._lock:
                pending, self._pending_reports = self._pending_reports, []
            for google, op in pending:
                self._send_report(google, op)


class ServiceControlBuilder(Builder):
    def validate(self) -> list[str]:
        errs: list[str] = []
        settings = self.config.get("service_configs", ())
        for setting in settings:
            if not setting.get("mesh_service_name"):
                errs.append("service_configs: mesh_service_name required")
            if not setting.get("google_service_name"):
                errs.append("service_configs: google_service_name required")
        runtime = self.config.get("runtime_config") or {}
        if float(runtime.get("check_result_expiration_s", 60.0)) <= 0:
            errs.append("runtime_config.check_result_expiration_s: must "
                        "be positive")
        return errs

    def build(self) -> Handler:
        return ServiceControlHandler(self.config, self.env)


INFO = adapter_registry.register(Info(
    name="servicecontrol",
    supported_templates=("apikey", "quota", "servicecontrolreport",
                         "metric", "logentry"),
    builder=ServiceControlBuilder,
    description="Google Service Control check/report/quota"))
