"""The port's adapters and templates against the JAX package's.

Each of the 24 scenarios of tests/test_templates_adapters.py runs twice,
once over each package's modules, and records what it observes: handler
results, instances, payloads handed to a transport seam, stdio lines,
statsd datagrams, fluentd bytes and errors. Every value is recorded with
its Python type, so a numpy scalar where the reference hands an int
shows. The two records must be equal, exactly: every value is an int, a
string, a bool, bytes, or a float that both packages compute with the
same operations. The scenario keeps the original's own assertions too.
uuid4 and the wall clock are pinned while a scenario runs, so that ids
and times in payloads compare. The informer scenario passes the
reference's FakeKubeCluster to both handlers (the port carries no kube
module of its own).
"""
import dataclasses
import datetime
import importlib
import itertools
import socket
import time
import uuid

import pytest

PACKAGES = ("istio_tpu", "istio_tpu_torch")


class Pkg:
    """One package's modules by their path under the package root."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.registry = self.mod("adapters.registry")
        self.registry.load_inventory()
        self.sdk = self.mod("adapters.sdk")
        self.env = self.sdk.Env("test")
        self.pe = self.mod("models.policy_engine")
        self.templates = self.mod("templates")
        finder = self.mod("expr.checker").AttributeDescriptorFinder
        self.finder = finder(self.mod("testing.corpus").CORPUS_MANIFEST)

    def mod(self, path: str):
        return importlib.import_module(f"{self.root}.{path}")

    def bag(self, values: dict):
        return self.mod("attribute.bag").bag_from_mapping(values)

    def build(self, adapter: str, config: dict):
        info = self.registry.adapter_registry.get(adapter)
        b = info.builder(config, self.env)
        errs = b.validate()
        assert not errs, errs
        return b.build()


def typed(x):
    """x with the type of every leaf beside it (dataclasses by their
    class name and fields)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, typed(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {typed(k): typed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [typed(v) for v in x])
    return (type(x).__name__, x)


def raised(fn):
    """fn()'s result, or the type name and message of what it raised."""
    try:
        return ("value", fn())
    except Exception as exc:   # noqa: BLE001 — the error is the result
        return ("raised", type(exc).__name__, str(exc))


# ---------------------------------------------------------------- templates

def s_inventory_parity(p: Pkg, rec, **_):
    rec(p.templates.registry.names())
    rec(sorted(p.registry.adapter_registry.names()))
    assert sorted(p.registry.adapter_registry.names()) == [
        "circonus", "denier", "fluentd", "kubernetesenv", "list",
        "memquota", "noop", "opa", "prometheus", "rbac",
        "servicecontrol", "stackdriver", "statsd", "stdio"]
    rec(raised(lambda: p.registry.adapter_registry.get("nope")))


def s_listentry_instance(p: Pkg, rec, **_):
    ib = p.templates.InstanceBuilder(
        p.templates.registry.get("listentry"), "staticversion",
        {"value": 'source.labels["version"] | "unknown"'}, p.finder)
    rec(ib.build(p.bag({"source.labels": {"version": "v1"}})))
    inst = ib.build(p.bag({"source.labels": {}}))
    assert inst["value"] == "unknown"
    rec(inst)


def s_metric_instance(p: Pkg, rec, **_):
    ib = p.templates.InstanceBuilder(
        p.templates.registry.get("metric"), "requestcount", {
            "value": "request.size",
            "dimensions": {"service": "destination.service",
                           "protocol": 'context.protocol | "http"'}},
        p.finder)
    rec(str(ib.inferred["value"]))
    inst = ib.build(p.bag({"request.size": 7, "destination.service": "a.b"}))
    assert inst["value"] == 7
    rec(inst)


def s_authorization_instance(p: Pkg, rec, **_):
    ib = p.templates.InstanceBuilder(
        p.templates.registry.get("authorization"), "authinfo", {
            "subject": {"user": 'source.name | ""'},
            "action": {"namespace": 'destination.namespace | "default"',
                       "service": "destination.service",
                       "method": 'context.protocol',
                       "properties": {
                           "version": 'source.labels["version"] | ""'}}},
        p.finder)
    inst = ib.build(p.bag({"destination.service": "svc",
                           "context.protocol": "GET",
                           "source.labels": {"version": "v2"}}))
    assert inst["action"]["properties"] == {"version": "v2"}
    rec(inst)


def s_template_type_mismatch(p: Pkg, rec, **_):
    from_fw = p.mod("templates.framework").infer_types
    get = p.templates.registry.get
    for params in ({"value": "request.size"}, {"nope": '"x"'}, {}):
        got = raised(lambda: from_fw(get("listentry"), params, p.finder))
        assert got[0] == "raised" and got[1] == "TemplateError"
        rec(got)


# ---------------------------------------------------------------- adapters

def s_denier(p: Pkg, rec, **_):
    h = p.build("denier", {"status_code": p.pe.PERMISSION_DENIED})
    r = h.handle_check("checknothing", {"name": "i"})
    assert r.status_code == p.pe.PERMISSION_DENIED
    rec(r)
    rec(h.handle_quota("quota", {"name": "q"},
                       p.sdk.QuotaArgs(quota_amount=5)))


def s_list_whitelist_strings(p: Pkg, rec, **_):
    h = p.build("list", {"overrides": ["v1", "v2"]})
    for v in ("v1", "v9"):
        rec(h.handle_check("listentry", {"value": v}))


def s_list_blacklist_cidr(p: Pkg, rec, **_):
    h = p.build("list", {"entry_type": "IP_ADDRESSES", "blacklist": True,
                         "overrides": ["10.0.0.0/8"]})
    mapped = b"\x00" * 10 + b"\xff\xff" + bytes([10, 9, 9, 9])
    for v in ("10.1.2.3", "192.168.1.1", mapped):
        rec(h.handle_check("listentry", {"value": v}))


def s_list_regex_file_provider(p: Pkg, rec, tmp_path, **_):
    path = tmp_path / "allow.txt"
    path.write_text("^/api/.*\n^/healthz$\n")
    h = p.build("list", {"entry_type": "REGEX",
                         "provider_url": f"file://{path}"})
    for v in ("/api/v1", "/admin"):
        rec(h.handle_check("listentry", {"value": v}))


def s_memquota_window_and_dedup(p: Pkg, rec, **_):
    now = [0.0]
    h = p.mod("adapters.memquota").MemQuotaHandler({"quotas": [
        {"name": "rate", "max_amount": 3, "valid_duration_s": 10.0}]},
        p.env, clock=lambda: now[0])
    qa = p.sdk.QuotaArgs
    inst = {"name": "rate", "dimensions": {"u": "alice"}}
    other = {"name": "rate", "dimensions": {"u": "bob"}}
    for i, a in ((inst, qa(quota_amount=2)),
                 (inst, qa(quota_amount=1, dedup_id="d1")),
                 (inst, qa(quota_amount=1, dedup_id="d1")),
                 (inst, qa(quota_amount=2, best_effort=False)),
                 (other, qa(quota_amount=3))):
        rec(h.handle_quota("quota", i, a))
    now[0] = 11.0
    r = h.handle_quota("quota", inst, qa(quota_amount=3))
    assert r.granted_amount == 3
    rec(r)


def s_rbac(p: Pkg, rec, **_):
    h = p.build("rbac", {
        "roles": [{"name": "viewer", "namespace": "ns1", "rules": [
            {"services": ["products.*"], "methods": ["GET"],
             "paths": ["/products*"]}]}],
        "bindings": [{"name": "b1", "namespace": "ns1",
                      "roleRef": {"name": "viewer"},
                      "subjects": [{"user": "alice"}]}]})
    for user, method in (("alice", "GET"), ("bob", "GET"),
                         ("alice", "DELETE")):
        rec(h.handle_check("authorization", {
            "subject": {"user": user},
            "action": {"namespace": "ns1", "service": "products.ns1",
                       "method": method, "path": "/products/1"}}))


def s_opa_expression_policies(p: Pkg, rec, **_):
    h = p.build("opa", {"policies": [
        'action.method == "GET" && action.path.startsWith("/public/")',
        'subject.user == "admin"']})
    for user, method, path in (("joe", "GET", "/public/x"),
                               ("admin", "DELETE", "/private"),
                               ("joe", "DELETE", "/private")):
        rec(h.handle_check("authorization", {
            "subject": {"user": user},
            "action": {"method": method, "path": path}}))


def _prom_sample(p: Pkg, h, name: str, labels: dict):
    """A counter's value: through prometheus_client's registry in the
    reference, through the port's own series table."""
    if p.root == "istio_tpu":
        return h.registry.get_sample_value(f"istio_tpu_{name}_total",
                                           labels)
    return h.series[(name, tuple(labels.values()))]


def s_stdio_and_prometheus(p: Pkg, rec, capsys, **_):
    h = p.build("stdio", {})
    h.handle_report("logentry", [{
        "name": "accesslog", "severity": "warning",
        "timestamp": datetime.datetime(2018, 1, 1),
        "variables": {"url": "/x", "code": 200,
                      "ip": b"\x0a\x00\x00\x01",
                      "latency": datetime.timedelta(milliseconds=5)}}])
    h.handle_report("metric", [{"name": "m", "value": 3,
                                "dimensions": {"svc": "a"}}])
    out = capsys.readouterr().out
    assert len(out.splitlines()) == 2 and '"url": "/x"' in out
    rec(out)
    ph = p.build("prometheus", {"metrics": [
        {"name": "requestcount", "kind": "COUNTER",
         "label_names": ["service"]}]})
    ph.handle_report("metric", [
        {"name": "requestcount", "value": 2,
         "dimensions": {"service": "a.b"}},
        {"name": "requestcount", "value": 3,
         "dimensions": {"service": "a.b"}}])
    sample = _prom_sample(p, ph, "requestcount", {"service": "a.b"})
    assert sample == 5.0
    rec(sample)


def s_statsd_lines(p: Pkg, rec, **_):
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    recv.settimeout(2.0)
    h = p.build("statsd", {"port": recv.getsockname()[1],
                           "prefix": "istio.",
                           "metrics": [{"name": "reqs", "type": "COUNTER",
                                        "name_template": "by_${svc}"},
                                       {"name": "lat", "type": "TIMING",
                                        "sample_rate": 0.5}]})
    try:
        h.handle_report("metric", [{"name": "reqs", "value": 4,
                                    "dimensions": {"svc": "web"}},
                                   {"name": "lat", "value": 12},
                                   {"name": "skipped", "value": 1}])
        data = [recv.recvfrom(1024)[0] for _ in range(2)]
    finally:
        h.close()
        recv.close()
    assert data[0] == b"istio.by_web:4|c"
    rec(data)


def s_fluentd_msgpack(p: Pkg, rec, **_):
    fl = p.mod("adapters.fluentd")
    enc = fl.msgpack_encode(["tag", 123, {"k": "v", "n": 7}])
    assert enc[0] == 0x93
    rec(enc)
    rec(fl.msgpack_encode([None, True, -5, -(1 << 40), 1.5, b"\x01" * 300,
                           "x" * 40, {str(i): i for i in range(20)},
                           datetime.timedelta(seconds=2)]))
    # the handler's events through its socket seam
    a, b = socket.socketpair()
    h = fl.FluentdHandler({}, p.env, sock=a)
    h.handle_report("logentry", [{
        "name": "accesslog", "severity": "Default",
        "timestamp": datetime.datetime(2018, 3, 1, 12, 0, 0,
                                       tzinfo=datetime.timezone.utc),
        "variables": {"code": 200, "url": "/x"}}])
    h.close()
    b.settimeout(2.0)
    got = b""
    while chunk := b.recv(4096):
        got += chunk
    b.close()
    rec(got)


PODS = {"productpage.default": {
    "pod_name": "productpage-v1-abc", "namespace": "default",
    "labels": {"app": "productpage"}, "pod_ip": "10.0.0.5",
    "service_account_name": "sa-pp"}}


def s_kubernetesenv_apa(p: Pkg, rec, **_):
    h = p.build("kubernetesenv", {"pods": PODS})
    out = h.generate_attributes("kubernetes", {
        "source_uid": "kubernetes://productpage.default"})
    assert out["source_pod_name"] == "productpage-v1-abc"
    rec(out)
    for inst in ({"destination_ip": "10.0.0.5"},
                 {"origin_ip": bytes([10, 0, 0, 5])},
                 {"source_ip": b"\x00" * 10 + b"\xff\xff" +
                  bytes([10, 0, 0, 5])},
                 {"source_uid": "kubernetes://nope.default"}):
        rec(h.generate_attributes("kubernetes", inst))


def s_kubernetesenv_informer(p: Pkg, rec, **_):
    from istio_tpu.kube.fake import FakeKubeCluster
    cluster = FakeKubeCluster()
    cluster.create({"kind": "Pod",
                    "metadata": {"name": "reviews-v2-xyz",
                                 "namespace": "default",
                                 "labels": {"app": "reviews"}},
                    "spec": {"serviceAccountName": "sa-reviews"},
                    "status": {"podIP": "10.0.0.9",
                               "hostIP": "172.16.0.2"}})
    h = p.build("kubernetesenv", {"cluster": cluster})
    try:
        out = h.generate_attributes("kubernetes", {
            "source_uid": "kubernetes://reviews-v2-xyz.default"})
        assert out["source_service"] == "reviews"
        rec(out)
        cluster.create({"kind": "Pod",
                        "metadata": {"name": "ratings-v1-abc",
                                     "namespace": "prod",
                                     "labels": {"app": "ratings"}},
                        "status": {"podIP": "10.0.0.10"}})
        rec(h.generate_attributes("kubernetes",
                                  {"destination_ip": "10.0.0.10"}))
        cluster.delete("Pod", "prod", "ratings-v1-abc")
        rec(h.generate_attributes("kubernetes",
                                  {"destination_ip": "10.0.0.10"}))
    finally:
        h.close()


def s_circonus_aggregation_and_flush(p: Pkg, rec, **_):
    sent = []
    h = p.build("circonus", {
        "submission_url": "https://trap.example/module/httptrap/x/y",
        "submission_interval_s": 3600,
        "metrics": [{"name": "reqs", "type": "counter"},
                    {"name": "inflight", "type": "gauge"},
                    {"name": "latency", "type": "distribution"}],
        "transport": lambda url, payload: sent.append((url, payload))})
    try:
        h.handle_report("metric", [
            {"name": "reqs", "value": 1}, {"name": "reqs", "value": 1},
            {"name": "inflight", "value": 3}, {"name": "inflight", "value": 7},
            {"name": "latency", "value": 0.0034},
            {"name": "latency", "value": 0.0036},
            {"name": "latency", "value": 0.0},
            {"name": "latency", "value": -12.5},
            {"name": "unconfigured", "value": 9}])
        h._flush()
    finally:
        h.close()
    assert sent[0][1]["reqs"] == {"_type": "L", "_value": 2}
    rec(sent)


def s_circonus_validate(p: Pkg, rec, **_):
    info = p.registry.adapter_registry.get("circonus")
    for cfg in ({"submission_url": "not a url",
                 "submission_interval_s": 0.2},
                {"submission_url": "https://trap.example/x",
                 "metrics": [{"name": "a", "type": "bogus"}]}):
        rec(info.builder(cfg, p.env).validate())
    h = p.build("circonus", {"submission_url": "https://trap.example/x",
                             "submission_interval_s": 3600})
    try:
        rec(raised(h._flush))
    finally:
        h.close()


def s_stackdriver_metrics(p: Pkg, rec, **_):
    sent = []
    h = p.build("stackdriver", {
        "project_id": "proj-1",
        "push_interval_s": 3600,
        "metric_info": {
            "request_count": {"kind": "DELTA", "value": "INT64"},
            "inflight": {"kind": "GAUGE", "value": "INT64"},
            "latency": {"kind": "DELTA", "value": "DISTRIBUTION",
                        "buckets": {"explicit":
                                    {"bounds": [0.01, 0.1, 1.0]}}},
            "lin": {"kind": "DELTA", "value": "DISTRIBUTION",
                    "buckets": {"linear": {"num_finite_buckets": 3,
                                           "width": 2.0, "offset": 1.0}}},
            "exp": {"kind": "DELTA", "value": "DISTRIBUTION",
                    "buckets": {"exponential": {
                        "num_finite_buckets": 4, "growth_factor": 10.0,
                        "scale": 0.001}}}},
        "transport": lambda m, batch: sent.append((m, batch))})
    try:
        h.handle_report("metric", [
            {"name": "request_count", "value": 1,
             "dimensions": {"svc": "web"}},
            {"name": "request_count", "value": 1,
             "dimensions": {"svc": "web"}},
            {"name": "request_count", "value": 1,
             "dimensions": {"svc": "db"}},
            {"name": "latency", "value": 0.05, "dimensions": {}},
            {"name": "latency", "value": 5.0, "dimensions": {}},
            {"name": "lin", "value": 4.0, "dimensions": {}},
            {"name": "exp", "value": 0.5, "dimensions": {}},
            {"name": "inflight", "value": 3, "dimensions": {}},
            {"name": "inflight", "value": 7, "dimensions": {}},
            {"name": "skipped", "value": 1}])
        h._metrics.flush()
    finally:
        h.close()
    assert sent[0][0] == "monitoring.createTimeSeries"
    rec(sent)


def s_stackdriver_logs_and_traces(p: Pkg, rec, **_):
    sent = []
    h = p.build("stackdriver", {
        "project_id": "proj-1", "push_interval_s": 3600,
        "log_info": {"accesslog": {
            "payload_template": "{method} {path}",
            "http_mapping": {"requestMethod": "method",
                             "status": "code"}}},
        "transport": lambda m, batch: sent.append((m, batch))})
    try:
        h.handle_report("logentry", [
            {"name": "accesslog", "severity": "warning",
             "variables": {"method": "GET", "path": "/x", "code": 200}},
            {"name": "other", "severity": "nonsense",
             "variables": {"k": 1}}])
        h.handle_report("tracespan", [
            {"trace_id": "t1", "span_id": "s1", "span_name": "op",
             "span_tags": {"k": "v"}}])
        h._logs.flush()
        h._traces.flush()
    finally:
        h.close()
    assert dict(sent)["logging.writeLogEntries"][0]["textPayload"] == \
        "GET /x"
    rec(sent)


SC_CONFIG = {
    "service_configs": [{"mesh_service_name": "svc.default",
                         "google_service_name": "api.example.com",
                         "quotas": [{"name": "ratelimit",
                                     "expiration_s": 10}]}],
    "runtime_config": {"check_result_expiration_s": 30}}


def s_servicecontrol_check(p: Pkg, rec, **_):
    calls = []

    def transport(method, service, payload):
        calls.append((method, service, payload))
        if payload["operation"]["consumerId"].endswith("bad"):
            return {"checkErrors": [{"code": "API_KEY_INVALID",
                                     "detail": "nope"}]}
        if payload["operation"]["consumerId"].endswith("gone"):
            return {"httpStatusCode": 404}
        return {}

    h = p.build("servicecontrol", {**SC_CONFIG, "transport": transport})
    for key in ("", "k1", "k1", "bad", "gone"):
        rec(h.handle_check("apikey", {"api_key": key,
                                      "api_operation": "op"}))
    assert len(calls) == 3
    rec(calls)
    h2 = p.build("servicecontrol", SC_CONFIG)
    gated = h2.handle_check("apikey", {"api_key": "k", "api_operation": "op"})
    assert gated.status_code == 14
    rec(gated)


def s_servicecontrol_report(p: Pkg, rec, **_):
    build_operation = p.mod("adapters.servicecontrol").build_operation
    base = {"api_operation": "ListShelves", "api_key": "k1",
            "api_protocol": "http", "response_code": 403,
            "request_time": 1_700_000_000.0,
            "response_time": 1_700_000_000.25,
            "response_latency": datetime.timedelta(milliseconds=250),
            "request_bytes": 300,
            "request_method": "GET", "request_path": "/shelves"}
    op = build_operation(base)
    assert op["consumerId"] == "api_key:k1"
    rec(op)
    rec(build_operation({**base, "api_key": "", "response_code": 200,
                         "api_protocol": "grpc"}))
    rec(build_operation({**base, "response_code": 503}))


def s_servicecontrol_quota(p: Pkg, rec, **_):
    requests = []

    def transport(method, service, payload):
        requests.append((method, service, payload))
        op = payload["allocateOperation"]
        if op["consumerId"].endswith("poor"):
            return {"allocateErrors": [{"code": "RESOURCE_EXHAUSTED",
                                        "detail": "out"}]}
        return {"quotaMetrics": [{
            "metricName": ("serviceruntime.googleapis.com/api/consumer/"
                           "quota_used_count"),
            "metricValues": [{"labels": {"/quota_name": "ratelimit"},
                              "int64Value": 5}]}]}

    h = p.build("servicecontrol", {**SC_CONFIG, "transport": transport})
    qa = p.sdk.QuotaArgs
    for inst, args in (
            ({"name": "ratelimit",
              "dimensions": {"api_key": "k1", "api_operation": "op"}},
             qa(quota_amount=10)),
            ({"name": "ratelimit",
              "dimensions": {"api_key": "poor", "api_operation": "op"}},
             qa(quota_amount=10, best_effort=False)),
            ({"name": "nope", "dimensions": {}}, qa())):
        rec(h.handle_quota("quota", inst, args))
    rec(requests)


SCENARIOS = {f.__name__[2:]: f for f in (
    s_inventory_parity, s_listentry_instance, s_metric_instance,
    s_authorization_instance, s_template_type_mismatch, s_denier,
    s_list_whitelist_strings, s_list_blacklist_cidr,
    s_list_regex_file_provider, s_memquota_window_and_dedup, s_rbac,
    s_opa_expression_policies, s_stdio_and_prometheus, s_statsd_lines,
    s_fluentd_msgpack, s_kubernetesenv_apa, s_kubernetesenv_informer,
    s_circonus_aggregation_and_flush, s_circonus_validate,
    s_stackdriver_metrics, s_stackdriver_logs_and_traces,
    s_servicecontrol_check, s_servicecontrol_report,
    s_servicecontrol_quota)}


def run_scenario(name: str, root: str, monkeypatch, **kw) -> list:
    """The scenario's record over package `root`, with uuid4 and the
    wall clock pinned."""
    ids = itertools.count()
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    out: list = []
    try:
        SCENARIOS[name](Pkg(root), lambda x: out.append(typed(x)), **kw)
    finally:
        monkeypatch.undo()
    return out


def test_every_scenario_is_held():
    assert len(SCENARIOS) == 24


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equal_to_reference(name, monkeypatch, tmp_path, capsys):
    want, got = (run_scenario(name, root, monkeypatch, tmp_path=tmp_path,
                              capsys=capsys) for root in PACKAGES)
    assert want, "the scenario recorded nothing"
    assert got == want
