"""Strict Envoy v1 JSON schema validator.

The reference drives a REAL Envoy binary against its generated config
(mixer/test/client/env/envoy.go); this image ships no Envoy, so the
contract is enforced structurally instead: every emitted v1 JSON
document is validated against the exact field/type/enum shapes of
`pilot/pkg/proxy/envoy/resources.go:163-831` — unknown fields, wrong
types, missing always-serialized fields, and out-of-vocabulary enum
values all fail. The golden tests (tests/test_envoy_golden.py) run
every golden through this validator, so a malformed listener/cluster
shape can never silently ship to a proxy.

Schema encoding: {field: (TYPE, required)} where TYPE is `str`/`int`/
`bool`, ("enum", {...}), ("list", TYPE), ("obj", "SchemaName"),
("map", TYPE) or "any". Ints accept bools=False (JSON booleans are not
Envoy ints). `int_or_float` covers Go int64 fields that JSON may carry
as floats with integral values.

The port's copy of istio_tpu/pilot/envoy_schema.py, unchanged but for its
imports: standard library only, nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping

__all__ = ["EnvoySchemaError", "validate", "validate_listeners",
           "validate_clusters", "validate_route_config",
           "validate_bootstrap"]


class EnvoySchemaError(ValueError):
    pass


S = str
I = int
B = bool
F = "int_or_float"


def _enum(*vals: str):
    return ("enum", frozenset(vals))


# resources.go constants
CLUSTER_TYPES = _enum("static", "strict_dns", "logical_dns",
                      "original_dst", "sds")
LB_TYPES = _enum("round_robin", "least_request", "ring_hash", "random",
                 "original_dst_lb")
CODEC_TYPES = _enum("auto", "http1", "http2")

SCHEMAS: dict[str, dict[str, tuple]] = {
    # resources.go:162-173 Config (bootstrap root)
    "Config": {
        "runtime": (("obj", "RootRuntime"), False),
        "listeners": (("list", ("obj", "Listener")), True),
        "lds": (("obj", "LDSCluster"), False),
        "admin": (("obj", "Admin"), True),
        "cluster_manager": (("obj", "ClusterManager"), True),
        "statsd_udp_ip_address": (S, False),
        "tracing": (("obj", "Tracing"), False),
    },
    "RootRuntime": {
        "symlink_root": (S, True),
        "subdirectory": (S, True),
        "override_subdirectory": (S, False),
    },
    "Tracing": {"http": (("obj", "HTTPTracer"), True)},
    "HTTPTracer": {"driver": (("obj", "HTTPTraceDriver"), True)},
    "HTTPTraceDriver": {
        "type": (_enum("zipkin"), True),
        "config": (("obj", "HTTPTraceDriverConfig"), True),
    },
    "HTTPTraceDriverConfig": {
        "collector_cluster": (S, True),
        "collector_endpoint": (S, True),
    },
    "Admin": {
        "access_log_path": (S, True),
        "address": (S, True),
    },
    "ClusterManager": {
        "clusters": (("list", ("obj", "Cluster")), True),
        "sds": (("obj", "DiscoveryCluster"), False),
        "cds": (("obj", "DiscoveryCluster"), False),
    },
    "DiscoveryCluster": {
        "cluster": (("obj", "Cluster"), True),
        "refresh_delay_ms": (F, True),
    },
    "LDSCluster": {
        "cluster": (S, True),
        "refresh_delay_ms": (F, True),
    },
    # resources.go:625-639 Listener
    "Listener": {
        "address": (S, True),
        "name": (S, False),
        "filters": (("list", ("obj", "NetworkFilter")), True),
        "ssl_context": (("obj", "SSLContext"), False),
        "bind_to_port": (B, True),
        "use_original_dst": (B, False),
    },
    "SSLContext": {
        "cert_chain_file": (S, True),
        "private_key_file": (S, True),
        "ca_cert_file": (S, False),
        "require_client_certificate": (B, True),
        "alpn_protocols": (S, False),
    },
    "SSLContextExternal": {"ca_cert_file": (S, False)},
    "UpstreamSSLContext": {
        "cert_chain_file": (S, True),
        "private_key_file": (S, True),
        "ca_cert_file": (S, False),
        "verify_subject_alt_name": (("list", S), True),
    },
    # resources.go:613-617 NetworkFilter — config schema by name
    "NetworkFilter": {
        "type": (_enum("read", "write", "both", ""), True),
        "name": (S, True),
        "config": ("any", True),   # refined in _validate_network_filter
    },
    # resources.go:496-506 HTTPFilterConfig
    "HTTPFilterConfig": {
        "codec_type": (CODEC_TYPES, True),
        "stat_prefix": (S, True),
        "generate_request_id": (B, False),
        "use_remote_address": (B, False),
        "tracing": (("obj", "HTTPFilterTraceConfig"), False),
        "route_config": (("obj", "HTTPRouteConfig"), False),
        "rds": (("obj", "RDS"), False),
        "filters": (("list", ("obj", "HTTPFilter")), True),
        "access_log": (("list", ("obj", "AccessLog")), False),
    },
    "HTTPFilterTraceConfig": {"operation_name":
                              (_enum("egress", "ingress"), True)},
    "RDS": {
        "cluster": (S, True),
        "route_config_name": (S, True),
        "refresh_delay_ms": (F, True),
    },
    "AccessLog": {
        "path": (S, True),
        "format": (S, False),
        "filter": (S, False),
    },
    "HTTPFilter": {
        "type": (_enum("decoder", "encoder", "both", ""), True),
        "name": (S, True),
        "config": ("any", True),
    },
    # resources.go:401-403 HTTPRouteConfig
    "HTTPRouteConfig": {
        "virtual_hosts": (("list", ("obj", "VirtualHost")), True),
        "validate_clusters": (B, False),
    },
    "VirtualHost": {
        "name": (S, True),
        "domains": (("list", S), True),
        "routes": (("list", ("obj", "HTTPRoute")), True),
    },
    # resources.go:264-295 HTTPRoute
    "HTTPRoute": {
        "runtime": (("obj", "Runtime"), False),
        "path": (S, False),
        "prefix": (S, False),
        "regex": (S, False),
        "prefix_rewrite": (S, False),
        "host_rewrite": (S, False),
        "path_redirect": (S, False),
        "host_redirect": (S, False),
        "cluster": (S, False),
        "weighted_clusters": (("obj", "WeightedCluster"), False),
        "headers": (("list", ("obj", "Header")), False),
        "timeout_ms": (F, False),
        "retry_policy": (("obj", "RetryPolicy"), False),
        "opaque_config": (("map", S), False),
        "auto_host_rewrite": (B, False),
        "use_websocket": (B, False),
        "shadow": (("obj", "ShadowCluster"), False),
        "request_headers_to_add": (("list", ("obj", "AppendedHeader")),
                                   False),
        "cors": (("obj", "CORSPolicy"), False),
        "decorator": (("obj", "Decorator"), False),
    },
    "Runtime": {"key": (S, True), "default": (I, True)},
    "Decorator": {"operation": (S, True)},
    "Header": {
        "name": (S, True),
        "value": (S, True),
        "regex": (B, False),
    },
    "AppendedHeader": {"key": (S, True), "value": (S, True)},
    "RetryPolicy": {
        "retry_on": (S, True),
        "num_retries": (I, False),
        "per_try_timeout_ms": (F, False),
    },
    "ShadowCluster": {"cluster": (S, True)},
    "WeightedCluster": {
        "clusters": (("list", ("obj", "WeightedClusterEntry")), True),
        "runtime_key_prefix": (S, False),
    },
    "WeightedClusterEntry": {"name": (S, True), "weight": (I, True)},
    "CORSPolicy": {
        "enabled": (B, False),
        "allow_credentials": (B, False),
        "allow_methods": (S, False),
        "allow_headers": (S, False),
        "expose_headers": (S, False),
        "max_age": (S, False),
        "allow_origin": (("list", S), False),
    },
    # resources.go:695-712 Cluster
    "Cluster": {
        "name": (S, True),
        "service_name": (S, False),
        "connect_timeout_ms": (F, True),
        "type": (CLUSTER_TYPES, True),
        "lb_type": (LB_TYPES, True),
        "max_requests_per_connection": (I, False),
        "hosts": (("list", ("obj", "Host")), False),
        "ssl_context": ("any", False),
        "features": (_enum("http2"), False),
        "circuit_breakers": (("obj", "CircuitBreaker"), False),
        "outlier_detection": (("obj", "OutlierDetection"), False),
    },
    "Host": {"url": (S, True)},
    "CircuitBreaker": {"default": (("obj", "DefaultCBPriority"), True)},
    "DefaultCBPriority": {
        "max_connections": (I, False),
        "max_pending_requests": (I, False),
        "max_requests": (I, False),
        "max_retries": (I, False),
    },
    "OutlierDetection": {
        "consecutive_5xx": (I, False),
        "interval_ms": (F, False),
        "base_ejection_time_ms": (F, False),
        "max_ejection_percent": (I, False),
    },
    # resources.go:573-601 TCP/Mongo/Redis filter configs
    "TCPProxyFilterConfig": {
        "stat_prefix": (S, True),
        "route_config": (("obj", "TCPRouteConfig"), True),
    },
    "TCPRouteConfig": {"routes": (("list", ("obj", "TCPRoute")), True)},
    "TCPRoute": {
        "cluster": (S, True),
        "destination_ip_list": (("list", S), False),
        "destination_ports": (S, False),
        "source_ip_list": (("list", S), False),
        "source_ports": (S, False),
    },
    "MongoProxyFilterConfig": {
        "stat_prefix": (S, True),
        "access_log": (S, False),
    },
    "RedisProxyFilterConfig": {
        "cluster_name": (S, True),
        "conn_pool": (("obj", "RedisConnPool"), True),
        "stat_prefix": (S, True),
    },
    "RedisConnPool": {"op_timeout_ms": (F, True)},
    "FaultFilterConfig": {
        "abort": (("obj", "AbortFilter"), False),
        "delay": (("obj", "DelayFilter"), False),
        "headers": (("list", ("obj", "Header")), False),
        "upstream_cluster": (S, False),
    },
    "AbortFilter": {
        "abort_percent": (I, False),
        "http_status": (I, False),
    },
    "DelayFilter": {
        "type": (_enum("fixed"), False),
        "fixed_delay_percent": (I, False),
        "fixed_duration_ms": (F, False),
    },
    "RouterFilterConfig": {"dynamic_stats": (B, False)},
}

# network-filter name → config schema (resources.go:86-98 + filters)
NETWORK_FILTER_CONFIGS = {
    "http_connection_manager": "HTTPFilterConfig",
    "tcp_proxy": "TCPProxyFilterConfig",
    "mongo_proxy": "MongoProxyFilterConfig",
    "redis_proxy": "RedisProxyFilterConfig",
}

# HTTP-filter name → config schema; mixer/auth configs are opaque
# (their shapes belong to other protos)
HTTP_FILTER_CONFIGS = {
    "router": "RouterFilterConfig",
    "fault": "FaultFilterConfig",
    "cors": None,       # empty config
    "mixer": None,
    "jwt-auth": None,
}


def _type_name(t: Any) -> str:
    if t is S:
        return "string"
    if t is I:
        return "int"
    if t is B:
        return "bool"
    if t == F:
        return "int"
    if isinstance(t, tuple):
        return t[0]
    return str(t)


def _check(value: Any, t: Any, path: str) -> None:
    if t == "any":
        return
    if t is S:
        if not isinstance(value, str):
            raise EnvoySchemaError(f"{path}: expected string, got "
                                   f"{type(value).__name__}")
        return
    if t is B:
        if not isinstance(value, bool):
            raise EnvoySchemaError(f"{path}: expected bool")
        return
    if t is I:
        if isinstance(value, bool) or not isinstance(value, int):
            raise EnvoySchemaError(f"{path}: expected int")
        return
    if t == F:
        if isinstance(value, bool) or not isinstance(value, (int, float)) \
                or (isinstance(value, float)
                    and not value.is_integer()):
            raise EnvoySchemaError(f"{path}: expected integral number")
        return
    kind = t[0]
    if kind == "enum":
        if value not in t[1]:
            raise EnvoySchemaError(
                f"{path}: {value!r} not in {sorted(t[1])}")
        return
    if kind == "list":
        if not isinstance(value, list):
            raise EnvoySchemaError(f"{path}: expected list")
        for i, item in enumerate(value):
            _check(item, t[1], f"{path}[{i}]")
        return
    if kind == "map":
        if not isinstance(value, Mapping):
            raise EnvoySchemaError(f"{path}: expected object")
        for k, v in value.items():
            _check(v, t[1], f"{path}.{k}")
        return
    if kind == "obj":
        validate(value, t[1], path)
        return
    raise AssertionError(f"bad schema type {t!r}")


def validate(obj: Any, schema: str, path: str = "$") -> None:
    """Validate `obj` against SCHEMAS[schema]; raises EnvoySchemaError
    naming the offending path. Unknown fields are ERRORS (a real Envoy
    v1 loader rejects unknown keys in --v2-config-only=false mode and
    silently ignoring them hides generator typos)."""
    spec = SCHEMAS[schema]
    if not isinstance(obj, Mapping):
        raise EnvoySchemaError(f"{path}: expected {schema} object, got "
                               f"{type(obj).__name__}")
    unknown = set(obj) - set(spec)
    if unknown:
        raise EnvoySchemaError(
            f"{path}: unknown {schema} field(s) {sorted(unknown)}")
    for field, (ftype, required) in spec.items():
        if field not in obj:
            if required:
                raise EnvoySchemaError(
                    f"{path}: missing required {schema}.{field}")
            continue
        _check(obj[field], ftype, f"{path}.{field}")
    if schema == "NetworkFilter":
        _validate_network_filter(obj, path)
    if schema == "HTTPFilter":
        _validate_http_filter(obj, path)
    if schema == "HTTPRoute":
        _validate_http_route(obj, path)


def _validate_network_filter(obj: Mapping, path: str) -> None:
    name = obj.get("name", "")
    sub = NETWORK_FILTER_CONFIGS.get(name)
    if sub is None:
        raise EnvoySchemaError(
            f"{path}: unknown network filter {name!r} "
            f"(known: {sorted(NETWORK_FILTER_CONFIGS)})")
    validate(obj.get("config", {}), sub, f"{path}.config")


def _validate_http_filter(obj: Mapping, path: str) -> None:
    name = obj.get("name", "")
    if name not in HTTP_FILTER_CONFIGS:
        raise EnvoySchemaError(
            f"{path}: unknown HTTP filter {name!r} "
            f"(known: {sorted(HTTP_FILTER_CONFIGS)})")
    sub = HTTP_FILTER_CONFIGS[name]
    if sub is not None:
        validate(obj.get("config", {}), sub, f"{path}.config")


def _validate_http_route(obj: Mapping, path: str) -> None:
    """Route invariants route.go relies on: a route is a redirect OR
    forwards to exactly one of cluster/weighted_clusters."""
    redirect = bool(obj.get("host_redirect") or obj.get("path_redirect"))
    has_cluster = "cluster" in obj
    has_weighted = "weighted_clusters" in obj
    if redirect and (has_cluster or has_weighted):
        raise EnvoySchemaError(
            f"{path}: redirect routes must not name clusters")
    if not redirect and has_cluster == has_weighted:
        raise EnvoySchemaError(
            f"{path}: exactly one of cluster/weighted_clusters "
            "is required")
    matchers = [m for m in ("path", "prefix", "regex") if m in obj]
    if len(matchers) > 1:
        raise EnvoySchemaError(
            f"{path}: at most one of path/prefix/regex ({matchers})")


# -- entry points the goldens/tests use ------------------------------

def validate_listeners(listeners: list) -> None:
    for i, l in enumerate(listeners):
        validate(l, "Listener", f"$.listeners[{i}]")


def validate_clusters(clusters: list) -> None:
    for i, c in enumerate(clusters):
        validate(c, "Cluster", f"$.clusters[{i}]")


def validate_route_config(rc: Mapping) -> None:
    validate(rc, "HTTPRouteConfig", "$.route_config")


def validate_bootstrap(cfg: Mapping) -> None:
    validate(cfg, "Config", "$")
