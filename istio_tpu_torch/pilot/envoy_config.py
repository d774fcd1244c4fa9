"""Envoy v1 bootstrap/listener/cluster generation.

Reference: pilot/pkg/proxy/envoy/config.go — BuildConfig (:81,
bootstrap with RDS/admin/tracing/mixer cluster), buildListeners (:136),
sidecar in/outbound (:199,:496,:707); policy.go applyClusterPolicy
(:39: circuit breakers :179, outlier detection :152, LB :128);
mixer.go FilterMixerConfig (:82); resources.go JSON shapes.

The port's copy of istio_tpu/pilot/envoy_config.py, unchanged but for its
imports: standard library only, nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

from istio_tpu_torch.pilot.model import (IstioConfigStore, Port, Service,
                                   ServiceInstance)
from istio_tpu_torch.pilot.registry import ServiceDiscovery
from istio_tpu_torch.pilot.routes import (_egress_rule_ports,
                                    build_ingress_route_config,
                                    build_route_config, cluster_name,
                                    egress_cluster_name,
                                    inbound_cluster_name, default_route,
                                    build_fault_filter)

DEFAULT_ADMIN_PORT = 15000
DEFAULT_DISCOVERY_REFRESH_MS = 1000


# ---------------------------------------------------------------------------
# clusters
# ---------------------------------------------------------------------------

def build_outbound_clusters(services: Sequence[Service],
                            config_store: IstioConfigStore
                            ) -> list[dict[str, Any]]:
    clusters: dict[str, dict[str, Any]] = {}
    for service in services:
        # rule scan is port-independent — hoisted out of the port loop
        label_sets: list[Mapping[str, str] | None] = [None]
        for rule in config_store.route_rules(service.hostname):
            for block in rule.spec.get("route", ()):
                labels = block.get("labels") or block.get("tags")
                if labels:
                    label_sets.append(labels)
            if rule.spec.get("mirror", {}).get("labels"):
                label_sets.append(rule.spec["mirror"]["labels"])
        policy = config_store.destination_policy(service.hostname)
        for port in service.ports:
            for labels in label_sets:
                name = cluster_name(service.hostname, port, labels)
                if name in clusters:
                    continue
                cluster: dict[str, Any] = {
                    "name": name,
                    "type": "sds",
                    "service_name": service.key(port) + (
                        "|" + ",".join(f"{k}={v}" for k, v in
                                       sorted(labels.items()))
                        if labels else ""),
                    "lb_type": "round_robin",
                    "connect_timeout_ms": 1000,
                }
                if port.protocol in ("HTTP2", "GRPC"):
                    cluster["features"] = "http2"
                _apply_cluster_policy(cluster, policy)
                clusters[name] = cluster
    return [clusters[k] for k in sorted(clusters)]


def _apply_cluster_policy(cluster: dict[str, Any],
                          policy: "Any | None") -> None:
    """policy.go:39 applyClusterPolicy."""
    if policy is None:
        return
    lb = policy.spec.get("loadBalancing", {})
    if lb.get("name"):
        cluster["lb_type"] = {"ROUND_ROBIN": "round_robin",
                              "LEAST_CONN": "least_request",
                              "RANDOM": "random"}.get(lb["name"],
                                                      "round_robin")
    cb = policy.spec.get("circuitBreaker", {}).get("simpleCb", {})
    if cb:
        thresholds: dict[str, Any] = {}
        if "maxConnections" in cb:
            thresholds["max_connections"] = int(cb["maxConnections"])
        if "httpMaxPendingRequests" in cb:
            thresholds["max_pending_requests"] = \
                int(cb["httpMaxPendingRequests"])
        if "httpMaxRequests" in cb:
            thresholds["max_requests"] = int(cb["httpMaxRequests"])
        if "httpMaxRetries" in cb:
            thresholds["max_retries"] = int(cb["httpMaxRetries"])
        cluster["circuit_breakers"] = {"default": thresholds}
        outlier: dict[str, Any] = {}
        if "httpConsecutiveErrors" in cb:
            outlier["consecutive_5xx"] = int(cb["httpConsecutiveErrors"])
        if "httpDetectionInterval" in cb:
            iv = cb["httpDetectionInterval"]
            outlier["interval_ms"] = int(float(str(iv).rstrip("s")) * 1000)
        if "sleepWindow" in cb:
            sw = cb["sleepWindow"]
            outlier["base_ejection_time_ms"] = \
                int(float(str(sw).rstrip("s")) * 1000)
        if outlier:
            cluster["outlier_detection"] = outlier


def build_egress_clusters(config_store: IstioConfigStore
                          ) -> list[dict[str, Any]]:
    """config.go:849-1026: one cluster per (egress rule, port). Exact
    hosts resolve via strict_dns with TLS upstream for https ports;
    wildcard hosts use original-destination (the sidecar already knows
    the resolved address)."""
    clusters: dict[str, dict[str, Any]] = {}
    for rule in config_store.egress_rules():
        host = str(rule.spec.get("destination", {}).get("service", ""))
        tls = bool(rule.spec.get("useEgressProxy", False))
        for pnum, proto in _egress_rule_ports(rule):
            name = egress_cluster_name(host, pnum)
            if name in clusters:
                continue
            if host.startswith("*"):
                cluster: dict[str, Any] = {
                    "name": name, "type": "original_dst",
                    "lb_type": "original_dst_lb",
                    "connect_timeout_ms": 1000}
            else:
                cluster = {"name": name, "type": "strict_dns",
                           "lb_type": "round_robin",
                           "connect_timeout_ms": 1000,
                           "hosts": [{"url": f"tcp://{host}:{pnum}"}]}
            if proto in ("https",) or tls:
                cluster["ssl_context"] = {}
            if proto in ("http2", "grpc"):
                cluster["features"] = "http2"
            clusters[name] = cluster
    return [clusters[k] for k in sorted(clusters)]


def build_jwks_clusters(config_store: IstioConfigStore
                        ) -> list[dict[str, Any]]:
    """mixer.go:301-331 buildJwksURIClustersForProxyConfig: each JWT
    issuer's jwks_uri needs an upstream cluster so the auth filter can
    fetch signing keys."""
    from urllib.parse import urlparse
    clusters: dict[str, dict[str, Any]] = {}
    for config in config_store.store.list(
            "end-user-authentication-policy-spec"):
        for jwt in config.spec.get("jwts", ()):
            uri = str(jwt.get("jwksUri", jwt.get("jwks_uri", "")) or "")
            if not uri:
                continue
            parsed = urlparse(uri)
            if not parsed.hostname:
                continue
            secure = parsed.scheme == "https"
            port = parsed.port or (443 if secure else 80)
            name = f"jwks.{parsed.hostname}|{port}"
            cluster: dict[str, Any] = {
                "name": name, "type": "strict_dns",
                "lb_type": "round_robin", "connect_timeout_ms": 1000,
                "hosts": [{"url": f"tcp://{parsed.hostname}:{port}"}]}
            if secure:
                cluster["ssl_context"] = {}
            clusters[name] = cluster
    return [clusters[k] for k in sorted(clusters)]


def build_inbound_clusters(instances: Sequence[ServiceInstance]
                           ) -> list[dict[str, Any]]:
    clusters = {}
    for inst in instances:
        name = inbound_cluster_name(inst.endpoint.port)
        clusters[name] = {
            "name": name, "type": "static", "lb_type": "round_robin",
            "connect_timeout_ms": 1000,
            "hosts": [{"url": f"tcp://127.0.0.1:{inst.endpoint.port}"}]}
    return [clusters[k] for k in sorted(clusters)]


# ---------------------------------------------------------------------------
# listeners
# ---------------------------------------------------------------------------

def _http_filters(mesh: Mapping[str, Any],
                  faults: Sequence[dict] = ()) -> list[dict]:
    filters = list(faults)
    if mesh.get("mixer_address"):
        # mixer.go:82 FilterMixerConfig
        filters.append({"type": "decoder", "name": "mixer", "config": {
            "mixer_attributes": {
                "destination.uid": mesh.get("node_uid", ""),
            },
            "forward_attributes": {
                "source.uid": mesh.get("node_uid", ""),
            },
            "quota_name": "RequestCount",
        }})
    filters.append({"type": "decoder", "name": "router", "config": {}})
    return filters


def _port_fault_filters(port_num: int, services: Sequence[Service],
                        config_store: IstioConfigStore) -> list[dict]:
    """Fault filters for route-rules with httpFault on services exposed
    on this port, scoped by the rule's match headers (fault.go:28-139
    buildFaultFilters — faults live in the filter chain, not routes)."""
    from istio_tpu_torch.pilot.routes import build_route_match
    faults = []
    for service in services:
        if not any(p.port == port_num and p.is_http
                   for p in service.ports):
            continue
        for rule in config_store.route_rules(service.hostname):
            fault_spec = rule.spec.get("httpFault")
            if not fault_spec:
                continue
            match = build_route_match(rule.spec.get("match"))
            headers = list(match.get("headers", ()))
            filt = build_fault_filter(fault_spec, headers)
            if filt is not None:
                filt["config"]["upstream_cluster"] = cluster_name(
                    service.hostname,
                    next(p for p in service.ports
                         if p.port == port_num and p.is_http))
                faults.append(filt)
    return faults


def _listener_kind(port: Port) -> str:
    if port.is_http:
        return "http"
    if port.protocol == "REDIS":
        return "redis"   # redis_proxy replaces tcp_proxy: exclusive
    return "tcp"         # MONGO = tcp + passive sniffer


def build_outbound_listeners(services: Sequence[Service],
                             config_store: IstioConfigStore,
                             mesh: Mapping[str, Any]) -> list[dict]:
    """One HTTP listener per outbound port using RDS; TCP services get
    tcp_proxy with explicit routes (config.go:496); egress rules add
    listeners for their ports even when no in-mesh service shares them
    (config.go:849-1026 — otherwise egress traffic is blackholed)."""
    import logging
    plog = logging.getLogger("istio_tpu_torch.pilot")
    listeners: dict[int, dict[str, Any]] = {}
    kinds: dict[int, str] = {}    # port → http|tcp|redis conflict map

    def claim(port_num: int, kind: str, who: str) -> bool:
        prev = kinds.get(port_num)
        if prev is None:
            kinds[port_num] = kind
            return True
        # redis owns its port exclusively; http vs tcp also conflict —
        # first writer wins, like the reference's conflict logging
        if prev != kind or prev == "redis":
            plog.warning("listener conflict on port %d: %s vs %s "
                         "(%s dropped)", port_num, prev, kind, who)
            return False
        return True

    def http_listener(port_num: int) -> dict[str, Any]:
        return {
            "address": f"tcp://0.0.0.0:{port_num}",
            "name": f"http_0.0.0.0_{port_num}",
            "bind_to_port": True,
            "filters": [{
                "type": "read", "name": "http_connection_manager",
                "config": {
                    "codec_type": "auto",
                    "stat_prefix": "http",
                    "rds": {"cluster": "rds",
                            "route_config_name": str(port_num),
                            "refresh_delay_ms":
                                DEFAULT_DISCOVERY_REFRESH_MS},
                    "filters": _http_filters(
                        mesh, _port_fault_filters(port_num, services,
                                                  config_store)),
                }}],
        }

    def append_tcp_route(entry: dict[str, Any], route: dict) -> None:
        tcp = next(f for f in entry["filters"]
                   if f["name"] == "tcp_proxy")
        tcp["config"]["route_config"]["routes"].append(route)

    for service in services:
        for port in service.ports:
            kind = _listener_kind(port)
            if not claim(port.port, kind, service.hostname):
                continue
            if kind == "http":
                # built once a port (not per service that exposes it):
                # its fault filters scan every service
                if port.port not in listeners:
                    listeners[port.port] = http_listener(port.port)
            elif kind == "redis":
                listeners[port.port] = {
                    "address": f"tcp://0.0.0.0:{port.port}",
                    "name": f"redis_0.0.0.0_{port.port}",
                    "bind_to_port": True,
                    "filters": [{
                        "type": "read", "name": "redis_proxy",
                        "config": {"cluster_name":
                                   cluster_name(service.hostname, port),
                                   "stat_prefix": "redis",
                                   "conn_pool": {"op_timeout_ms":
                                                 30_000}}}]}
            else:
                tcp_route = {"cluster": cluster_name(service.hostname,
                                                     port)}
                if service.address and service.address != "0.0.0.0":
                    tcp_route["destination_ip_list"] = \
                        [f"{service.address}/32"]
                entry = listeners.setdefault(port.port, {
                    "address": f"tcp://0.0.0.0:{port.port}",
                    "name": f"tcp_0.0.0.0_{port.port}",
                    "bind_to_port": True,
                    "filters": [{"type": "read", "name": "tcp_proxy",
                                 "config": {"stat_prefix": "tcp",
                                            "route_config":
                                                {"routes": []}}}]})
                append_tcp_route(entry, tcp_route)
                if port.protocol == "MONGO" and not any(
                        f["name"] == "mongo_proxy"
                        for f in entry["filters"]):
                    # passive sniffer ahead of tcp_proxy
                    # (resources.go:516-613)
                    entry["filters"].insert(0, {
                        "type": "both", "name": "mongo_proxy",
                        "config": {"stat_prefix": "mongo"}})

    # egress ports: http rides RDS (the route table carries the egress
    # virtual hosts); https/tcp egress forwards raw bytes to the
    # external cluster
    for rule in config_store.egress_rules():
        host = str(rule.spec.get("destination", {}).get("service", ""))
        for pnum, proto in _egress_rule_ports(rule):
            if proto in ("http", "http2", "grpc"):
                if claim(pnum, "http", f"egress {host}") and \
                        pnum not in listeners:
                    listeners[pnum] = http_listener(pnum)
            else:
                if not claim(pnum, "tcp", f"egress {host}"):
                    continue
                entry = listeners.setdefault(pnum, {
                    "address": f"tcp://0.0.0.0:{pnum}",
                    "name": f"tcp_0.0.0.0_{pnum}",
                    "bind_to_port": True,
                    "filters": [{"type": "read", "name": "tcp_proxy",
                                 "config": {"stat_prefix": "tcp",
                                            "route_config":
                                                {"routes": []}}}]})
                append_tcp_route(entry,
                                 {"cluster": egress_cluster_name(host,
                                                                 pnum)})
    return [listeners[k] for k in sorted(listeners)]


def build_inbound_listeners(instances: Sequence[ServiceInstance],
                            mesh: Mapping[str, Any]) -> list[dict]:
    """Per-endpoint-port inbound listeners (config.go:707)."""
    listeners = {}
    for inst in instances:
        port = inst.endpoint.port
        if port in listeners:
            continue
        sp = inst.endpoint.service_port
        if sp.is_http:
            vhost = {"name": "inbound", "domains": ["*"], "routes": [
                {"prefix": "/", "cluster": inbound_cluster_name(port),
                 "timeout_ms": 0}]}
            listeners[port] = {
                "address": f"tcp://{inst.endpoint.address}:{port}",
                "name": f"http_{inst.endpoint.address}_{port}",
                "bind_to_port": True,
                "filters": [{
                    "type": "read", "name": "http_connection_manager",
                    "config": {"codec_type": "auto",
                               "stat_prefix": "http",
                               "route_config": {"virtual_hosts": [vhost]},
                               "filters": _http_filters(mesh)}}],
            }
        else:
            listeners[port] = {
                "address": f"tcp://{inst.endpoint.address}:{port}",
                "name": f"tcp_{inst.endpoint.address}_{port}",
                "bind_to_port": True,
                "filters": [{"type": "read", "name": "tcp_proxy",
                             "config": {"stat_prefix": "tcp",
                                        "route_config": {"routes": [
                                            {"cluster":
                                             inbound_cluster_name(port)}]}}}]}
    return [listeners[k] for k in sorted(listeners)]


def build_ingress_listeners(config_store: IstioConfigStore, registry,
                            mesh: Mapping[str, Any],
                            tls_context: Mapping[str, Any] | None = None
                            ) -> list[dict]:
    """Ingress proxy listeners on 80/443 (ingress.go buildIngress
    Listeners): the route table comes from ingress-rule configs."""
    route_config = build_ingress_route_config(config_store, registry)
    out = []
    for port, secure in ((80, False), (443, True)):
        if secure and tls_context is None:
            continue
        listener = {
            "address": f"tcp://0.0.0.0:{port}",
            "name": f"ingress_{port}",
            "bind_to_port": True,
            "filters": [{
                "type": "read", "name": "http_connection_manager",
                "config": {"codec_type": "auto",
                           "stat_prefix": "ingress",
                           "route_config": route_config,
                           "filters": _http_filters(mesh)}}],
        }
        if secure:
            ctx = dict(tls_context)
            # always-serialized in resources.go SSLContext — terminating
            # TLS at ingress does not demand client certs by default
            ctx.setdefault("require_client_certificate", False)
            listener["ssl_context"] = ctx
        out.append(listener)
    return out


# ---------------------------------------------------------------------------
# bootstrap (config.go:81 BuildConfig)
# ---------------------------------------------------------------------------

def build_bootstrap(mesh: Mapping[str, Any]) -> dict[str, Any]:
    discovery = mesh.get("discovery_address", "127.0.0.1:8080")
    config: dict[str, Any] = {
        "admin": {"access_log_path": "/dev/stdout",
                  "address": f"tcp://127.0.0.1:"
                             f"{mesh.get('admin_port', DEFAULT_ADMIN_PORT)}"},
        "listeners": [],
        "lds": {"cluster": "lds", "refresh_delay_ms":
                DEFAULT_DISCOVERY_REFRESH_MS},
        "cluster_manager": {
            "clusters": [
                {"name": "rds", "type": "strict_dns",
                 "lb_type": "round_robin", "connect_timeout_ms": 1000,
                 "hosts": [{"url": f"tcp://{discovery}"}]},
                {"name": "lds", "type": "strict_dns",
                 "lb_type": "round_robin", "connect_timeout_ms": 1000,
                 "hosts": [{"url": f"tcp://{discovery}"}]},
            ],
            "sds": {"cluster": {"name": "sds", "type": "strict_dns",
                                "lb_type": "round_robin",
                                "connect_timeout_ms": 1000,
                                "hosts": [{"url": f"tcp://{discovery}"}]},
                    "refresh_delay_ms": DEFAULT_DISCOVERY_REFRESH_MS},
        },
    }
    if mesh.get("mixer_address"):
        config["cluster_manager"]["clusters"].append(
            {"name": "mixer_server", "type": "strict_dns",
             "lb_type": "round_robin", "connect_timeout_ms": 1000,
             "features": "http2",
             "hosts": [{"url": f"tcp://{mesh['mixer_address']}"}]})
    if mesh.get("zipkin_address"):
        # route.go:534 buildZipkinTracing
        config["tracing"] = {"http": {"driver": {
            "type": "zipkin",
            "config": {"collector_cluster": "zipkin",
                       "collector_endpoint": "/api/v1/spans"}}}}
        config["cluster_manager"]["clusters"].append(
            {"name": "zipkin", "type": "strict_dns",
             "lb_type": "round_robin", "connect_timeout_ms": 1000,
             "hosts": [{"url": f"tcp://{mesh['zipkin_address']}"}]})
    return config
