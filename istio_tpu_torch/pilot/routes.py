"""Route compiler: route-rule configs → Envoy v1 route JSON.

Reference: pilot/pkg/proxy/envoy/route.go (buildHTTPRouteV1 :192,
virtual hosts :553, weighted clusters, shadow :463, CORS :484, retry
:443), header.go (buildHTTPRouteMatch :27 — URI exact/prefix/regex +
header matches), fault.go (:28-139), policy.go (applyClusterPolicy
:39). Output dicts serialize to the Envoy v1 JSON API shapes
(resources.go:264 HTTPRoute, :386 VirtualHost, :401 HTTPRouteConfig,
:695 Cluster).

The port's copy of istio_tpu/pilot/routes.py, unchanged but for its
imports: standard library only, nothing of the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

from istio_tpu_torch.pilot.model import (Config, IstioConfigStore, Port, Service)

DEFAULT_TIMEOUT_MS = 15_000


# ---------------------------------------------------------------------------
# cluster naming (route.go buildClusterName discipline)
# ---------------------------------------------------------------------------

def cluster_name(hostname: str, port: Port,
                 labels: Mapping[str, str] | None = None) -> str:
    tag = ",".join(f"{k}={v}" for k, v in sorted((labels or {}).items()))
    base = f"out.{hostname}|{port.name}"
    return f"{base}|{tag}" if tag else base


def inbound_cluster_name(port: int) -> str:
    return f"in.{port}"


# ---------------------------------------------------------------------------
# match translation (header.go:27 buildHTTPRouteMatch)
# ---------------------------------------------------------------------------

def build_route_match(match: Mapping[str, Any] | None) -> dict[str, Any]:
    """Translate a route-rule match block to HTTPRoute match fields.
    URI schemes: exact/prefix/regex; headers likewise (exact value is
    `value`, regex via `regex: true`)."""
    out: dict[str, Any] = {"prefix": "/"}
    headers: list[dict[str, Any]] = []
    if not match:
        return out
    request = match.get("request", {}).get("headers", {}) \
        if "request" in match else match.get("headers", {}) or {}
    for name, cond in sorted(request.items()):
        cond = cond or {}   # null header condition = presence match
        if name == "uri":
            # exactly one of prefix/path/regex must survive — a bare
            # presence match keeps the default catch-all prefix
            if "exact" in cond:
                out.pop("prefix", None)
                out["path"] = cond["exact"]
            elif "prefix" in cond:
                out["prefix"] = cond["prefix"]
            elif "regex" in cond:
                out.pop("prefix", None)
                out["regex"] = cond["regex"]
        else:
            h: dict[str, Any] = {"name": name}
            if "exact" in cond:
                h["value"] = cond["exact"]
            elif "prefix" in cond:
                h["value"] = f"^{_re_escape(cond['prefix'])}.*"
                h["regex"] = True
            elif "regex" in cond:
                h["value"] = cond["regex"]
                h["regex"] = True
            elif "presence" in cond or cond in ({}, None):
                h["value"] = ".*"
                h["regex"] = True
            headers.append(h)
    if headers:
        out["headers"] = headers
    return out


def _re_escape(s: str) -> str:
    import re
    return re.escape(s)


# ---------------------------------------------------------------------------
# faults (fault.go:28-139)
# ---------------------------------------------------------------------------

def build_fault_filter(fault: Mapping[str, Any],
                       headers: Sequence[Mapping[str, Any]] = ()
                       ) -> dict[str, Any] | None:
    if not fault:
        return None
    config: dict[str, Any] = {"upstream_cluster": ""}
    abort = fault.get("abort", {})
    if abort:
        config["abort"] = {
            "abort_percent": int(float(abort.get("percent", 100))),
            "http_status": int(abort.get("httpStatus",
                                         abort.get("http_status", 503)))}
    delay = fault.get("delay", {})
    if delay:
        seconds = delay.get("fixedDelay",
                            delay.get("fixed_delay_seconds", "0s"))
        if isinstance(seconds, str) and seconds.endswith("s"):
            ms = int(float(seconds[:-1]) * 1000)
        else:
            ms = int(float(seconds) * 1000)
        config["delay"] = {"type": "fixed",
                           "fixed_delay_percent":
                               int(float(delay.get("percent", 100))),
                           "fixed_duration_ms": ms}
    if headers:
        config["headers"] = list(headers)
    return {"type": "decoder", "name": "fault", "config": config} \
        if ("abort" in config or "delay" in config) else None


# ---------------------------------------------------------------------------
# routes (route.go:192 buildHTTPRouteV1)
# ---------------------------------------------------------------------------

def build_http_route(rule: Config, service: Service,
                     port: Port) -> dict[str, Any]:
    spec = rule.spec
    route: dict[str, Any] = dict(build_route_match(spec.get("match")))
    route["timeout_ms"] = _timeout_ms(spec)

    blocks = spec.get("route", ())
    if spec.get("redirect"):
        rd = spec["redirect"]
        if rd.get("uri"):
            route["path_redirect"] = rd["uri"]
        if rd.get("authority"):
            route["host_redirect"] = rd["authority"]
    elif len(blocks) == 1 or not blocks:
        block = blocks[0] if blocks else {}
        route["cluster"] = cluster_name(service.hostname, port,
                                        block.get("labels") or
                                        block.get("tags"))
    else:
        route["weighted_clusters"] = {"clusters": [
            {"name": cluster_name(service.hostname, port,
                                  b.get("labels") or b.get("tags")),
             "weight": int(b.get("weight", 0))} for b in blocks]}

    if spec.get("rewrite"):
        rw = spec["rewrite"]
        if rw.get("uri"):
            route["prefix_rewrite"] = rw["uri"]
        if rw.get("authority"):
            route["host_rewrite"] = rw["authority"]
    if spec.get("httpReqRetries"):
        attempts = spec["httpReqRetries"].get("simpleRetry", {}) \
            .get("attempts", 0)
        route["retry_policy"] = {"retry_on": "5xx,connect-failure,refused-stream",
                                 "num_retries": int(attempts)}
    if spec.get("mirror"):
        route["shadow"] = {"cluster": cluster_name(
            service.hostname, port, spec["mirror"].get("labels"))}
    if spec.get("corsPolicy"):
        cp = spec["corsPolicy"]
        route["cors"] = {k: v for k, v in {
            "allow_origin": cp.get("allowOrigin"),
            "allow_methods": ",".join(cp.get("allowMethods", ())) or None,
            "allow_headers": ",".join(cp.get("allowHeaders", ())) or None,
            "allow_credentials": cp.get("allowCredentials"),
            "max_age": cp.get("maxAge"),
        }.items() if v is not None}
    if spec.get("websocketUpgrade"):
        route["use_websocket"] = True
    if spec.get("appendHeaders"):
        route["request_headers_to_add"] = [
            {"key": k, "value": v}
            for k, v in sorted(spec["appendHeaders"].items())]
    return route


def _timeout_ms(spec: Mapping[str, Any]) -> int:
    t = spec.get("httpReqTimeout", {}).get("simpleTimeout", {}) \
        .get("timeout")
    if t is None:
        return DEFAULT_TIMEOUT_MS
    if isinstance(t, str) and t.endswith("s"):
        return int(float(t[:-1]) * 1000)
    return int(float(t) * 1000)


def default_route(service: Service, port: Port) -> dict[str, Any]:
    return {"prefix": "/", "cluster": cluster_name(service.hostname, port),
            "timeout_ms": DEFAULT_TIMEOUT_MS}


# ---------------------------------------------------------------------------
# virtual hosts + route config (route.go:553 buildVirtualHost, :314)
# ---------------------------------------------------------------------------

def service_domains(service: Service, port: Port,
                    domain_suffix: str = "cluster.local") -> list[str]:
    """All names a sidecar may use for the service (short name, fqdn,
    with/without port — route.go buildVirtualHost domain set)."""
    host = service.hostname
    parts = host.split(".")
    domains = [host, f"{host}:{port.port}"]
    if len(parts) > 2 and host.endswith(domain_suffix):
        short = parts[0]
        ns = f"{parts[0]}.{parts[1]}"
        svc_ns = f"{parts[0]}.{parts[1]}.svc"
        for d in (short, ns, svc_ns):
            domains += [d, f"{d}:{port.port}"]
    if service.address and service.address != "0.0.0.0":
        domains += [service.address, f"{service.address}:{port.port}"]
    return domains


def build_virtual_host_from_rules(service: Service, port: Port,
                                  rules: Sequence[Config]
                                  ) -> dict[str, Any]:
    """Virtual-host assembly from an ALREADY-FILTERED, precedence-
    sorted rule list — the single home shared by the live query path
    (build_virtual_host) and the snapshot serving plane
    (pilot/discovery.py), so scoped/batched generation stays
    byte-identical to direct generation by construction."""
    routes = [build_http_route(rule, service, port) for rule in rules]
    routes.append(default_route(service, port))
    return {"name": f"{service.hostname}|{port.name}",
            "domains": service_domains(service, port),
            "routes": routes}


def build_virtual_host(service: Service, port: Port,
                       config_store: IstioConfigStore,
                       source: str | None = None,
                       source_labels: Mapping[str, str] | None = None
                       ) -> dict[str, Any]:
    return build_virtual_host_from_rules(
        service, port,
        config_store.route_rules(service.hostname, source,
                                 source_labels))


def build_route_config(services: Sequence[Service], port_num: int,
                       config_store: IstioConfigStore,
                       source: str | None = None) -> dict[str, Any]:
    """RDS payload for one outbound port (config.go:288 buildRDSRoute);
    egress virtual hosts for the port ride the same route table
    (config.go:849-1026 — external domains resolve per-sidecar)."""
    vhosts = []
    for service in services:
        for port in service.ports:
            if port.port == port_num and port.is_http:
                vhosts.append(build_virtual_host(service, port,
                                                 config_store, source))
    vhosts.extend(build_egress_virtual_hosts(config_store, port_num))
    vhosts.sort(key=lambda v: v["name"])
    return {"virtual_hosts": vhosts,
            "validate_clusters": False}


# ---------------------------------------------------------------------------
# egress (config.go:849-1026)
# ---------------------------------------------------------------------------

def egress_cluster_name(host: str, port_num: int) -> str:
    return f"egress.{host}|{port_num}"


def _egress_rule_ports(rule: Config) -> list[tuple[int, str]]:
    return [(int(p.get("port", 80)),
             str(p.get("protocol", "http")).lower())
            for p in rule.spec.get("ports", ())]


def build_egress_virtual_hosts(config_store: IstioConfigStore,
                               port_num: int) -> list[dict[str, Any]]:
    """One virtual host per egress rule exposing `port_num` over http:
    external domains route to the rule's egress cluster with the
    authority preserved (auto host rewrite for exact hosts)."""
    vhosts: dict[str, dict[str, Any]] = {}
    for rule in config_store.egress_rules():
        host = str(rule.spec.get("destination", {}).get("service", ""))
        for pnum, proto in _egress_rule_ports(rule):
            if pnum != port_num or proto not in ("http", "http2", "grpc"):
                continue
            name = f"egress|{host}|{pnum}"
            if name in vhosts:
                continue   # rules sharing host+port: envoy rejects
                #            duplicate domains, so dedupe here
            route: dict[str, Any] = {
                "prefix": "/",
                "cluster": egress_cluster_name(host, pnum),
                "timeout_ms": DEFAULT_TIMEOUT_MS,
            }
            if not host.startswith("*"):
                route["auto_host_rewrite"] = True
            vhosts[name] = {"name": name,
                            "domains": [host, f"{host}:{pnum}"],
                            "routes": [route]}
    return [vhosts[k] for k in sorted(vhosts)]


# ---------------------------------------------------------------------------
# ingress (pilot/pkg/proxy/envoy/ingress.go)
# ---------------------------------------------------------------------------

def build_ingress_route_config(config_store: IstioConfigStore,
                               registry) -> dict[str, Any]:
    """Route config for an ingress proxy: ingress-rule configs (as
    emitted by the kube ingress controller or written directly) grouped
    into per-authority virtual hosts routing to the backend service's
    outbound cluster."""
    by_host: dict[str, list[dict[str, Any]]] = {}
    for rule in config_store.ingress_rules():
        spec = rule.spec
        dest = str(spec.get("destination", {}).get("service", ""))
        service = registry.get_service(dest) if registry else None
        port = _resolve_ingress_port(service, spec.get("port"))
        if port is None:
            continue
        match = build_route_match(spec.get("match"))
        authority = "*"
        headers = []
        for h in match.pop("headers", ()):
            if h["name"] == "authority" and not h.get("regex"):
                authority = h["value"]
            else:
                headers.append(h)
        route = dict(match)
        if headers:
            route["headers"] = headers
        route["cluster"] = cluster_name(dest, port)
        route["timeout_ms"] = _timeout_ms(spec)
        by_host.setdefault(authority, []).append(route)
    vhosts = []
    for authority in sorted(by_host):
        domains = ["*"] if authority == "*" else [authority,
                                                  f"{authority}:80",
                                                  f"{authority}:443"]
        # exact-path routes sort before prefix routes (first match wins)
        routes = sorted(by_host[authority],
                        key=lambda r: (0 if "path" in r else 1,
                                       -len(r.get("prefix", ""))))
        vhosts.append({"name": f"ingress|{authority}",
                       "domains": domains, "routes": routes})
    return {"virtual_hosts": vhosts, "validate_clusters": False}


def _resolve_ingress_port(service: Service | None,
                          port_ref: Any) -> Port | None:
    if service is None:
        return None
    if isinstance(port_ref, str) and not port_ref.isdigit():
        return service.port_by_name(port_ref)
    try:
        num = int(port_ref)
    except (TypeError, ValueError):
        return None
    for p in service.ports:
        if p.port == num:
            return p
    return None
