"""Pilot abstract model: services, instances, config resources.

Reference: pilot/pkg/model — Service (service.go:44), NetworkEndpoint
(:170), ServiceInstance (:211), Config/ConfigMeta (config.go:34-108),
ConfigStore (:110), ProtoSchema registry `IstioConfigTypes`
(config.go:407-418), IstioConfigStore queries (:227-265), and per-kind
validation (validation.go). Specs are plain dicts validated per kind
(the reference validates protobufs; the shapes match the v1alpha1/2
route-rule schemas so reference YAML translates 1:1).

The port's copy of istio_tpu/pilot/model.py, unchanged but for its
imports: standard library only, nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import re
import threading
from typing import Any, Callable, Iterable, Mapping, Sequence


class ValidationError(ValueError):
    pass


# ---------------------------------------------------------------------------
# services
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Port:
    """service.go:96 Port{Name, Port, Protocol}."""
    name: str
    port: int
    protocol: str = "HTTP"   # HTTP|HTTPS|HTTP2|GRPC|TCP|UDP|MONGO|REDIS

    @property
    def is_http(self) -> bool:
        return self.protocol in ("HTTP", "HTTP2", "GRPC", "HTTPS")


@dataclasses.dataclass(frozen=True)
class Service:
    """service.go:44 Service{Hostname, Address, Ports, ...}."""
    hostname: str
    address: str = "0.0.0.0"
    ports: tuple[Port, ...] = ()
    external_name: str = ""       # ExternalName for mesh-external
    service_account: str = ""

    @property
    def namespace(self) -> str:
        parts = self.hostname.split(".")
        return parts[1] if len(parts) > 1 else ""

    def port_by_name(self, name: str) -> Port | None:
        for p in self.ports:
            if p.name == name:
                return p
        return None

    def key(self, port: Port) -> str:
        return f"{self.hostname}|{port.name}"


@dataclasses.dataclass(frozen=True)
class NetworkEndpoint:
    """service.go:170 — one addressable instance port."""
    address: str
    port: int
    service_port: Port


@dataclasses.dataclass(frozen=True)
class ServiceInstance:
    """service.go:211 — endpoint + owning service + labels."""
    endpoint: NetworkEndpoint
    service: Service
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    availability_zone: str = ""
    service_account: str = ""


# ---------------------------------------------------------------------------
# config resources
# ---------------------------------------------------------------------------

NODE_SIDECAR = "sidecar"
NODE_INGRESS = "ingress"
NODE_ROUTER = "router"


@dataclasses.dataclass(frozen=True)
class Node:
    """context.go:51 Node{Type, IPAddress, ID, Domain} — the proxy
    role; the discovery node-id convention is `type~ip~id~domain`."""
    type: str = NODE_SIDECAR
    ip_address: str = ""
    id: str = ""
    domain: str = "cluster.local"

    @classmethod
    def parse(cls, service_node: str) -> "Node":
        parts = service_node.split("~")
        if parts[0] in (NODE_SIDECAR, NODE_INGRESS, NODE_ROUTER):
            return cls(type=parts[0],
                       ip_address=parts[1] if len(parts) > 1 else "",
                       id=parts[2] if len(parts) > 2 else "",
                       domain=parts[3] if len(parts) > 3
                       else "cluster.local")
        # legacy bare-IP node ids read as sidecars
        return cls(type=NODE_SIDECAR, ip_address=parts[0])

    @property
    def service_node(self) -> str:
        return "~".join([self.type, self.ip_address, self.id,
                         self.domain])


@dataclasses.dataclass(frozen=True)
class ConfigMeta:
    """config.go:34 ConfigMeta."""
    type: str
    name: str
    namespace: str = ""
    domain: str = "cluster.local"
    labels: Mapping[str, str] = dataclasses.field(default_factory=dict)
    annotations: Mapping[str, str] = dataclasses.field(default_factory=dict)
    resource_version: str = ""


@dataclasses.dataclass(frozen=True)
class Config:
    meta: ConfigMeta
    spec: Mapping[str, Any]

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.meta.type, self.meta.namespace, self.meta.name)


@dataclasses.dataclass(frozen=True)
class ProtoSchema:
    """config.go:181 — type descriptor + validator."""
    type: str
    plural: str
    validate: Callable[[Mapping[str, Any]], None]


def _check_percent(value: Any, what: str) -> None:
    try:
        p = float(value)
    except (TypeError, ValueError):
        raise ValidationError(f"{what}: percent not a number: {value!r}")
    if not 0 <= p <= 100:
        raise ValidationError(f"{what}: percent {p} out of [0, 100]")


def _check_duration(value: Any, what: str) -> None:
    """Go-style duration strings ('5s', '100ms') or plain seconds."""
    if isinstance(value, (int, float)):
        seconds = float(value)
    else:
        s = str(value)
        try:
            if s.endswith("ms"):
                seconds = float(s[:-2]) / 1000
            elif s.endswith("s"):
                seconds = float(s[:-1])
            else:
                seconds = float(s)
        except ValueError:
            raise ValidationError(f"{what}: bad duration {value!r}")
    if seconds < 0:
        raise ValidationError(f"{what}: negative duration {value!r}")


def _check_port_number(value: Any, what: str) -> None:
    try:
        port = int(value)
    except (TypeError, ValueError):
        raise ValidationError(f"{what}: port not a number: {value!r}")
    if not 1 <= port <= 65535:
        raise ValidationError(f"{what}: port {port} out of [1, 65535]")


_MATCH_SCHEMES = {"exact", "prefix", "regex", "presence"}


def _check_match(match: Mapping[str, Any], what: str) -> None:
    """validation.go ValidateMatchCondition: each header condition uses
    exactly one known scheme; conflicting URI schemes rejected."""
    if not match:
        return
    headers = (match.get("request", {}) or {}).get("headers", {}) \
        if "request" in match else match.get("headers", {}) or {}
    if not isinstance(headers, Mapping):
        raise ValidationError(f"{what}: match headers must be a map")
    for name, cond in headers.items():
        if cond in (None, {}):
            continue   # presence match
        if not isinstance(cond, Mapping):
            raise ValidationError(
                f"{what}: header {name} condition must be a map")
        schemes = set(cond) & _MATCH_SCHEMES
        unknown = set(cond) - _MATCH_SCHEMES
        if unknown:
            raise ValidationError(
                f"{what}: header {name} unknown scheme(s) "
                f"{sorted(unknown)}")
        if len(schemes) > 1:
            raise ValidationError(
                f"{what}: header {name} has conflicting schemes "
                f"{sorted(schemes)} (exactly one allowed)")


def _validate_route_rule(spec: Mapping[str, Any]) -> None:
    """validation.go ValidateRouteRule (v1alpha1 shape): the rejection
    set covers weights, percentages, durations, conflicting match
    schemes, redirect/route exclusivity, and port semantics."""
    if not spec.get("destination"):
        raise ValidationError("route-rule: destination required")
    _check_match(spec.get("match") or {}, "route-rule match")
    if spec.get("redirect") and spec.get("route"):
        raise ValidationError(
            "route-rule: redirect and route are mutually exclusive")
    if spec.get("redirect") and spec.get("httpFault"):
        raise ValidationError(
            "route-rule: redirect cannot carry httpFault")
    total = 0
    for r in spec.get("route", ()):
        w = int(r.get("weight", 0))
        if w < 0 or w > 100:
            raise ValidationError("route-rule: weight must be 0-100")
        total += w
    routes = spec.get("route", ())
    if len(routes) > 1 and total != 100:
        raise ValidationError(
            f"route-rule: weights sum to {total}, not 100")
    if len(routes) == 1 and total not in (0, 100):
        raise ValidationError(
            f"route-rule: single-route weight must be 0 or 100, "
            f"got {total}")
    fault = spec.get("httpFault", {})
    if fault:
        abort = fault.get("abort", {})
        if abort:
            _check_percent(abort.get("percent", 0), "route-rule abort")
            status = int(abort.get("httpStatus",
                                   abort.get("http_status", 503)))
            if not 200 <= status <= 599:
                raise ValidationError(
                    f"route-rule: abort httpStatus {status} invalid")
        delay = fault.get("delay", {})
        if delay:
            _check_percent(delay.get("percent", 0), "route-rule delay")
            _check_duration(delay.get("fixedDelay", "0s"),
                            "route-rule delay")
    timeout = spec.get("httpReqTimeout", {}).get("simpleTimeout", {})
    if timeout.get("timeout") is not None:
        _check_duration(timeout["timeout"], "route-rule timeout")
    retries = spec.get("httpReqRetries", {}).get("simpleRetry", {})
    if retries and int(retries.get("attempts", 0)) < 0:
        raise ValidationError("route-rule: negative retry attempts")
    if "precedence" in spec and int(spec["precedence"]) < 0:
        raise ValidationError("route-rule: negative precedence")
    mirror = spec.get("mirror")
    if mirror is not None and not isinstance(mirror, Mapping):
        raise ValidationError("route-rule: mirror must be a message")


def _validate_v1alpha2_route_rule(spec: Mapping[str, Any]) -> None:
    """v1alpha2 RouteRule (hosts + http routes — the VirtualService
    precursor, config.go:312)."""
    if not spec.get("hosts"):
        raise ValidationError("v1alpha2 route-rule: hosts required")
    for http in spec.get("http", ()):
        total = 0
        for route in http.get("route", ()):
            if not route.get("destination"):
                raise ValidationError("v1alpha2: route needs destination")
            total += int(route.get("weight", 0))
        if len(http.get("route", ())) > 1 and total != 100:
            raise ValidationError(
                f"v1alpha2: weights sum to {total}, not 100")


def _validate_destination_policy(spec: Mapping[str, Any]) -> None:
    if not spec.get("destination"):
        raise ValidationError("destination-policy: destination required")
    lb = spec.get("loadBalancing", {})
    if lb.get("name") and lb["name"] not in ("ROUND_ROBIN", "LEAST_CONN",
                                             "RANDOM"):
        raise ValidationError(
            f"destination-policy: unknown LB policy {lb['name']!r}")
    cb = spec.get("circuitBreaker", {}).get("simpleCb", {})
    for k in ("maxConnections", "httpMaxPendingRequests",
              "httpMaxRequests", "httpMaxRetries",
              "httpConsecutiveErrors"):
        if k in cb and int(cb[k]) < 0:
            raise ValidationError(f"destination-policy: negative {k}")
    for k in ("httpDetectionInterval", "sleepWindow"):
        if k in cb:
            _check_duration(cb[k], f"destination-policy {k}")


def _validate_destination_rule(spec: Mapping[str, Any]) -> None:
    if not spec.get("host") and not spec.get("name"):
        raise ValidationError("destination-rule: host required")
    seen = set()
    for subset in spec.get("subsets", ()):
        name = subset.get("name")
        if not name:
            raise ValidationError("destination-rule: subset needs a name")
        if name in seen:
            raise ValidationError(
                f"destination-rule: duplicate subset {name!r}")
        seen.add(name)
        if not subset.get("labels"):
            raise ValidationError(
                f"destination-rule: subset {name!r} needs labels")


def _validate_gateway(spec: Mapping[str, Any]) -> None:
    if not spec.get("servers"):
        raise ValidationError("gateway: servers required")
    for server in spec["servers"]:
        port = server.get("port", {})
        if not port:
            raise ValidationError("gateway: server needs a port")
        _check_port_number(port.get("number", port.get("port")),
                           "gateway server")
        if not server.get("hosts"):
            raise ValidationError("gateway: server needs hosts")


def _validate_ingress_rule(spec: Mapping[str, Any]) -> None:
    if not spec.get("destination"):
        raise ValidationError("ingress-rule: destination required")
    port = spec.get("port")
    if port is None:
        raise ValidationError("ingress-rule: port required")
    # numeric ports (including numeric strings) must be in range;
    # non-numeric strings are named service ports
    if not isinstance(port, str) or port.isdigit():
        _check_port_number(port, "ingress-rule")
    _check_match(spec.get("match") or {}, "ingress-rule match")


def _validate_egress_rule(spec: Mapping[str, Any]) -> None:
    dest = spec.get("destination", {})
    service = str(dest.get("service", "") or "")
    if not service:
        raise ValidationError("egress-rule: destination.service required")
    if "*" in service[1:]:
        raise ValidationError(
            "egress-rule: wildcard only allowed as a leading label")
    if not spec.get("ports"):
        raise ValidationError("egress-rule: ports required")
    for p in spec["ports"]:
        _check_port_number(p.get("port"), "egress-rule")
        proto = str(p.get("protocol", "http")).lower()
        if proto not in ("http", "http2", "grpc", "https", "tcp"):
            raise ValidationError(
                f"egress-rule: unsupported protocol {proto!r}")


def _validate_spec_binding(spec: Mapping[str, Any]) -> None:
    return None


# config.go:407-418 IstioConfigTypes
IstioConfigTypes: dict[str, ProtoSchema] = {s.type: s for s in [
    ProtoSchema("route-rule", "route-rules", _validate_route_rule),
    ProtoSchema("v1alpha2-route-rule", "v1alpha2-route-rules",
                _validate_v1alpha2_route_rule),
    ProtoSchema("gateway", "gateways", _validate_gateway),
    ProtoSchema("ingress-rule", "ingress-rules", _validate_ingress_rule),
    ProtoSchema("egress-rule", "egress-rules", _validate_egress_rule),
    ProtoSchema("destination-policy", "destination-policies",
                _validate_destination_policy),
    ProtoSchema("destination-rule", "destination-rules",
                _validate_destination_rule),
    ProtoSchema("http-api-spec", "http-api-specs", _validate_spec_binding),
    ProtoSchema("http-api-spec-binding", "http-api-spec-bindings",
                _validate_spec_binding),
    ProtoSchema("quota-spec", "quota-specs", _validate_spec_binding),
    ProtoSchema("quota-spec-binding", "quota-spec-bindings",
                _validate_spec_binding),
    ProtoSchema("end-user-authentication-policy-spec",
                "end-user-authentication-policy-specs",
                _validate_spec_binding),
    ProtoSchema("end-user-authentication-policy-spec-binding",
                "end-user-authentication-policy-spec-bindings",
                _validate_spec_binding),
]}


class ConfigStore:
    """config.go:110 ConfigStore: typed CRUD with validation."""

    def get(self, typ: str, name: str, namespace: str) -> Config | None:
        raise NotImplementedError

    def list(self, typ: str, namespace: str | None = None) -> list[Config]:
        raise NotImplementedError

    def create(self, config: Config) -> None:
        raise NotImplementedError

    def update(self, config: Config) -> None:
        raise NotImplementedError

    def delete(self, typ: str, name: str, namespace: str) -> None:
        raise NotImplementedError


class MemoryConfigStore(ConfigStore):
    """pilot/pkg/config/memory — the hermetic test backbone; also the
    ConfigStoreCache (config.go:162): handlers fire on changes."""

    def __init__(self) -> None:
        self._data: dict[tuple[str, str, str], Config] = {}
        self._lock = threading.Lock()
        self._handlers: list[Callable[[Config, str], None]] = []

    def register_handler(self, fn: Callable[[Config, str], None]) -> None:
        self._handlers.append(fn)

    def snapshot(self) -> dict[tuple[str, str, str], Config]:
        """One consistent copy of the full store (the discovery
        snapshot builder's freeze point — a single lock acquisition,
        never a per-type scan racing concurrent writers)."""
        with self._lock:
            return dict(self._data)

    def _notify(self, config: Config, event: str) -> None:
        for fn in list(self._handlers):
            fn(config, event)

    def _validate(self, config: Config) -> None:
        schema = IstioConfigTypes.get(config.meta.type)
        if schema is None:
            raise ValidationError(f"unknown config type {config.meta.type}")
        schema.validate(config.spec)

    def get(self, typ, name, namespace=""):
        with self._lock:
            return self._data.get((typ, namespace, name))

    def list(self, typ, namespace=None):
        with self._lock:
            return [c for (t, ns, _), c in sorted(self._data.items())
                    if t == typ and (namespace is None or ns == namespace)]

    def create(self, config: Config) -> None:
        self._validate(config)
        with self._lock:
            if config.key in self._data:
                raise ValidationError(f"{config.key} already exists")
            self._data[config.key] = config
        self._notify(config, "add")

    def update(self, config: Config) -> None:
        self._validate(config)
        with self._lock:
            if config.key not in self._data:   # reference Update errors
                raise ValidationError(f"{config.key} not found")
            self._data[config.key] = config
        self._notify(config, "update")

    def delete(self, typ, name, namespace="") -> None:
        with self._lock:
            config = self._data.pop((typ, namespace, name), None)
        if config is not None:
            self._notify(config, "delete")


def _match_source(spec: Mapping[str, Any], source: str | None,
                  labels: Mapping[str, str] | None) -> bool:
    want = spec.get("match", {}).get("source", None)
    if want and source and want != source:
        return False
    want_labels = spec.get("match", {}).get("sourceTags") or \
        spec.get("match", {}).get("source_labels") or {}
    if want_labels and labels is not None:
        if any(labels.get(k) != v for k, v in want_labels.items()):
            return False
    return True


class IstioConfigStore:
    """config.go:227 query facade over a ConfigStore."""

    def __init__(self, store: ConfigStore):
        self.store = store

    @staticmethod
    def _destination_hostname(c: Config) -> str:
        """Resolve a rule's destination to an FQDN: short names qualify
        against the RULE's namespace + domain (the reference resolves
        names in the config's namespace, model.ResolveHostname)."""
        dest = c.spec.get("destination", {})
        if isinstance(dest, str):
            name = dest
        elif dest.get("service"):
            # IstioService.service: an FQDN, used verbatim
            return str(dest["service"])
        else:
            name = str(dest.get("name", ""))
        if "." in name or not name:
            return name
        ns = c.meta.namespace or "default"
        domain = c.meta.domain or "cluster.local"
        return f"{name}.{ns}.svc.{domain}"

    def route_rules(self, destination: str, source: str | None = None,
                    source_labels: Mapping[str, str] | None = None
                    ) -> list[Config]:
        """RouteRules by destination (+optional source filter), sorted
        by precedence DESC then name (route.go sorting)."""
        out = []
        for c in self.store.list("route-rule"):
            if self._destination_hostname(c) != destination:
                continue
            if not _match_source(c.spec, source, source_labels):
                continue
            out.append(c)
        out.sort(key=lambda c: (-int(c.spec.get("precedence", 0)),
                                c.meta.name))
        return out

    def destination_policy(self, destination: str,
                           labels: Mapping[str, str] | None = None
                           ) -> Config | None:
        for c in self.store.list("destination-policy"):
            if self._destination_hostname(c) != destination:
                continue
            dest = c.spec.get("destination", {})
            want = (dest.get("tags") or dest.get("labels") or {}) \
                if isinstance(dest, Mapping) else {}
            if want and labels is not None and \
                    any(labels.get(k) != v for k, v in want.items()):
                continue
            return c
        return None

    def egress_rules(self) -> list[Config]:
        return self.store.list("egress-rule")

    def ingress_rules(self) -> list[Config]:
        return self.store.list("ingress-rule")

    def http_api_specs(self, service: str) -> list[Config]:
        """HTTPAPISpecByDestination (config.go:265 family)."""
        bound = []
        for b in self.store.list("http-api-spec-binding"):
            for s in b.spec.get("services", ()):
                sname = s.get("name") if isinstance(s, Mapping) else s
                if sname == service or service.startswith(f"{sname}."):
                    bound.extend(r.get("name") for r in
                                 b.spec.get("api_specs", ()))
        return [c for c in self.store.list("http-api-spec")
                if c.meta.name in bound]

    def quota_specs(self, service: str) -> list[Config]:
        bound = []
        for b in self.store.list("quota-spec-binding"):
            for s in b.spec.get("services", ()):
                sname = s.get("name") if isinstance(s, Mapping) else s
                if sname == service or service.startswith(f"{sname}."):
                    bound.extend(r.get("name") for r in
                                 b.spec.get("quota_specs", ()))
        return [c for c in self.store.list("quota-spec")
                if c.meta.name in bound]
