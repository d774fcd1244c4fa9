"""Versioned discovery snapshots — the registry/config world frozen at
a generation, with per-namespace content digests for scoped
invalidation.

The reference discovery server reads the LIVE registry and config
store on every cache miss and clears its whole response cache on any
event (discovery.go:489 clearCache — deliberately conservative). At
fleet scale that means a 10k-sidecar poll storm after any single
churn recomputes every node's config from live, lock-guarded state.
This module gives Pilot the same doctrine Mixer's serving plane
already follows (compile once, serve many):

  * `build_snapshot` freezes the registry (services + instances) and
    the config store (per-type lists, in the backing store's own list
    order — byte-parity with live generation is a test invariant)
    into an immutable, generation-stamped `DiscoverySnapshot`;
  * every namespace gets a CONTENT DIGEST (compiler/cache.stable_digest
    — the PR 10 content-hash machinery) over its services, instances
    and destination-scoped configs; `changed_scopes` diffs two
    snapshots into the exact namespace set whose content moved, which
    is what drives scoped cache invalidation and the shard-scoped
    delta-push wakeups in pilot/discovery.py;
  * the namespace→shard map comes from the sharding planner
    (sharding/planner.plan_shards, delta mode) so push fan-out state
    is bounded by K shards and STABLE across generations — a
    namespace keeps its shard, exactly the plan-stability contract
    the compiled-bank cache relies on;
  * per-host route-rule/destination-policy indexes make config
    generation O(scoped rules) instead of the live store's
    O(services x all rules) scan, and the source-admission half of
    the route match blocks is compiled ONCE into a
    `route_nfa.RouteScopeProgram` (carried across generations by
    content digest) so per-node route-rule filtering batches through
    one device step shared across all pending node groups.

Port of istio_tpu/pilot/snapshot.py; `build_snapshot` takes the device
the route scope program runs on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from istio_tpu_torch.compiler.cache import stable_digest
from istio_tpu_torch.pilot.model import (Config, ConfigStore, IstioConfigStore,
                                   IstioConfigTypes, Node, Service,
                                   ServiceInstance, _match_source)
from istio_tpu_torch.pilot.registry import ServiceDiscovery
from istio_tpu_torch.sharding.planner import ShardPlan, plan_shards

# pseudo-namespace for mesh-wide inputs (egress/ingress rules, auth
# specs, services whose hostname carries no namespace label): entries
# depending on it invalidate whenever any mesh-scoped config moves
MESH_SCOPE = "~mesh"


def scope_of_hostname(hostname: str) -> str:
    """Namespace scope of a service hostname (`svc.ns.svc.domain` →
    `ns`); hostnames with no namespace label are mesh-scoped."""
    parts = hostname.split(".")
    return parts[1] if len(parts) > 1 and parts[1] else MESH_SCOPE


def config_scope(cfg: Config) -> str:
    """The namespace whose digest a config resource belongs to:
    destination-addressed kinds scope to the DESTINATION service's
    namespace (their content only ever appears in that namespace's
    generated config); everything else (egress, ingress, auth/quota
    specs) is mesh-wide."""
    if cfg.meta.type in ("route-rule", "v1alpha2-route-rule",
                        "destination-policy", "destination-rule"):
        host = IstioConfigStore._destination_hostname(cfg)
        return scope_of_hostname(host)
    return MESH_SCOPE


class FrozenConfigStore(ConfigStore):
    """Immutable ConfigStore view: per-type lists captured in the
    backing store's own list() order at freeze time."""

    def __init__(self, by_type: Mapping[str, Sequence[Config]]):
        self._by_type = {t: tuple(cfgs) for t, cfgs in by_type.items()}

    def get(self, typ: str, name: str, namespace: str = "") -> Config | None:
        for c in self._by_type.get(typ, ()):
            if c.meta.name == name and c.meta.namespace == namespace:
                return c
        return None

    def list(self, typ: str, namespace: str | None = None) -> list[Config]:
        return [c for c in self._by_type.get(typ, ())
                if namespace is None or c.meta.namespace == namespace]

    def create(self, config: Config) -> None:
        raise TypeError("snapshot config store is immutable")

    update = create

    def delete(self, typ: str, name: str, namespace: str = "") -> None:
        raise TypeError("snapshot config store is immutable")


def instance_order(inst: ServiceInstance) -> tuple:
    """Canonical colocated-instance ordering (hostname, port, port
    name, address). Live registries return host_instances in service
    INSERTION order — process-history state that a content-addressed
    cache must not depend on; both the snapshot serving path and the
    parity reference sort by this key so multi-service nodes generate
    identical bytes regardless of registration order."""
    return (inst.service.hostname, inst.endpoint.port,
            inst.endpoint.service_port.name, inst.endpoint.address)


class FrozenRegistry(ServiceDiscovery):
    """Immutable ServiceDiscovery view with an address index (node →
    colocated instances is a per-poll lookup at fleet scale, never a
    scan). host_instances returns the canonical `instance_order`."""

    def __init__(self, services: Sequence[Service],
                 instances_by_host: Mapping[str, Sequence[ServiceInstance]]):
        self._services = sorted(services, key=lambda s: s.hostname)
        self._by_host = {h: tuple(v) for h, v in instances_by_host.items()}
        self._by_addr: dict[str, list[ServiceInstance]] = {}
        for insts in self._by_host.values():
            for inst in insts:
                self._by_addr.setdefault(inst.endpoint.address,
                                         []).append(inst)
        for insts in self._by_addr.values():
            insts.sort(key=instance_order)
        self._svc_index = {s.hostname: s for s in self._services}

    def services(self) -> list[Service]:
        return list(self._services)

    def get_service(self, hostname: str) -> Service | None:
        return self._svc_index.get(hostname)

    def instances(self, hostname, ports=(), labels=None):
        out = []
        for inst in self._by_host.get(hostname, ()):
            if ports and inst.endpoint.service_port.name not in ports:
                continue
            if labels and any(inst.labels.get(k) != v
                              for k, v in labels.items()):
                continue
            out.append(inst)
        return out

    def host_instances(self, addrs: set[str]) -> list[ServiceInstance]:
        out = []
        for a in sorted(addrs):
            out.extend(self._by_addr.get(a, ()))
        out.sort(key=instance_order)
        return out


class SnapshotConfigView(IstioConfigStore):
    """IstioConfigStore whose hot queries (route_rules /
    destination_policy) read precomputed per-host indexes instead of
    re-scanning the full store per service — same results, same sort
    order, O(rules of host) per query."""

    def __init__(self, store: FrozenConfigStore,
                 rules_by_host: Mapping[str, Sequence[Config]],
                 policies_by_host: Mapping[str, Sequence[Config]]):
        super().__init__(store)
        self._rules_by_host = rules_by_host
        self._policies_by_host = policies_by_host

    def route_rules(self, destination, source=None, source_labels=None):
        return [c for c in self._rules_by_host.get(destination, ())
                if _match_source(c.spec, source, source_labels)]

    def destination_policy(self, destination, labels=None):
        for c in self._policies_by_host.get(destination, ()):
            dest = c.spec.get("destination", {})
            want = (dest.get("tags") or dest.get("labels") or {}) \
                if isinstance(dest, Mapping) else {}
            if want and labels is not None and \
                    any(labels.get(k) != v for k, v in want.items()):
                continue
            return c
        return None


@dataclasses.dataclass
class DiscoverySnapshot:
    """One immutable generation of the discovery world."""
    version: int
    registry: FrozenRegistry
    store: FrozenConfigStore
    config: SnapshotConfigView
    scope_digests: dict[str, str]
    rules_by_host: dict[str, tuple[Config, ...]]
    plan: ShardPlan
    scope: Any                      # route_nfa.RouteScopeProgram
    source_ports: frozenset[int]
    # http port → sorted hostnames serving it: the publish sweep diffs
    # this across generations so an RDS entry whose PORT MEMBERSHIP
    # changed invalidates even when the joining/leaving service lives
    # in a namespace the entry never depended on (a cross-namespace
    # service joining an already-cached port must not be masked by
    # namespace-scoped deps)
    port_services: dict[int, tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)
    n_services: int = 0
    n_rules: int = 0
    build_wall_s: float = 0.0
    plan_wall_s: float = 0.0
    scope_reused: bool = False

    def rules_for(self, hostname: str) -> tuple[Config, ...]:
        """Precedence-sorted route rules destined to `hostname` —
        identical membership + order to
        `IstioConfigStore.route_rules(hostname)` with no source
        filter."""
        return self.rules_by_host.get(hostname, ())

    def scope_audit_pairs(self, limit: int = 256) -> list:
        """(name, served-plane predicate, compiled-plane predicate)
        pairs for the mesh audit plane's plane_agreement check
        (runtime/audit.py): the source constraints re-derived from the
        served rules_by_host against the constraints the carried
        RouteScopeProgram compiled (`_constrained` / `_sources`). The
        program rides across generations whenever its content digest
        matches, so this is the live check that a carried program still
        encodes the routes being served. A constraint on one side only
        pairs against 'true', which the planes checker refutes with a
        witness."""
        served: dict[tuple, str] = {}
        for host in sorted(self.rules_by_host):
            for i, rule in enumerate(self.rules_by_host[host]):
                src = (rule.spec.get("match") or {}).get("source")
                if src:
                    served[(host, i)] = str(src)
        compiled = {pair: self.scope._sources[j]
                    for j, pair in enumerate(self.scope._constrained)}

        def _pred(src: str | None) -> str:
            if src is None:
                return "true"
            return 'source.service == "%s"' % src.replace('"', '\\"')

        pairs = []
        for host, i in sorted(set(served) | set(compiled)):
            pairs.append((f"{host}[{i}]",
                          _pred(served.get((host, i))),
                          _pred(compiled.get((host, i)))))
            if len(pairs) >= limit:
                break
        return pairs

    def node_instances(self, node: str) -> list[ServiceInstance]:
        return self.registry.host_instances(
            {Node.parse(node).ip_address})

    def node_source(self, node: str) -> str | None:
        """The node's primary colocated service hostname (route-rule
        source identity, route.go buildVirtualHost's `source`); None
        for nodes hosting nothing."""
        hosts = sorted({i.service.hostname
                        for i in self.node_instances(node)})
        return hosts[0] if hosts else None

    def node_namespace(self, node: str) -> str:
        hosts = sorted({scope_of_hostname(i.service.hostname)
                        for i in self.node_instances(node)})
        return hosts[0] if hosts else ""

    def shard_of_node(self, node: str) -> int:
        return self.plan.shard_of(self.node_namespace(node))

    def port_has_source_rules(self, port_num: int) -> bool:
        """True when any route rule destined to a service exposing
        http `port_num` carries a source constraint — the collapse
        rule for RDS node groups: ports with no source-constrained
        rules serve ONE shared config to every sidecar."""
        return port_num in self.source_ports


def _freeze_store(config_store: ConfigStore) -> FrozenConfigStore:
    if hasattr(config_store, "snapshot"):
        by_key = config_store.snapshot()
        by_type: dict[str, list[Config]] = {}
        for key in sorted(by_key):
            c = by_key[key]
            by_type.setdefault(c.meta.type, []).append(c)
        return FrozenConfigStore(by_type)
    return FrozenConfigStore({typ: config_store.list(typ)
                              for typ in IstioConfigTypes})


def _digest_scopes(services: Sequence[Service],
                   instances_by_host: Mapping[str, Sequence[ServiceInstance]],
                   by_type: Mapping[str, Sequence[Config]]
                   ) -> dict[str, str]:
    payload: dict[str, dict] = {}

    def bucket(ns: str) -> dict:
        return payload.setdefault(ns, {"services": [], "instances": [],
                                       "configs": []})

    for s in services:
        ns = scope_of_hostname(s.hostname)
        bucket(ns)["services"].append(
            (s.hostname, s.address,
             [(p.name, p.port, p.protocol) for p in s.ports],
             s.external_name, s.service_account))
        for i in instances_by_host.get(s.hostname, ()):
            bucket(ns)["instances"].append(
                (i.endpoint.address, i.endpoint.port,
                 i.endpoint.service_port.name,
                 sorted(i.labels.items()), i.availability_zone,
                 i.service_account))
    for typ in sorted(by_type):
        for c in by_type[typ]:
            ns = config_scope(c)
            bucket(ns)["configs"].append(
                (c.meta.type, c.meta.namespace, c.meta.name, c.spec))
    return {ns: stable_digest(p) for ns, p in payload.items()}


def changed_scopes(prev: DiscoverySnapshot | None,
                   cur: DiscoverySnapshot) -> set[str]:
    """Namespaces whose content digest moved between two snapshots
    (added/removed namespaces count as changed). prev=None → every
    scope of `cur` (plus the mesh scope) is 'changed'."""
    if prev is None:
        return set(cur.scope_digests) | {MESH_SCOPE}
    out = set()
    for ns in set(prev.scope_digests) | set(cur.scope_digests):
        if prev.scope_digests.get(ns) != cur.scope_digests.get(ns):
            out.add(ns)
    return out


def changed_http_ports(prev: DiscoverySnapshot | None,
                       cur: DiscoverySnapshot) -> set[int]:
    """HTTP ports whose SERVICE MEMBERSHIP moved between snapshots —
    the cross-namespace invalidation leg: an RDS entry depends on the
    namespaces that were on its port when it was generated, so a
    service from a NEW namespace joining the port would never
    intersect those deps; the publish sweep invalidates by port
    membership as well."""
    if prev is None:
        return set(cur.port_services)
    return {p for p in set(prev.port_services) | set(cur.port_services)
            if prev.port_services.get(p) != cur.port_services.get(p)}


class _NsUnit:
    """Planner placement unit: one namespace's worth of discovery
    content (plan_shards only reads `.namespace` when costs are
    supplied)."""
    __slots__ = ("namespace",)

    def __init__(self, namespace: str):
        self.namespace = namespace


def build_snapshot(registry: ServiceDiscovery, config_store: ConfigStore,
                   version: int, prev: DiscoverySnapshot | None = None,
                   n_shards: int = 8,
                   device: str | torch.device = "cuda") -> DiscoverySnapshot:
    """Freeze the live world into a generation-`version` snapshot.

    Carry-over doctrine (PR 10): the compiled source-scope program is
    keyed by the content digest of its constraint set and reused from
    `prev` when unchanged — a churn storm that never touches a source
    constraint recompiles nothing; the shard plan is built in delta
    mode against `prev` so namespaces keep their shards (watchers'
    scope keys stay stable across generations). The scope program
    compiles on `device` (lazily, at its first admit_rows)."""
    from istio_tpu_torch.pilot.route_nfa import RouteScopeProgram

    t0 = time.perf_counter()
    services = registry.services()
    instances_by_host = {s.hostname: list(registry.instances(s.hostname))
                         for s in services}
    frozen = _freeze_store(config_store)
    store_by_type = {typ: frozen.list(typ) for typ in IstioConfigTypes}
    digests = _digest_scopes(services, instances_by_host, store_by_type)

    # per-host indexes (same membership + sort as the live queries)
    rules_by_host: dict[str, list[Config]] = {}
    for c in store_by_type.get("route-rule", ()):
        host = IstioConfigStore._destination_hostname(c)
        rules_by_host.setdefault(host, []).append(c)
    for host in rules_by_host:
        rules_by_host[host].sort(
            key=lambda c: (-int(c.spec.get("precedence", 0)),
                           c.meta.name))
    policies_by_host: dict[str, list[Config]] = {}
    for c in store_by_type.get("destination-policy", ()):
        host = IstioConfigStore._destination_hostname(c)
        policies_by_host.setdefault(host, []).append(c)

    frozen_rules = {h: tuple(v) for h, v in rules_by_host.items()}
    reg = FrozenRegistry(services, instances_by_host)
    view = SnapshotConfigView(frozen, frozen_rules, policies_by_host)

    # RDS group-collapse index: http ports carrying source-scoped rules
    constrained_hosts = {
        h for h, rules in frozen_rules.items()
        if any((r.spec.get("match") or {}).get("source") for r in rules)}
    source_ports = frozenset(
        p.port for s in services if s.hostname in constrained_hosts
        for p in s.ports if p.is_http)
    port_membership: dict[int, set[str]] = {}
    for s in services:
        for p in s.ports:
            if p.is_http:
                port_membership.setdefault(p.port, set()).add(
                    s.hostname)
    port_services = {p: tuple(sorted(v))
                     for p, v in port_membership.items()}

    # namespace → shard plan (delta mode: plan stability across
    # generations is the watch protocol's scope-key contract)
    ns_weight: dict[str, float] = {}
    for s in services:
        ns = scope_of_hostname(s.hostname)
        if ns != MESH_SCOPE:
            ns_weight[ns] = ns_weight.get(ns, 0.0) + 1.0
    for host, rules in frozen_rules.items():
        ns = scope_of_hostname(host)
        if ns != MESH_SCOPE:
            ns_weight[ns] = ns_weight.get(ns, 0.0) + float(len(rules))
    units = [_NsUnit(ns) for ns in sorted(ns_weight)]
    costs = np.asarray([ns_weight[u.namespace] for u in units],
                       np.float64)
    plan = plan_shards(units, None, n_shards, costs=costs,
                       revision=version,
                       prev=prev.plan if prev is not None else None)

    scope = RouteScopeProgram(frozen_rules, device=device)
    reused = False
    if prev is not None and prev.scope is not None \
            and prev.scope.digest == scope.digest:
        scope = prev.scope               # compiled program carry-over
        reused = True

    return DiscoverySnapshot(
        version=version, registry=reg, store=frozen, config=view,
        scope_digests=digests, rules_by_host=frozen_rules, plan=plan,
        scope=scope, source_ports=source_ports,
        port_services=port_services,
        n_services=len(services),
        n_rules=sum(len(v) for v in frozen_rules.values()),
        build_wall_s=time.perf_counter() - t0,
        plan_wall_s=plan.plan_wall_s, scope_reused=reused)
