"""Envoy v1 REST discovery service (SDS/CDS/RDS/LDS) — served from
versioned snapshots with a scoped cache, delta pushes and batched
route generation.

Reference: pilot/pkg/proxy/envoy/discovery.go — routes registered at
:360-408: /v1/registration/{service-key} (SDS),
/v1/clusters/{cluster}/{node} (CDS), /v1/routes/{name}/{cluster}/{node}
(RDS), /v1/listeners/{cluster}/{node} (LDS); per-endpoint hit/miss
metrics (:784-817). The reference invalidates its whole response cache
on any registry/config event (clearCache :489 — the deliberately
conservative design documented at :124-139); this implementation
replaces that with the serving doctrine the Mixer side proved:

  * the registry/config world is published as immutable,
    generation-stamped `DiscoverySnapshot`s (pilot/snapshot.py) — the
    serving path never reads live mutable state;
  * responses are cached per (endpoint, node group, generation):
    identical sidecars SHARE one generated config (RDS groups collapse
    to (port, source-identity) — and to just (port,) when no route
    rule on the port is source-constrained; CDS groups collapse to the
    node's inbound port signature);
  * a config swap invalidates ONLY the node groups whose scoped
    content actually changed: the publish diffs per-namespace content
    digests (PR 10 machinery) and sweeps entries whose recorded
    namespace deps intersect the changed set — everything else is
    CARRIED to the new generation untouched. CDS/LDS responses embed
    mesh-wide cluster/listener sets and honestly carry mesh-wide deps
    (the reference's wholesale clear is the correct answer for them);
    SDS is namespace-scoped and RDS is port/namespace-scoped, which is
    where a 10k-sidecar fleet stops repaying full generation per
    churn;
  * delta push: sidecars long-poll /v1/watch/{cluster}/{node}?version=
    and park on their namespace's SHARD (the sharding planner's
    namespace→shard map bounds fan-out state and keeps scope keys
    stable across generations); a publish wakes only the shards whose
    namespaces changed — the rest of the fleet never re-pulls;
  * route generation for ALL pending node groups batches the
    source-admission half of the match blocks through ONE compiled
    device step (route_nfa.RouteScopeProgram — the same ruleset
    tensors the route NFA and policy engine ride), replacing the
    per-node host filter scan;
  * the serving front is the threaded stdlib server with an explicit
    quiesce ordering (PR 7 doctrine: admission → generation → flush →
    join): draining answers new pulls with a typed UNAVAILABLE
    rejection and releases parked watchers before the listener joins.

Stage decomposition (`pilot_discovery_stage_seconds`) and cache/push
counters live in runtime/monitor.py; `/debug/discovery` is the operator
view.

Port of istio_tpu/pilot/discovery.py. `DiscoveryService(registry, store,
device=...)` runs the route scope program (RDS admission, K1) on
`device`, "cuda" by default (raising without CUDA). The endpoint call
counts (`CALLS`) are the port's own series table: the card's machine has
no prometheus_client.
"""
from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Mapping
from urllib.parse import parse_qsl

import torch

from istio_tpu_torch.device import resolve_device
from istio_tpu_torch.pilot.envoy_config import (build_egress_clusters,
                                          build_inbound_clusters,
                                          build_inbound_listeners,
                                          build_ingress_listeners,
                                          build_jwks_clusters,
                                          build_outbound_clusters,
                                          build_outbound_listeners)
from istio_tpu_torch.pilot.model import (NODE_INGRESS, NODE_SIDECAR,
                                         IstioConfigStore, Node)
from istio_tpu_torch.pilot.routes import (build_egress_virtual_hosts,
                                    build_ingress_route_config,
                                    build_route_config,
                                    build_virtual_host_from_rules)
from istio_tpu_torch.pilot.snapshot import (DiscoverySnapshot, MESH_SCOPE,
                                      build_snapshot,
                                      changed_http_ports,
                                      changed_scopes, instance_order,
                                      scope_of_hostname)
from istio_tpu_torch.runtime import monitor
from istio_tpu_torch.runtime.resilience import CHAOS, UnavailableError

log = logging.getLogger("istio_tpu_torch.pilot.discovery")



class CallCounts:
    """pilot_discovery_calls: endpoint calls by (endpoint, cache). Every
    series is pre-touched, so a reading taken before the first poll
    already shows each endpoint / cache pair at 0."""

    ENDPOINTS = ("sds", "cds", "rds", "lds", "az")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.series = {(ep, c): 0.0 for ep in self.ENDPOINTS
                       for c in ("hit", "miss")}

    def inc(self, endpoint: str, cache: str) -> None:
        with self._lock:
            self.series[(endpoint, cache)] = \
                self.series.get((endpoint, cache), 0.0) + 1.0


CALLS = CallCounts()

DEFAULT_WATCH_TIMEOUT_S = 25.0
MAX_WATCH_TIMEOUT_S = 60.0


class SnapshotCache:
    """Response cache keyed (endpoint, node group) with generation
    stamps and per-entry namespace deps.

    An entry is a hit only for the generation it is stamped with; a
    publish sweep (`invalidate`) drops entries whose deps intersect
    the changed namespace set (deps None = mesh-wide = always drops)
    and re-stamps the survivors to the new generation — the scoped-
    invalidation contract. Entries stamped with a generation OLDER
    than the sweep's `prev_version` were built against a snapshot the
    diff does not cover and are dropped unconditionally (they can
    never be proven current)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> (data bytes, version, deps frozenset | None)
        self._entries: dict[tuple, tuple[bytes, int, Any]] = {}
        self.hits = 0
        self.misses = 0
        self.carried = 0
        self.invalidated = 0

    def lookup(self, key: tuple, version: int) -> bytes | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[1] == version:
                self.hits += 1
                return entry[0]
            self.misses += 1
            return None

    def peek(self, key: tuple, version: int) -> bytes | None:
        """lookup without hit/miss accounting (the post-batched-fill
        fetch — the call was already counted a miss)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[1] == version:
                return entry[0]
            return None

    def store(self, key: tuple, data: bytes, version: int,
              deps: Any) -> None:
        with self._lock:
            self._entries[key] = (data, version, deps)

    def invalidate(self, changed: set, prev_version: int,
                   new_version: int,
                   changed_ports: set = frozenset()) -> list[tuple]:
        """Publish sweep: returns the dropped keys. `changed_ports`
        (snapshot.changed_http_ports) additionally drops RDS groups
        whose port's service membership moved — the deps set records
        the namespaces ON the port at build time, which cannot see a
        cross-namespace service joining it."""
        dropped: list[tuple] = []
        carried = 0
        with self._lock:
            for key, (data, v, deps) in list(self._entries.items()):
                stale = v != prev_version
                affected = deps is None or bool(deps & changed)
                port_hit = (key[0] == "rds" and len(key) == 3
                            and key[1] in changed_ports)
                if stale or port_hit or (changed and affected):
                    del self._entries[key]
                    dropped.append(key)
                else:
                    self._entries[key] = (data, new_version, deps)
                    carried += 1
            self.invalidated += len(dropped)
            self.carried += carried
        monitor.note_discovery_cache("invalidated", len(dropped))
        monitor.note_discovery_cache("carried", carried)
        return dropped

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.invalidated += n
        monitor.note_discovery_cache("invalidated", n)
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            by_endpoint: dict[str, int] = {}
            for key in self._entries:
                by_endpoint[key[0]] = by_endpoint.get(key[0], 0) + 1
            calls = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "by_endpoint": by_endpoint,
                "hits": self.hits,
                "misses": self.misses,
                "carried": self.carried,
                "invalidated": self.invalidated,
                "hit_rate": round(self.hits / calls, 4) if calls
                else None,
            }


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, indent=2, sort_keys=True).encode()


class DiscoveryService:
    """Serves envoy v1 discovery from versioned snapshots."""

    def __init__(self, registry, config_store,
                 mesh: Mapping[str, Any] | None = None,
                 scope_shards: int = 8, watch_cap: int = 1024,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.registry = registry
        self.config_store = config_store
        self.mesh = dict(mesh or {})
        self._watch_cap = max(int(watch_cap), 0)
        self._cache = SnapshotCache()
        self._publish_lock = threading.Lock()
        self._gen_lock = threading.Lock()   # pending-group set
        self._watch = threading.Condition()
        self._scope_shards = max(int(scope_shards), 1)
        self._snapshot = build_snapshot(registry, config_store,
                                        version=1, prev=None,
                                        n_shards=self._scope_shards,
                                        device=self.device)
        self._shard_version = [1] * self._scope_shards
        self._shard_bump_wall = [0.0] * self._scope_shards
        self._pending_rds: set[tuple] = set()
        self._hold = 0
        self._dirty = False
        self._draining = False
        self._n_waiting = 0
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        monitor.set_discovery_generation(1)
        if hasattr(config_store, "register_handler"):
            config_store.register_handler(self._on_event)
        if hasattr(registry, "append_service_handler"):
            registry.append_service_handler(self._on_event)

    # -- snapshot publishing ------------------------------------------

    @property
    def snapshot(self) -> DiscoverySnapshot:
        return self._snapshot

    @property
    def generation(self) -> int:
        return self._snapshot.version

    def _on_event(self, *_args) -> None:
        if self._draining or self._hold:
            # quiesce/hold: generation is off, but the world moved —
            # remember it so start()/hold-exit republishes (a restart
            # must never serve the pre-drain snapshot forever)
            self._dirty = True
            return
        self.publish()

    @contextlib.contextmanager
    def hold_publishes(self):
        """Defer event-driven publishes (apply a churn batch, publish
        once) — the debounce seam the bench/smoke churn storms use."""
        self._hold += 1
        try:
            yield
        finally:
            self._hold -= 1
            if not self._hold and self._dirty and not self._draining:
                # while draining, _dirty STAYS set — start()'s
                # catch-up publish is what replays it after a restart
                self._dirty = False
                self.publish()

    def publish(self) -> dict:
        """Freeze the live world into the next generation, diff it
        against the current one, sweep only the affected cache
        entries, and wake only the watch shards whose namespaces
        changed. Returns the publish audit record."""
        with self._publish_lock:
            # discovery-push chaos seam: an armed delay stalls the
            # pipeline inside the publish lock (watchers stay parked on
            # the old generation until the delayed push completes)
            CHAOS.discovery_publish()
            prev = self._snapshot
            t0 = time.perf_counter()
            snap = build_snapshot(self.registry, self.config_store,
                                  version=prev.version + 1, prev=prev,
                                  n_shards=self._scope_shards,
                                  device=self.device)
            monitor.observe_discovery_stage(
                "snapshot_build",
                max(snap.build_wall_s - snap.plan_wall_s, 0.0))
            monitor.observe_discovery_stage("scope_plan",
                                            snap.plan_wall_s)
            t1 = time.perf_counter()
            changed = changed_scopes(prev, snap)
            ports_moved = changed_http_ports(prev, snap)
            dropped = self._cache.invalidate(changed, prev.version,
                                             snap.version,
                                             ports_moved)
            with self._gen_lock:
                self._pending_rds |= {k for k in dropped
                                      if k[0] == "rds"
                                      and k[1] != "ingress"}
            self._snapshot = snap
            shards_hit: set[int] = set()
            if changed:
                if MESH_SCOPE in changed:
                    shards_hit = set(range(self._scope_shards))
                else:
                    for ns in changed:
                        # BOTH plans: a fully-deleted namespace is
                        # gone from the new plan (shard_of falls back
                        # to the crc32 hash), but its watchers parked
                        # on the PREVIOUS plan's shard — bump that
                        # one too or they never learn their services
                        # vanished
                        shards_hit.add(snap.plan.shard_of(ns))
                        shards_hit.add(prev.plan.shard_of(ns))
            wall = time.perf_counter()
            with self._watch:
                for k in shards_hit:
                    self._shard_version[k] = snap.version
                    self._shard_bump_wall[k] = wall
                self._watch.notify_all()
            monitor.observe_discovery_stage(
                "invalidate", time.perf_counter() - t1)
            monitor.set_discovery_generation(snap.version)
            audit = {"version": snap.version,
                     "changed_scopes": sorted(changed),
                     "changed_ports": sorted(ports_moved),
                     "invalidated": len(dropped),
                     "shards_notified": sorted(shards_hit),
                     "build_wall_ms":
                         round((time.perf_counter() - t0) * 1e3, 3),
                     "scope_program_reused": snap.scope_reused}
            log.debug("discovery publish: %s", audit)
            self._last_publish = audit
            return audit

    # -- cache (scoped invalidation replaces discovery.go:489) --------

    def clear_cache(self) -> None:
        """Wholesale drop (the reference's clearCache, kept as the
        manual/admin escape hatch — registry/config events use the
        scoped publish sweep instead)."""
        self._cache.clear()
        log.debug("discovery cache cleared")

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    def _serve_cached(self, key: tuple, snap: DiscoverySnapshot,
                      build) -> bytes:
        """Cache lookup → response bytes; on miss, generate against
        `snap` (RDS misses batch every pending group through one
        device step first). Hot section: one dict lookup + counters on
        the hit path."""
        t0 = time.perf_counter()
        data = self._cache.lookup(key, snap.version)
        if data is not None:
            CALLS.inc(key[0], "hit")
            monitor.note_discovery_cache("hit")
            monitor.observe_discovery_stage(
                "serve", time.perf_counter() - t0)
            return data
        CALLS.inc(key[0], "miss")
        monitor.note_discovery_cache("miss")
        if key[0] == "rds" and key[1] != "ingress":
            self._generate_rds_batch(snap, key)
            data = self._cache.peek(key, snap.version)
        if data is None:
            t1 = time.perf_counter()
            obj, deps = build(snap)
            data = _dumps(obj)
            self._cache.store(key, data, snap.version, deps)
            monitor.observe_discovery_stage(
                "generate", time.perf_counter() - t1)
        monitor.observe_discovery_stage(
            "serve", time.perf_counter() - t0)
        return data

    def _generate_rds_batch(self, snap: DiscoverySnapshot,
                            want_key: tuple) -> None:
        """Fill `want_key` plus every RDS group the last publish
        invalidated, in ONE batched generation: one source-admission
        device step shared across all pending node groups, then
        per-group JSON assembly. Hot section: the device pull lives in
        RouteScopeProgram.admit_rows behind its pragma."""
        with self._gen_lock:
            pending = {k for k in self._pending_rds
                       if k[0] == "rds" and k[1] != "ingress"}
            pending.add(want_key)
            groups = sorted(pending, key=repr)
            t0 = time.perf_counter()
            rows = snap.scope.admit_rows(
                [src for (_e, _port, src) in groups])
            monitor.observe_discovery_stage(
                "route_eval", time.perf_counter() - t0)
            t1 = time.perf_counter()
            for key, row in zip(groups, rows):
                _e, port_num, source = key
                obj, deps = self._assemble_rds(snap, port_num, row)
                self._cache.store(key, _dumps(obj), snap.version, deps)
            monitor.observe_discovery_stage(
                "generate", time.perf_counter() - t1)
            self._pending_rds -= pending

    def _assemble_rds(self, snap: DiscoverySnapshot, port_num: int,
                      admit_row) -> tuple[dict, frozenset]:
        """RDS payload for one node group from the admission row —
        byte-identical to routes.build_route_config over the same
        world (assembly is single-sourced through
        build_virtual_host_from_rules; the admission row reproduces
        the _match_source filter)."""
        vhosts = []
        deps = {MESH_SCOPE}          # egress vhosts ride every RDS
        # port_services is hostname-sorted, exactly the order the
        # whole-mesh scan visits services — O(services on port), not
        # O(mesh), per group
        for host in snap.port_services.get(port_num, ()):
            service = snap.registry.get_service(host)
            if service is None:
                continue
            for port in service.ports:
                if port.port == port_num and port.is_http:
                    rules = snap.rules_for(host)
                    kept = [r for i, r in enumerate(rules)
                            if snap.scope.admits(admit_row, host, i)]
                    vhosts.append(build_virtual_host_from_rules(
                        service, port, kept))
                    deps.add(scope_of_hostname(host))
        vhosts.extend(build_egress_virtual_hosts(snap.config, port_num))
        vhosts.sort(key=lambda v: v["name"])
        return ({"virtual_hosts": vhosts, "validate_clusters": False},
                frozenset(deps))

    # -- endpoints ----------------------------------------------------

    def list_endpoints(self, service_key: str) -> bytes:
        """SDS /v1/registration/{service-key} (discovery.go:572) —
        namespace-scoped cache entry."""
        snap = self._snapshot

        def build(s):
            hostname, _, rest = service_key.partition("|")
            port_name, _, label_str = rest.partition("|")
            labels = dict(kv.split("=", 1)
                          for kv in label_str.split(",") if "=" in kv)
            instances = s.registry.instances(
                hostname, (port_name,) if port_name else (), labels)
            return {"hosts": [
                {"ip_address": i.endpoint.address,
                 "port": i.endpoint.port,
                 "tags": {"az": i.availability_zone} if
                 i.availability_zone else {}}
                for i in instances]}, \
                frozenset({scope_of_hostname(
                    service_key.partition("|")[0])})

        return self._serve_cached(("sds", service_key), snap, build)

    def _cds_group(self, snap: DiscoverySnapshot, node: str) -> tuple:
        role = Node.parse(node)
        if role.type != NODE_SIDECAR:
            return ("cds", role.type)
        ports = tuple(sorted({i.endpoint.port
                              for i in snap.node_instances(node)}))
        return ("cds", role.type, ports)

    def list_clusters(self, cluster: str, node: str) -> bytes:
        snap = self._snapshot

        def build(s):
            services = s.registry.services()
            clusters = build_outbound_clusters(services, s.config)
            clusters += build_egress_clusters(s.config)
            clusters += build_jwks_clusters(s.config)
            if Node.parse(node).type == NODE_SIDECAR:
                clusters += build_inbound_clusters(
                    s.node_instances(node))
            return {"clusters": clusters}, None   # mesh-scoped

        return self._serve_cached(self._cds_group(snap, node), snap,
                                  build)

    def _rds_group(self, snap: DiscoverySnapshot, name: str,
                   node: str) -> tuple:
        if Node.parse(node).type == NODE_INGRESS:
            return ("rds", "ingress")
        port_num = int(name)
        source = snap.node_source(node) \
            if snap.port_has_source_rules(port_num) else None
        return ("rds", port_num, source)

    def list_routes(self, name: str, cluster: str, node: str) -> bytes:
        snap = self._snapshot
        key = self._rds_group(snap, name, node)
        if key[1] == "ingress":
            def build(s):
                return build_ingress_route_config(s.config,
                                                  s.registry), None
            return self._serve_cached(key, snap, build)

        def build(s):
            row = s.scope.admit_rows([key[2]])[0]
            return self._assemble_rds(s, key[1], row)

        return self._serve_cached(key, snap, build)

    def _lds_group(self, snap: DiscoverySnapshot, node: str) -> tuple:
        role = Node.parse(node)
        if role.type == NODE_INGRESS:
            return ("lds", "ingress")
        sig = tuple(sorted(
            (i.endpoint.address, i.endpoint.port,
             i.endpoint.service_port.protocol)
            for i in snap.node_instances(node)))
        return ("lds", role.type, sig)

    def list_listeners(self, cluster: str, node: str) -> bytes:
        snap = self._snapshot

        def build(s):
            services = s.registry.services()
            role = Node.parse(node)
            if role.type == NODE_INGRESS:
                listeners = build_ingress_listeners(
                    s.config, s.registry, self.mesh,
                    tls_context=self.mesh.get("ingress_tls"))
            else:
                listeners = build_outbound_listeners(services, s.config,
                                                     self.mesh)
                if role.type == NODE_SIDECAR:
                    listeners += build_inbound_listeners(
                        s.node_instances(node), self.mesh)
            return {"listeners": listeners}, None   # mesh-scoped

        return self._serve_cached(self._lds_group(snap, node), snap,
                                  build)

    def availability_zone(self, cluster: str, node: str) -> bytes:
        """/v1/az/{cluster}/{node} (discovery.go:601): the AZ of the
        node's instances (all share the node IP, hence the AZ).
        Plain-text body (the only non-JSON discovery response)."""
        CALLS.inc("az", "miss")
        instances = self._snapshot.node_instances(node)
        if not instances:
            raise KeyError(f"az: no instances for node {node}")
        return str(instances[0].availability_zone or "").encode()

    # -- delta push (long-poll version watch) -------------------------

    def watch(self, node: str, have_version: int = 0,
              timeout_s: float | None = None) -> dict:
        """Park until the node's scope shard publishes a generation
        newer than `have_version` (or timeout / drain). The scope
        shard comes from the snapshot's namespace→shard map, so a
        publish wakes only the shards whose namespaces changed —
        delta push instead of full-fleet re-pulls.

        Capacity: the shard map bounds the VERSION bookkeeping, but on
        the threaded stdlib front each parked watcher still holds one
        OS thread — `watch_cap` (constructor, default 1024) bounds
        that honestly: over-capacity watchers return IMMEDIATELY with
        `over_capacity: true` (degrading those clients to plain
        polling) instead of letting a 10k-sidecar fleet pin 10k
        threads."""
        timeout = DEFAULT_WATCH_TIMEOUT_S if timeout_s is None \
            else min(max(float(timeout_s), 0.0), MAX_WATCH_TIMEOUT_S)
        snap = self._snapshot
        shard = snap.shard_of_node(node)
        entered = time.perf_counter()
        deadline = entered + timeout
        with self._watch:
            if self._n_waiting >= self._watch_cap:
                cur = self._shard_version[shard]
                return {"version": self._snapshot.version,
                        "shard": shard, "shard_version": cur,
                        "changed": cur > have_version,
                        "over_capacity": True,
                        "draining": self._draining}
            self._n_waiting += 1
            try:
                while (not self._draining
                       and self._shard_version[shard] <= have_version):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._watch.wait(remaining)
            finally:
                self._n_waiting -= 1
            cur = self._shard_version[shard]
            bump_wall = self._shard_bump_wall[shard]
        changed = cur > have_version
        if changed and bump_wall >= entered:
            # this waiter was parked when the publish landed — the
            # wake delay IS the push fan-out latency
            monitor.observe_discovery_push(
                time.perf_counter() - bump_wall)
        return {"version": self._snapshot.version,
                "shard": shard, "shard_version": cur,
                "changed": changed, "draining": self._draining}

    # -- operator view ------------------------------------------------

    def debug_view(self) -> dict:
        """/debug/discovery payload: generation + cache occupancy/hit
        accounting, node-group counts, the scope plan's balance and
        stability, shard watch versions, push fan-out percentiles and
        the stage decomposition."""
        snap = self._snapshot
        with self._watch:
            shard_versions = list(self._shard_version)
            waiting = self._n_waiting
        lat = monitor.discovery_latency_snapshot()
        return {
            "generation": snap.version,
            "n_services": snap.n_services,
            "n_route_rules": snap.n_rules,
            "scope_shards": self._scope_shards,
            "scope_program": {
                "constrained_rules": snap.scope.n_constrained,
                "reused": snap.scope_reused,
                "digest": snap.scope.digest[:16],
            },
            "source_ports": sorted(snap.source_ports),
            "cache": self._cache.stats(),
            "pending_rds_groups": len(self._pending_rds),
            "plan": snap.plan.to_json(),
            "shard_versions": shard_versions,
            "watchers_waiting": waiting,
            "watch_cap": self._watch_cap,
            "last_publish": getattr(self, "_last_publish", None),
            "push": lat["push"],
            "stages": lat["stages"],
            "draining": self._draining,
        }

    # -- parity reference ---------------------------------------------

    def reference_bytes(self, path: str) -> bytes:
        """The UNSCOPED SINGLE-NODE generation path: rebuild the
        response for `path` directly from the LIVE registry/config
        store with the legacy per-node builders — no snapshot, no
        cache, no grouping, no batched admission. The tier-1 parity
        gate (scripts/discovery_smoke.py, tests) asserts served bytes
        are byte-identical to this."""
        parts = [p for p in path.split("/") if p]
        cfg = IstioConfigStore(self.config_store)
        if parts[1] == "registration":
            service_key = "/".join(parts[2:])
            hostname, _, rest = service_key.partition("|")
            port_name, _, label_str = rest.partition("|")
            labels = dict(kv.split("=", 1)
                          for kv in label_str.split(",") if "=" in kv)
            instances = self.registry.instances(
                hostname, (port_name,) if port_name else (), labels)
            return _dumps({"hosts": [
                {"ip_address": i.endpoint.address,
                 "port": i.endpoint.port,
                 "tags": {"az": i.availability_zone} if
                 i.availability_zone else {}}
                for i in instances]})
        node = parts[-1]
        role = Node.parse(node)
        # canonical colocated-instance order (snapshot.instance_order):
        # the live registry returns insertion order, which is process-
        # history state neither side of the parity gate may depend on
        live_instances = sorted(
            self.registry.host_instances({role.ip_address}),
            key=instance_order)
        if parts[1] == "clusters":
            services = self.registry.services()
            clusters = build_outbound_clusters(services, cfg)
            clusters += build_egress_clusters(cfg)
            clusters += build_jwks_clusters(cfg)
            if role.type == NODE_SIDECAR:
                clusters += build_inbound_clusters(live_instances)
            return _dumps({"clusters": clusters})
        if parts[1] == "routes":
            if role.type == NODE_INGRESS:
                return _dumps(build_ingress_route_config(
                    cfg, self.registry))
            hosts = sorted({i.service.hostname
                            for i in live_instances})
            source = hosts[0] if hosts else None
            return _dumps(build_route_config(
                self.registry.services(), int(parts[2]), cfg,
                source=source))
        if parts[1] == "listeners":
            services = self.registry.services()
            if role.type == NODE_INGRESS:
                listeners = build_ingress_listeners(
                    cfg, self.registry, self.mesh,
                    tls_context=self.mesh.get("ingress_tls"))
            else:
                listeners = build_outbound_listeners(services, cfg,
                                                     self.mesh)
                if role.type == NODE_SIDECAR:
                    listeners += build_inbound_listeners(
                        live_instances, self.mesh)
            return _dumps({"listeners": listeners})
        raise KeyError(path)

    # -- HTTP front ---------------------------------------------------

    def begin_drain(self) -> None:
        """Quiesce step 1+2 (admission → generation): new pulls answer
        typed UNAVAILABLE, config events stop publishing, and every
        parked watcher is released with its current version."""
        self._draining = True
        with self._watch:
            self._watch.notify_all()

    def start(self, address: str = "127.0.0.1", port: int = 0) -> int:
        ds = self
        self._draining = False
        if self._dirty:
            # events landed while drained: catch the snapshot up
            # before serving again
            self._dirty = False
            self.publish()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet
                log.debug("discovery: " + fmt, *args)

            def do_GET(self):
                try:
                    body, ctype = ds._route(self.path)
                except UnavailableError as exc:
                    body = json.dumps(
                        {"error": str(exc), "code": "UNAVAILABLE",
                         "grpc_code": exc.grpc_code}).encode()
                    self.send_response(503)
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                except KeyError:
                    self.send_error(404)
                    return
                except Exception:
                    log.exception("discovery handler failed")
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((address, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="pilot-discovery")
        self._thread.start()
        self.port = self._server.server_address[1]
        log.info("pilot discovery on port %d", self.port)
        return self.port

    def _route(self, path: str) -> tuple[bytes, str]:
        raw, _, query_str = path.partition("?")
        query = dict(parse_qsl(query_str))
        parts = [p for p in raw.split("/") if p]
        if parts == ["debug", "discovery"]:
            return (json.dumps(self.debug_view(), indent=1,
                               default=str).encode(),
                    "application/json")
        if self._draining:
            raise UnavailableError("discovery draining")
        if len(parts) >= 3 and parts[0] == "v1":
            if parts[1] == "registration":
                return (self.list_endpoints("/".join(parts[2:])),
                        "application/json")
            if parts[1] == "clusters" and len(parts) == 4:
                return (self.list_clusters(parts[2], parts[3]),
                        "application/json")
            if parts[1] == "routes" and len(parts) == 5:
                return (self.list_routes(parts[2], parts[3], parts[4]),
                        "application/json")
            if parts[1] == "listeners" and len(parts) == 4:
                return (self.list_listeners(parts[2], parts[3]),
                        "application/json")
            if parts[1] == "az" and len(parts) == 4:
                return (self.availability_zone(parts[2], parts[3]),
                        "text/plain")
            if parts[1] == "watch" and len(parts) == 4:
                try:
                    have = int(query.get("version", 0) or 0)
                except ValueError:
                    have = 0
                try:
                    timeout = float(query["timeout"]) \
                        if "timeout" in query else None
                except ValueError:
                    timeout = None
                return (json.dumps(self.watch(parts[3], have,
                                              timeout)).encode(),
                        "application/json")
        raise KeyError(path)

    def stop(self) -> None:
        """Ordered quiesce (PR 7 doctrine): admission off + watchers
        released (begin_drain) → generation off (events no-op while
        draining) → flush (the listener stops accepting and in-flight
        handlers finish) → join."""
        self.begin_drain()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
