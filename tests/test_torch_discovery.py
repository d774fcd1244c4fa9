"""Pilot's discovery service on the port against the JAX package's, on the
CPU: tests/test_discovery.py's scenarios run on both packages'
DiscoveryService over one world — make_discovery_world's registry and
store, carried across with interop.discovery_world_from_reference — with
every mutation applied to both. Compared after each step: the served
payload bytes of every node and endpoint, the cache accounting (hits,
misses, carried entries, invalidations), the publish audit, the
node-group and pending-group sets, the scope plan and its stability,
watch results, and the HTTP front. The port's RDS admission runs the
route scope program (the plain versions here, device="cpu"); the
rule_match kernel's word formulation over that program's tables equals
the reference program's run.

Every payload is bytes and every count an int: the tolerance is exact
equality."""
import json
import threading
import time
import urllib.request

import numpy as np

import pytest

from istio_tpu.pilot import discovery as ref_discovery
from istio_tpu.pilot.discovery import DiscoveryService as RefDS
from istio_tpu.pilot.model import (Config as RefConfig,
                                   ConfigMeta as RefMeta, Port as RefPort,
                                   Service as RefService)
from istio_tpu.pilot.snapshot import changed_scopes as ref_changed_scopes
from istio_tpu.runtime import monitor as ref_monitor
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop, kernels
from istio_tpu_torch.pilot import discovery
from istio_tpu_torch.pilot.discovery import DiscoveryService
from istio_tpu_torch.pilot.model import Config, ConfigMeta, Port, Service
from istio_tpu_torch.pilot.snapshot import MESH_SCOPE, changed_scopes
from istio_tpu_torch.runtime import monitor
from istio_tpu_torch.testing import workloads

WORLD = dict(n_services=24, n_namespaces=6, replicas=2, source_ns=2, seed=3)


class Pair:
    """One world on both packages: the reference's registry / store and
    the port's copies, and a DiscoveryService on each."""

    def __init__(self, registry, store, nodes, meta, **kw):
        self.ref_registry, self.ref_store = registry, store
        self.registry, self.store = \
            interop.discovery_world_from_reference(registry, store)
        self.nodes, self.meta = nodes, meta
        self.ref = RefDS(registry, store, **kw)
        self.port = DiscoveryService(self.registry, self.store,
                                     device="cpu", **kw)

    def both(self):
        return (self.ref, self.port)

    def route(self, path: str) -> bytes:
        a, b = self.ref._route(path)[0], self.port._route(path)[0]
        assert a == b, path
        return b

    def same_state(self) -> None:
        r, p = self.ref, self.port
        assert p.generation == r.generation
        assert p._cache.stats() == r._cache.stats()
        assert sorted(map(repr, p._cache._entries)) == \
            sorted(map(repr, r._cache._entries))
        assert p._pending_rds == r._pending_rds
        assert p._shard_version == r._shard_version
        assert p.snapshot.plan.ns_to_shard == r.snapshot.plan.ns_to_shard
        assert p.snapshot.plan.stability == r.snapshot.plan.stability
        assert p.snapshot.scope_digests == r.snapshot.scope_digests
        assert p.snapshot.scope.digest == r.snapshot.scope.digest
        assert p.snapshot.scope_reused == r.snapshot.scope_reused
        lr = getattr(r, "_last_publish", None)
        lp = getattr(p, "_last_publish", None)
        assert (lr is None) == (lp is None)
        if lr is not None:
            assert {k: v for k, v in lp.items() if k != "build_wall_ms"} \
                == {k: v for k, v in lr.items() if k != "build_wall_ms"}

    def add_service(self, hostname, address, port, endpoints):
        self.ref_registry.add_service(
            RefService(hostname=hostname, address=address,
                       ports=(RefPort(*port),)), endpoints)
        self.registry.add_service(
            Service(hostname=hostname, address=address,
                    ports=(Port(*port),)), endpoints)

    def remove_service(self, hostname):
        self.ref_registry.remove_service(hostname)
        self.registry.remove_service(hostname)

    def churn(self, k: int, tick: int) -> None:
        a = ref_workloads.churn_discovery_rule(self.ref_store, self.meta, k,
                                               tick)
        b = workloads.churn_discovery_rule(self.store, self.meta, k, tick)
        assert a == b

    def poll_all(self, replicas: int = 2) -> None:
        for idx, n in enumerate(self.nodes):
            k = self.meta["ns_of"][idx // replicas]
            self.route(f"/v1/routes/{8000 + k}/c/{n}")
            self.route(f"/v1/clusters/c/{n}")

    def close(self) -> None:
        for ds in self.both():
            ds.stop()


@pytest.fixture()
def pair():
    p = Pair(*ref_workloads.make_discovery_world(**WORLD))
    yield p
    p.close()


def test_scope_program_words_match_reference(pair):
    """The discovery snapshot's scope program (one rule per constrained
    source identity): rule_match's word formulation over the port's
    tables equals the reference program's run on an admission batch of
    every source, unknown and empty ones among them."""
    from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.compiler import ruleset as pt_rs
    (ref_prog, ref_tz) = pair.ref.snapshot.scope._program
    (prog, tz) = pair.port.snapshot.scope._program
    rows = [{"source.service": s} for s in
            list(pair.port.snapshot.scope._sources) + ["ghost", ""]]
    want = [np.asarray(a) for a in ref_prog(ref_tz.tensorize(
        [ref_bag(r) for r in rows]))]
    seen = {}
    real = pt_rs.rule_match

    def spy(*args):
        seen["args"] = args[:6]
        return real(*args)
    pt_rs.rule_match = spy
    try:
        prog(tz.tensorize([bag_from_mapping(r) for r in rows]))
    finally:
        pt_rs.rule_match = real
    got = pt_rs.rule_match_words_plain(*seen["args"])
    for name, w, h in zip(pt_rs.PLANES, want, got):
        np.testing.assert_array_equal(h.numpy(), w, err_msg=name)
    assert want[0].any() and not want[0].all()


def test_discovery_worlds_built_by_both_packages_agree():
    registry, store, nodes, meta = workloads.make_discovery_world(**WORLD)
    r_registry, r_store, r_nodes, r_meta = \
        ref_workloads.make_discovery_world(**WORLD)
    c_registry, c_store = interop.discovery_world_from_reference(r_registry,
                                                                 r_store)
    assert nodes == r_nodes and meta == r_meta
    assert registry.services() == c_registry.services()
    for s in registry.services():
        assert registry.instances(s.hostname) == \
            c_registry.instances(s.hostname)
    assert store.snapshot() == c_store.snapshot()


def test_every_node_and_endpoint_serves_equal_bytes(pair):
    """Every sidecar's RDS / CDS / LDS, every service's SDS keys, the
    AZ, an ingress node, and the unscoped reference_bytes path — equal
    bytes and equal cache accounting; the call counters and the stage
    and cache monitors move alike; the RDS admission ran the plain
    version (no kernel launch on the CPU)."""
    calls0 = dict(discovery.CALLS.series)
    rcalls0 = {(ep, c): ref_discovery.CALLS.labels(
        endpoint=ep, cache=c)._value.get() for ep, c in calls0}
    base = monitor.discovery_stage_baseline()
    rbase = ref_monitor.discovery_stage_baseline()
    kernels.launches.reset()
    meta = pair.meta
    for rounds in range(2):           # the second round is all hits
        for idx, n in enumerate(pair.nodes):
            k = meta["ns_of"][idx // WORLD["replicas"]]
            for path in (f"/v1/routes/{8000 + k}/c/{n}",
                         f"/v1/clusters/c/{n}", f"/v1/listeners/c/{n}",
                         f"/v1/az/c/{n}"):
                pair.route(path)
        for s in pair.registry.services():
            for key in (f"{s.hostname}|http", f"{s.hostname}",
                        f"{s.hostname}|http|version=v1"):
                pair.route(f"/v1/registration/{key}")
        pair.same_state()
    ingress = "ingress~10.99.0.1~gw.istio-system~cluster.local"
    for path in (f"/v1/routes/80/c/{ingress}",
                 f"/v1/listeners/c/{ingress}", f"/v1/clusters/c/{ingress}"):
        assert pair.route(path) == pair.port.reference_bytes(path)
    for n in pair.nodes[::5]:
        path = f"/v1/clusters/c/{n}"
        assert pair.port.reference_bytes(path) == \
            pair.ref.reference_bytes(path)
    pair.same_state()
    got = {key: v - calls0[key] for key, v in discovery.CALLS.series.items()}
    want = {key: ref_discovery.CALLS.labels(endpoint=key[0], cache=key[1])
            ._value.get() - rcalls0[key] for key in calls0}
    assert got == want and got[("rds", "hit")] > 0
    stages = monitor.discovery_latency_snapshot(base)["stages"]
    rstages = ref_monitor.discovery_latency_snapshot(rbase)["stages"]
    assert {s: v["count"] for s, v in stages.items()} == \
        {s: v["count"] for s, v in rstages.items()}
    assert kernels.launches["rule_match"] == 0


def test_one_service_change_keeps_unrelated_entries_live(pair):
    pair.poll_all()
    meta = pair.meta
    ks = sorted(meta["nodes_by_ns"])
    churn_k, victim_k = ks[-1], ks[-2]
    victim_node = meta["nodes_by_ns"][victim_k][0]
    victim_host = meta["hosts_by_ns"][victim_k][0]
    pair.route(f"/v1/registration/{victim_host}|http")
    pair.add_service(f"late.ns{churn_k}.svc.cluster.local", "10.9.9.9",
                     ("http", 8000 + churn_k, "HTTP"), [("10.9.9.10", {})])
    assert pair.port.generation == 2
    pair.same_state()
    h0 = pair.port._cache.stats()["hits"]
    pair.route(f"/v1/routes/{8000 + victim_k}/c/{victim_node}")
    assert pair.port._cache.stats()["hits"] == h0 + 1
    m0 = pair.port._cache.stats()["misses"]
    pair.route(f"/v1/registration/{victim_host}|http")
    assert pair.port._cache.stats()["misses"] == m0
    churn_node = meta["nodes_by_ns"][churn_k][0]
    path = f"/v1/routes/{8000 + churn_k}/c/{churn_node}"
    raw = pair.route(path)
    assert any(v["name"].startswith(f"late.ns{churn_k}")
               for v in json.loads(raw)["virtual_hosts"])
    assert raw == pair.port.reference_bytes(path)
    pair.same_state()


def test_identical_sidecars_share_one_generated_config(pair):
    k = pair.meta["ns_of"][0]
    a = pair.route(f"/v1/routes/{8000 + k}/c/{pair.nodes[0]}")
    h0 = pair.port._cache.stats()["hits"]
    b = pair.route(f"/v1/routes/{8000 + k}/c/{pair.nodes[1]}")
    assert a == b and pair.port._cache.stats()["hits"] == h0 + 1
    pair.same_state()


def test_batched_pending_generation_fills_all_groups(pair):
    """One miss regenerates every pending RDS group in one batch, with
    one admit_rows call (one rule_match step on the card) on each side."""
    pair.poll_all()
    meta = pair.meta
    src_k = 0 if meta["rules_by_ns"].get(0) else 1
    pair.churn(src_k, 0)
    pair.same_state()
    assert len(pair.port._pending_rds) >= 1
    calls = []
    scope = pair.port.snapshot.scope
    admit = scope.admit_rows
    scope.admit_rows = lambda sources: calls.append(len(sources)) or \
        admit(sources)
    try:
        pair.route(f"/v1/routes/{8000 + src_k}/c/"
                   f"{meta['nodes_by_ns'][src_k][0]}")
    finally:
        del scope.admit_rows
    assert len(calls) == 1 and not pair.port._pending_rds
    for n in meta["nodes_by_ns"][src_k][1:]:
        pair.route(f"/v1/routes/{8000 + src_k}/c/{n}")
    pair.same_state()


def test_source_scoped_rds_groups_match_reference(pair):
    meta = pair.meta
    src_k = 0 if meta["rules_by_ns"].get(0) else 1
    bodies = set()
    for n in meta["nodes_by_ns"][src_k]:
        path = f"/v1/routes/{8000 + src_k}/c/{n}"
        got = pair.route(path)
        assert got == pair.port.reference_bytes(path) == \
            pair.ref.reference_bytes(path)
        bodies.add(got)
    assert len(bodies) > 1
    pair.same_state()


def test_hold_publishes_coalesces_a_churn_batch(pair):
    g0 = pair.port.generation
    with pair.ref.hold_publishes(), pair.port.hold_publishes():
        for tick in range(4):
            pair.churn(max(pair.meta["rules_by_ns"]), tick)
    assert pair.port.generation == g0 + 1
    pair.same_state()


def test_changed_scopes_and_plan_stability(pair):
    snaps = [(pair.ref.snapshot, pair.port.snapshot)]
    churn_k = max(pair.meta["rules_by_ns"])
    pair.churn(churn_k, 0)
    snaps.append((pair.ref.snapshot, pair.port.snapshot))
    (r1, p1), (r2, p2) = snaps
    assert changed_scopes(p1, p2) == ref_changed_scopes(r1, r2) == \
        {f"ns{churn_k}"}
    for ns, shard in p1.plan.ns_to_shard.items():
        assert p2.plan.ns_to_shard[ns] == shard
    assert p2.scope_reused and p2.scope is p1.scope
    assert p2.plan.balance() == r2.plan.balance()
    pair.same_state()


def _watch_both(pair, node, timeout, act=None, delay=0.2):
    """Park a watcher on each service, run `act`, → (ref result, port
    result)."""
    out = {}

    def park(tag, ds):
        out[tag] = ds.watch(node, ds.generation, timeout)

    threads = [threading.Thread(target=park, args=(t, ds))
               for t, ds in (("ref", pair.ref), ("port", pair.port))]
    for t in threads:
        t.start()
    time.sleep(delay)
    if act is not None:
        act()
    for t in threads:
        t.join(timeout=timeout + 10)
        assert not t.is_alive()
    return out["ref"], out["port"]


def test_watch_scoped_wake_and_drain_release(pair):
    meta = pair.meta
    churn_k = max(meta["rules_by_ns"])
    snap = pair.port.snapshot
    churn_shard = snap.plan.shard_of(f"ns{churn_k}")
    other = next(ns_nodes[0] for k, ns_nodes
                 in sorted(meta["nodes_by_ns"].items())
                 if snap.plan.shard_of(f"ns{k}") != churn_shard)
    res = {}

    def churn_and_other():
        res["other"] = [ds.watch(other, ds.generation, 0.5)
                        for ds in pair.both()]
        pair.churn(churn_k, 0)

    ref, port = _watch_both(pair, meta["nodes_by_ns"][churn_k][0], 10.0,
                            churn_and_other)
    assert ref == port and port["changed"] is True
    r_other, p_other = res["other"]
    assert r_other == p_other and p_other["changed"] is False
    ref, port = _watch_both(pair, meta["nodes_by_ns"][churn_k][0], 30.0,
                            lambda: [ds.begin_drain()
                                     for ds in pair.both()], delay=0.1)
    assert ref == port and port["draining"] is True


def test_start_stop_cycles_serve_equal_bytes(pair):
    for cycle in range(4):
        bodies = []
        for ds in pair.both():
            port = ds.start()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/clusters/c/"
                    f"{pair.nodes[cycle]}", timeout=10) as r:
                assert r.status == 200, cycle
                bodies.append(r.read())
            ds.stop()
        assert bodies[0] == bodies[1]
        assert bodies[1] == pair.port.reference_bytes(
            f"/v1/clusters/c/{pair.nodes[cycle]}")


def test_draining_front_answers_unavailable(pair):
    port = pair.port.start()
    pair.port.begin_drain()
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/clusters/c/{pair.nodes[0]}",
            timeout=10)
    assert err.value.code == 503
    assert json.loads(err.value.read())["code"] == "UNAVAILABLE"
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/discovery",
                                timeout=10) as r:
        view = json.loads(r.read())
    assert view["draining"] is True and view["generation"] == 1


def test_events_during_drain_republish_on_restart(pair):
    gens = []
    for ds in pair.both():
        ds.start()
        gens.append(ds.generation)
        ds.stop()
    pair.add_service("late.ns0.svc.cluster.local", "10.9.9.9",
                     ("http", 8000, "HTTP"), [("10.9.9.10", {})])
    assert [ds.generation for ds in pair.both()] == gens
    for ds in pair.both():
        ds.start()
    assert [ds.generation for ds in pair.both()] == [g + 1 for g in gens]
    body = pair.route(f"/v1/clusters/c/{pair.nodes[0]}")
    assert b"late.ns0" in body
    pair.same_state()


def _empty_pair():
    from istio_tpu.pilot.model import MemoryConfigStore as RefStore
    from istio_tpu.pilot.registry import MemoryRegistry as RefRegistry
    return Pair(RefRegistry(), RefStore(), [], {})


def test_cross_namespace_port_join_invalidates_rds():
    p = _empty_pair()
    try:
        p.add_service("a.ns1.svc.cluster.local", "10.0.0.1",
                      ("http", 9000, "HTTP"), [("10.1.0.1", {})])
        node = "sidecar~10.1.0.1~a-0.ns1~cluster.local"
        path = "/v1/routes/9000/c/" + node
        before = p.route(path)
        p.add_service("b.ns2.svc.cluster.local", "10.0.0.2",
                      ("http", 9000, "HTTP"), [("10.1.0.2", {})])
        assert 9000 in set(p.port._last_publish["changed_ports"])
        after = p.route(path)
        assert after != before and b"b.ns2.svc.cluster.local" in after
        assert after == p.port.reference_bytes(path)
        p.same_state()
    finally:
        p.close()


def test_multi_service_node_canonical_instance_order():
    node = "sidecar~10.1.0.9~multi.ns1~cluster.local"
    served = []
    for order in (("zeta", "alpha"), ("alpha", "zeta")):
        p = _empty_pair()
        try:
            for name in order:
                port = ("tcp", 9000, "TCP") if name == "zeta" else \
                    ("http", 9001, "HTTP")
                p.add_service(f"{name}.ns1.svc.cluster.local",
                              "10.0.0.1" if name == "zeta" else "10.0.0.2",
                              port, [("10.1.0.9", {}, "zone-" + name)])
            for path in (f"/v1/listeners/c/{node}",
                         f"/v1/clusters/c/{node}"):
                got = p.route(path)
                assert got == p.port.reference_bytes(path)
                served.append(got)
            assert p.port.availability_zone("c", node) == \
                p.ref.availability_zone("c", node)
        finally:
            p.close()
    assert served[:2] == served[2:]


def test_watch_over_capacity_degrades_to_polling():
    p = Pair(*ref_workloads.make_discovery_world(**WORLD), watch_cap=2)
    try:
        done = []

        def park(ds, node):
            done.append(ds.watch(node, ds.generation, 3.0))

        threads = [threading.Thread(target=park, args=(ds, n))
                   for ds in p.both() for n in p.nodes[:2]]
        for t in threads:
            t.start()
        time.sleep(0.3)
        thirds = [ds.watch(p.nodes[2], ds.generation, 30.0)
                  for ds in p.both()]
        assert thirds[0] == thirds[1]
        assert thirds[1]["over_capacity"] is True
        assert thirds[1]["changed"] is False
        for ds in p.both():
            ds.begin_drain()
        for t in threads:
            t.join(timeout=5)
            assert not t.is_alive()
        assert len(done) == 4
    finally:
        p.close()


def test_deleted_namespace_wakes_its_old_shard(pair):
    meta = pair.meta
    victim_k = max(meta["hosts_by_ns"])
    node = meta["nodes_by_ns"][victim_k][0]

    def delete_namespace():
        with pair.ref.hold_publishes(), pair.port.hold_publishes():
            for name in meta["rules_by_ns"].get(victim_k, ()):
                pair.ref_store.delete("route-rule", name, f"ns{victim_k}")
                pair.store.delete("route-rule", name, f"ns{victim_k}")
            for host in meta["hosts_by_ns"][victim_k]:
                pair.remove_service(host)

    ref, port = _watch_both(pair, node, 10.0, delete_namespace)
    assert ref == port and port["changed"] is True
    assert f"ns{victim_k}" not in pair.port.snapshot.plan.ns_to_shard
    pair.same_state()


def test_hold_during_drain_keeps_dirty_for_restart(pair):
    for ds in pair.both():
        ds.start()
        ds.stop()
    gen = pair.port.generation
    with pair.ref.hold_publishes(), pair.port.hold_publishes():
        pair.churn(max(pair.meta["rules_by_ns"]), 0)
    assert pair.port.generation == pair.ref.generation == gen
    for ds in pair.both():
        ds.start()
    assert pair.port.generation == pair.ref.generation == gen + 1
    pair.same_state()


def test_clear_cache_still_available(pair):
    pair.route(f"/v1/clusters/c/{pair.nodes[0]}")
    assert pair.port.cache_size == pair.ref.cache_size > 0
    for ds in pair.both():
        ds.clear_cache()
    assert pair.port.cache_size == 0
    pair.same_state()


def test_mesh_scope_changes_invalidate_mesh_entries(pair):
    pair.poll_all()
    spec = {"destination": {"service": "httpbin.org"},
            "ports": [{"port": 8000, "protocol": "http"}]}
    pair.ref_store.create(RefConfig(
        RefMeta(type="egress-rule", name="eg", namespace="default"),
        dict(spec)))
    pair.store.create(Config(
        ConfigMeta(type="egress-rule", name="eg", namespace="default"),
        dict(spec)))
    assert MESH_SCOPE in set(pair.port._last_publish["changed_scopes"])
    assert pair.port._last_publish["shards_notified"] == \
        list(range(pair.port._scope_shards))
    assert pair.port.cache_size == 0
    pair.same_state()
    pair.poll_all()
    pair.same_state()


def test_churn_rounds_keep_payloads_and_scope_program(pair):
    """Eight rounds of one-namespace churn (chip_smoke's phase 11 at a
    small size): after each, every sidecar's RDS equal, and the scope
    program carried while its digest holds."""
    pair.poll_all()
    ks = sorted(pair.meta["rules_by_ns"])
    for tick in range(8):
        prev = pair.port.snapshot.scope
        pair.churn(ks[tick % len(ks)], tick)
        assert pair.port.snapshot.scope is prev
        pair.poll_all()
        pair.same_state()


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_plan_shards_matches_reference(n_shards):
    """The port's planner (scratch mode with its own per-rule cost model,
    then delta mode with a bounded rebalance) against the reference's on
    the fleet rules, carried across as the port's Rule."""
    from istio_tpu.sharding import planner as ref_planner

    from istio_tpu_torch.compiler.ruleset import Rule
    from istio_tpu_torch.sharding import planner

    ref_rules = ref_workloads.make_fleet_rules(240, 12, seed=5)
    rules = [Rule(r.name, r.match, r.namespace) for r in ref_rules]
    ref_finder = ref_workloads.MESH_FINDER
    finder = workloads.MESH_FINDER
    costs = planner.predict_rule_costs(rules, finder)
    assert list(costs) == list(ref_planner.predict_rule_costs(
        ref_rules, ref_finder))
    plan = planner.plan_shards(rules, finder, n_shards)
    ref = ref_planner.plan_shards(ref_rules, ref_finder, n_shards)
    for f in ("ns_to_shard", "shard_rules", "global_rules", "shard_cost",
              "ns_cost", "moved_ns", "stability"):
        assert getattr(plan, f) == getattr(ref, f), f
    assert plan.balance() == ref.balance()
    grown = rules + [Rule(f"x{i}", 'source.namespace == "nsX"', "nsX")
                     for i in range(30)]
    ref_grown = ref_rules + [type(ref_rules[0])(
        f"x{i}", 'source.namespace == "nsX"', "nsX") for i in range(30)]
    delta = planner.plan_shards(grown, finder, n_shards, prev=plan,
                                rebalance_budget=2)
    ref_delta = ref_planner.plan_shards(ref_grown, ref_finder, n_shards,
                                        prev=ref, rebalance_budget=2)
    for f in ("ns_to_shard", "shard_rules", "moved_ns", "stability"):
        assert getattr(delta, f) == getattr(ref_delta, f), f
    assert delta.shard_of("unseen") == ref_delta.shard_of("unseen")
    with pytest.raises(planner.ShardPlanError):
        planner.plan_shards(rules, finder, 0)


def test_served_payloads_validate_under_the_envoy_schema(pair):
    """Every RDS / CDS / LDS payload the port serves passes the port's
    strict Envoy v1 schema (pilot/envoy_schema.py), as the reference's
    pass the reference's; a malformed listener fails both."""
    from istio_tpu.pilot import envoy_schema as ref_es

    from istio_tpu_torch.pilot import envoy_schema as es

    meta = pair.meta
    for idx, n in enumerate(pair.nodes[::3]):
        k = meta["ns_of"][3 * idx // WORLD["replicas"]]
        es.validate_route_config(json.loads(
            pair.route(f"/v1/routes/{8000 + k}/c/{n}")))
        es.validate_clusters(json.loads(
            pair.route(f"/v1/clusters/c/{n}"))["clusters"])
        listeners = json.loads(
            pair.route(f"/v1/listeners/c/{n}"))["listeners"]
        es.validate_listeners(listeners)
        ref_es.validate_listeners(listeners)
    bad = [dict(listeners[0], bogus_field=1)]
    with pytest.raises(es.EnvoySchemaError):
        es.validate_listeners(bad)
    with pytest.raises(ref_es.EnvoySchemaError):
        ref_es.validate_listeners(bad)


def test_publish_chaos_delay_holds_parked_watchers(pair):
    """The discovery publish seam (CHAOS.discovery_publish): an armed
    delay holds the publish, and with it a parked watcher's wake, on
    both packages; each delayed publish is counted."""
    from istio_tpu.runtime.resilience import CHAOS as REF_CHAOS

    from istio_tpu_torch.runtime.resilience import CHAOS

    churn_k = max(pair.meta["rules_by_ns"])
    node = pair.meta["nodes_by_ns"][churn_k][0]
    counts0 = (REF_CHAOS.injected_discovery, CHAOS.injected_discovery)
    REF_CHAOS.discovery_push_delay_s = CHAOS.discovery_push_delay_s = 0.3
    try:
        t0 = time.perf_counter()
        ref, port = _watch_both(pair, node, 10.0,
                                lambda: pair.churn(churn_k, 0), delay=0.1)
        held = time.perf_counter() - t0
    finally:
        REF_CHAOS.discovery_push_delay_s = CHAOS.discovery_push_delay_s = 0.0
    assert ref == port and port["changed"] is True
    assert held >= 0.1 + 2 * 0.3
    assert (REF_CHAOS.injected_discovery - counts0[0],
            CHAOS.injected_discovery - counts0[1]) == (1, 1)
    pair.same_state()
