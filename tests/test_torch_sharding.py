"""The port's sharded serving plane (istio_tpu_torch/sharding) against the
JAX package's.

Every scenario of tests/test_sharding.py runs on a server of each
package built from that package's own workloads (the fleet and store
generators are held equal first), and the outcomes must be equal:
CheckResponses in every field (global deny_rule included), quota
grants, rule counts by qualified name, plans, routing and rebuild
records. The planner's cost model, `costs_from_ruleset` and
`trivial_plan` equal the reference's, and `oracle_check_statuses`
agrees between packages on a 600-rule fleet world. The /debug/shards
view is not ported: its scenarios compare the records behind it (the
server's `_sharded` and `_rebuild_status`, the router's
`routing_stats()`). Last, the card's strict bank checkers: a bank
fault that CHAOS did not inject raises out of check_many, and a CHAOS
fault on one bank opens that bank's breaker alone. The port runs on
the CPU (plain versions of every kernel); values compared are ints,
bools, strings and the f32-min `valid_duration_s`, all exactly.
"""
import numpy as np
import pytest
import torch

from istio_tpu import sharding as ref_sharding
from istio_tpu.adapters.sdk import QuotaArgs as RefQuotaArgs
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.compiler import ruleset as ref_ruleset
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime import resilience as ref_resilience
from istio_tpu.runtime.store import Event as RefEvent
from istio_tpu.sharding import planner as ref_planner
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import sharding
from istio_tpu_torch.adapters.sdk import QuotaArgs
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.compiler import ruleset as pt_ruleset
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.runtime import monitor, resilience
from istio_tpu_torch.runtime.store import Event
from istio_tpu_torch.sharding import planner
from istio_tpu_torch.testing import workloads

FIELDS = ("status_code", "status_message", "valid_duration_s",
          "valid_use_count", "referenced", "referenced_presence",
          "deny_rule", "active_quota_rules")

# the reference server with the planes the port does not carry switched
# off where they would act behind the test's back
REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _chaos_off():
    """Both packages' CHAOS seams disarmed around every test (they are
    process-wide, and --dist loadfile shares workers)."""
    ref_resilience.CHAOS.reset()
    resilience.CHAOS.reset()
    yield
    ref_resilience.CHAOS.reset()
    resilience.CHAOS.reset()


def _servers(make_store, ref_kw=None, **kw):
    """(reference server, port server) over each package's own store
    from `make_store(workloads module)`; `kw` are ServerArgs of both,
    `manifest` the workloads attribute the manifest is taken from."""
    manifest = kw.pop("manifest", "MESH_MANIFEST")
    ref_extra = dict(ref_kw or {})
    rkw, pkw = dict(kw), dict(kw)
    if manifest:
        rkw["default_manifest"] = getattr(ref_workloads, manifest)
        pkw["default_manifest"] = getattr(workloads, manifest)
    ref = RefServer(make_store(ref_workloads),
                    RefArgs(**REF_ARGS, **rkw, **ref_extra))
    got = RuntimeServer(make_store(workloads),
                        ServerArgs(rulestats_drain_s=0, **pkw),
                        device="cpu")
    return ref, got


def _close(*servers):
    for s in servers:
        s.close()
        s.controller.store.close()


def _assert_same(want, got, fields=FIELDS):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        for f in fields:
            assert getattr(b, f) == getattr(a, f), (i, f)


def _bags_both(dicts):
    return [ref_bag(d) for d in dicts], [bag_from_mapping(d) for d in dicts]


def _result(q):
    return q.result() if hasattr(q, "result") else q


# ------------------------------------------------------- the workloads

@pytest.mark.parametrize("n,ns,seed,quota", [
    (90, 6, 3, False), (600, 24, 12, True), (2000, 64, 3, False)])
def test_fleet_workloads_match_reference(n, ns, seed, quota):
    """make_fleet_rules / make_fleet_store / make_fleet_traffic give the
    reference's rules, store documents and request dicts."""
    assert workloads.FLEET_ZIPF_A == ref_workloads.FLEET_ZIPF_A
    ref_rules = ref_workloads.make_fleet_rules(n, ns, seed=seed)
    got_rules = workloads.make_fleet_rules(n, ns, seed=seed)
    assert [(r.name, r.match, r.namespace) for r in got_rules] == \
        [(r.name, r.match, r.namespace) for r in ref_rules]
    rs = ref_workloads.make_fleet_store(n, ns, seed=seed, with_quota=quota)
    ps = workloads.make_fleet_store(n, ns, seed=seed, with_quota=quota)
    try:
        assert ps.list() == rs.list()
    finally:
        rs.close()
        ps.close()
    assert workloads.make_fleet_traffic(64, n, ns, seed=seed) == \
        ref_workloads.make_fleet_traffic(64, n, ns, seed=seed)


# ---------------------------------------------------------------- plan

def _fleet_preds(n=2000, ns=64, seed=3):
    return (ref_workloads.make_fleet_rules(n, ns, seed=seed),
            workloads.make_fleet_rules(n, ns, seed=seed))


def _plan_view(p):
    return (p.n_shards, p.ns_to_shard, p.shard_rules, p.global_rules,
            p.shard_cost, p.ns_cost, p.moved_ns, p.stability, p.revision)


def test_plan_covers_every_rule_exactly_once():
    ref_preds, preds = _fleet_preds()
    want = ref_sharding.plan_shards(ref_preds, ref_workloads.MESH_FINDER, 4)
    plan = sharding.plan_shards(preds, workloads.MESH_FINDER, 4)
    assert _plan_view(plan) == _plan_view(want)
    seen = {}
    for k, idxs in enumerate(plan.shard_rules):
        assert idxs == sorted(idxs)
        for i in idxs:
            seen.setdefault(i, []).append(k)
    assert sorted(seen) == list(range(len(preds)))
    for i, shards in seen.items():
        ns = preds[i].namespace
        if ns:
            assert shards == [plan.ns_to_shard[ns]], (i, ns)
        else:
            assert shards == list(range(plan.n_shards))


def test_plan_balances_skewed_namespaces():
    ref_preds, preds = _fleet_preds()
    plan = sharding.plan_shards(preds, workloads.MESH_FINDER, 4)
    want = ref_sharding.plan_shards(ref_preds, ref_workloads.MESH_FINDER, 4)
    bal = plan.balance()
    assert bal == want.balance()
    assert bal["max_over_mean_cost"] <= 1.5, bal
    assert bal["min_over_mean_cost"] >= 0.5, bal
    costs = np.asarray(sharding.predict_rule_costs(preds,
                                                   workloads.MESH_FINDER))
    ns_names = sorted({p.namespace for p in preds if p.namespace})
    rr_cost = np.zeros(4)
    for j, ns in enumerate(ns_names):
        rr_cost[j % 4] += sum(costs[i] for i, p in enumerate(preds)
                              if p.namespace == ns)
    assert max(plan.shard_cost) <= rr_cost.max() + 1e-9


def test_plan_deterministic_and_stable_hash_routing():
    ref_preds, preds = _fleet_preds(400, 16, seed=9)
    a = sharding.plan_shards(preds, workloads.MESH_FINDER, 3)
    b = sharding.plan_shards(preds, workloads.MESH_FINDER, 3)
    r = ref_sharding.plan_shards(ref_preds, ref_workloads.MESH_FINDER, 3)
    assert a.ns_to_shard == b.ns_to_shard == r.ns_to_shard
    assert a.shard_rules == b.shard_rules == r.shard_rules
    for ns in ("never-seen-ns", "ghost", "void7", ""):
        assert a.shard_of(ns) == b.shard_of(ns) == r.shard_of(ns)
    assert 0 <= a.shard_of("never-seen-ns") < 3
    for ns, k in a.ns_to_shard.items():
        assert a.shard_of(ns) == k


def test_cost_model_prices_host_fallback():
    def preds(mod):
        return [mod.Rule(name="eq", match='request.method == "GET"',
                         namespace="a"),
                mod.Rule(name="dyn",
                         match='"x".matches(request.path) || '
                               'match(request.path, request.host)',
                         namespace="a")]
    costs = sharding.predict_rule_costs(preds(pt_ruleset),
                                        workloads.MESH_FINDER)
    want = ref_sharding.predict_rule_costs(preds(ref_ruleset),
                                           ref_workloads.MESH_FINDER)
    assert costs.tolist() == want.tolist()
    assert 0 < costs[0] < planner.HOST_FALLBACK_COST


def test_costs_from_ruleset_matches_standalone_model():
    """The publish path prices rules from the retained compiled
    decomposition; it equals the reference's and the standalone
    predict_rule_costs model exactly. trivial_plan equals the
    reference's."""
    ref_preds, preds = _fleet_preds(600, 24, seed=12)
    rs = pt_ruleset.compile_ruleset(preds, workloads.MESH_FINDER,
                                    device="cpu")
    ref_rs = ref_ruleset.compile_ruleset(ref_preds,
                                         ref_workloads.MESH_FINDER,
                                         jit=False)
    got = planner.costs_from_ruleset(rs, workloads.MESH_FINDER)
    assert got.tolist() == ref_planner.costs_from_ruleset(
        ref_rs, ref_workloads.MESH_FINDER).tolist()
    assert got.tolist() == sharding.predict_rule_costs(
        preds, workloads.MESH_FINDER).tolist()
    for n in (0, 1, 3):
        assert _plan_view(planner.trivial_plan(n)) == \
            _plan_view(ref_planner.trivial_plan(n))
    assert planner.trivial_plan(3).shard_of("ns9") == \
        ref_planner.trivial_plan(3).shard_of("ns9")


def test_oracle_statuses_match_reference():
    """oracle_check_statuses of both packages agree row for row on a
    600-rule fleet world (the parity surface of chip_smoke phase 16)."""
    ref, got = _servers(
        lambda w: w.make_fleet_store(600, 24, seed=12), shards=2,
        batch_window_s=0.001, buckets=(16,), max_batch=16)
    try:
        dicts = workloads.make_fleet_traffic(96, 600, 24, seed=12)
        rb, pb = _bags_both(dicts)
        rd, pd = ref.controller.dispatcher, got.controller.dispatcher
        want = ref_sharding.oracle_check_statuses(rd.snapshot, rd.fused, rb)
        have = sharding.oracle_check_statuses(pd.snapshot, pd.fused, pb)
        assert have == want
        assert any(r["status"] for r in have)
        assert any(r["active"] for r in have)
        _assert_same(ref.check_many(rb), got.check_many(pb))
        served = got.check_many(pb)
        assert [(r.status_code, r.deny_rule) for r in served] == \
            [(w["status"], w["deny_rule"]) for w in have]
    finally:
        _close(ref, got)


# ------------------------------------------------- serving parity

N_RULES = 240
PAIR_KW = dict(batch_window_s=0.001, buckets=(16, 64), max_batch=64)


@pytest.fixture(scope="module")
def pair():
    """plain (monolithic) and sharded + replicated servers of each
    package over the SAME config — make_store's full action mix incl.
    host-overlay list shapes and host-fallback predicates."""
    def store(w):
        return w.make_store(N_RULES, host_overlay_every=10, seed=5)
    ref_plain, plain = _servers(store, **PAIR_KW)
    ref_sharded, sharded = _servers(store, shards=3, replicas=2, **PAIR_KW)
    yield ref_plain, plain, ref_sharded, sharded
    _close(ref_plain, plain, ref_sharded, sharded)


def _mixed_dicts(n=64, seed=6):
    return workloads.make_request_dicts(n, seed=seed)


def test_sharded_matches_monolithic_exactly(pair):
    ref_plain, plain, ref_sharded, sharded = pair
    assert sharded._sharded["mode"] == ref_sharded._sharded["mode"] == \
        "sharded"
    dicts = _mixed_dicts()
    assert dicts == ref_workloads.make_request_dicts(64, seed=6)
    rb, pb = _bags_both(dicts)
    want = ref_sharded.check_many(rb)
    got = sharded.check_many(pb)
    _assert_same(want, got)
    # the deny attribution folds back to GLOBAL rule indices, equal to
    # the monolithic server's (quota rule indices stay bank-local)
    _assert_same(plain.check_many(pb), got,
                 [f for f in FIELDS if f != "active_quota_rules"])
    _assert_same(ref_plain.check_many(rb), plain.check_many(pb))
    # traffic that hits its rules: device denies fold back to global
    # rule indices
    dicts, _ = workloads.make_hit_requests(N_RULES, 64, seed=7)
    rb, pb = _bags_both(dicts)
    got = sharded.check_many(pb)
    _assert_same(ref_sharded.check_many(rb), got)
    _assert_same(plain.check_many(pb), got,
                 [f for f in FIELDS if f != "active_quota_rules"])
    assert any(r.deny_rule >= 0 for r in got)


def test_sharded_through_replica_front(pair):
    ref_plain, plain, ref_sharded, sharded = pair
    dicts = _mixed_dicts(48, seed=8)
    rb, pb = _bags_both(dicts)
    want = plain.check_many(pb)
    stats0 = sharded.batcher.routing_stats()
    ref0 = ref_sharded.batcher.routing_stats()
    got = [f.result() for f in [sharded.batcher.submit(b) for b in pb]]
    ref_got = [f.result() for f in [ref_sharded.batcher.submit(b)
                                    for b in rb]]
    _assert_same(ref_got, got)
    _assert_same(want, got, ("status_code", "referenced", "deny_rule"))
    stats = sharded.batcher.routing_stats()
    refs = ref_sharded.batcher.routing_stats()
    assert stats["rows_total"] - stats0["rows_total"] == len(pb) == \
        refs["rows_total"] - ref0["rows_total"]
    assert {s: n - stats0["rows_per_shard"].get(s, 0)
            for s, n in stats["rows_per_shard"].items()} == \
        {s: n - ref0["rows_per_shard"].get(s, 0)
         for s, n in refs["rows_per_shard"].items()}
    assert stats["misrouted"] == refs["misrouted"] == 0
    assert sum(r.misrouted for r in sharded.batcher.routers) == 0


def test_host_overlay_rules_pinned_to_home_shard(pair):
    _, _, ref_sharded, sharded = pair

    def pinned(srv):
        state = srv._sharded
        snap = srv.controller.dispatcher.snapshot
        out = []
        for bank in state["banks"]:
            for local in sorted(bank.dispatcher.fused.host_actions):
                gidx = int(bank.local_to_global[local])
                ns = snap.ruleset.rules[gidx].namespace
                if ns:
                    assert state["plan"].ns_to_shard[ns] == bank.shard_id
                    out.append((bank.shard_id, gidx))
        return out

    got = pinned(sharded)
    assert got == pinned(ref_sharded)
    assert got, "workload lost its host-overlay rules"


def test_unknown_namespace_serves_global_rules_only(pair):
    ref_plain, plain, ref_sharded, sharded = pair
    d = {"destination.service": "svc0.nowhere-ns.svc.cluster.local",
         "source.user": "anon", "request.method": "GET"}
    rb, pb = _bags_both([d])
    got = sharded.check_many(pb)
    _assert_same(ref_sharded.check_many(rb), got)
    _assert_same(plain.check_many(pb), got, ("status_code", "referenced"))


def test_sticky_lane_routing(pair):
    _, _, ref_sharded, sharded = pair
    rb, pb = _bags_both(_mixed_dicts(32, seed=11))
    lanes = {}
    for r, b in zip(rb, pb):
        ns = b.get("destination.service")[0].split(".")[1]
        lane = sharded.batcher.lane_of(b)
        assert lane == ref_sharded.batcher.lane_of(r)
        assert lanes.setdefault(ns, lane) == lane, \
            "namespace bounced between lanes"
    assert len(set(lanes.values())) > 1, \
        "all namespaces collapsed onto one lane"


def test_rulestats_fan_across_banks(pair):
    """Per-rule telemetry from every bank merges into the one
    aggregator, name-keyed: the deltas equal the reference's and an
    oracle recount of hits."""
    _, _, ref_sharded, sharded = pair

    def deltas(srv, bags):
        srv.rulestats.drain()
        base = {k: dict(v) for k, v in srv.rulestats.counts().items()}
        srv.check_many(bags)
        srv.rulestats.drain()
        out = {}
        for name, c in srv.rulestats.counts().items():
            b = base.get(name, {})
            d = tuple(c[k] - b.get(k, 0) for k in ("hits", "denies",
                                                    "errors"))
            if any(d):
                out[name] = d
        return out

    rb, pb = _bags_both(_mixed_dicts(40, seed=13))
    got = deltas(sharded, pb)
    assert got == deltas(ref_sharded, rb)
    d = sharded.controller.dispatcher
    expected = sharding.oracle_check_statuses(d.snapshot, d.fused, pb)
    names = d.snapshot.qualified_rule_names()
    want_hits: dict[str, int] = {}
    for row in expected:
        for ridx in row["active"]:
            want_hits[names[ridx]] = want_hits.get(names[ridx], 0) + 1
    assert {n: v[0] for n, v in got.items() if v[0]} == want_hits


def test_router_chunks_over_bucket_batches():
    """A batch larger than the banks' largest warmed bucket chunks, and
    still returns every row in order."""
    ref, got = _servers(
        lambda w: w.make_fleet_store(90, 6, seed=3),
        batch_window_s=0.001, buckets=(8,), max_batch=32, shards=2,
        replicas=1)
    try:
        dicts = workloads.make_fleet_traffic(32, 90, 6, seed=3)
        rb, pb = _bags_both(dicts)
        k0 = monitor.SHARD_STAGE_SECONDS.count(stage="bank_check")
        have = got.check_many(pb)
        assert monitor.SHARD_STAGE_SECONDS.count(stage="bank_check") - k0 \
            == len({got._sharded["plan"].shard_of(
                b.get("destination.service")[0].split(".")[1])
                for b in pb})
        _assert_same(ref.check_many(rb), have)
        d = got.controller.dispatcher
        want = sharding.oracle_check_statuses(d.snapshot, d.fused, pb)
        for i, (g, w) in enumerate(zip(have, want)):
            assert g.status_code == w["status"], f"row {i}"
            assert g.deny_rule == w["deny_rule"], f"row {i}"
    finally:
        _close(ref, got)


def test_bank_device_fault_degrades_to_oracle_not_error():
    """A transient device-step fault inside a bank is absorbed by the
    bank's OWN resilience wrap (retry → breaker → the bank's CPU
    oracle): every request still answers correctly on both packages."""
    def scenario(srv, chaos, bag, sharding_mod):
        banks = srv._sharded["banks"]
        assert all(b.checker is not None for b in banks)
        assert [b.checker.breaker.name for b in banks] == \
            [f"bank:{b.shard_id}" for b in banks]
        bags = [bag(d) for d in
                workloads.make_fleet_traffic(16, 90, 6, seed=6)]
        srv.check_many(bags)
        chaos.reset()
        chaos.device_failures = 2
        try:
            got = [f.result() for f in [srv.batcher.submit(b)
                                        for b in bags]]
        finally:
            injected = chaos.injected_device
            chaos.reset()
        assert injected > 0, "chaos seam never fired in a bank step"
        d = srv.controller.dispatcher
        want = sharding_mod.oracle_check_statuses(d.snapshot, d.fused,
                                                  bags)
        return [g.status_code for g in got], [w["status"] for w in want]

    ref, got = _servers(
        lambda w: w.make_fleet_store(90, 6, seed=6),
        batch_window_s=0.001, buckets=(16,), max_batch=16, shards=2,
        replicas=2, device_retry=False)
    try:
        r = scenario(ref, ref_resilience.CHAOS, ref_bag, ref_sharding)
        p = scenario(got, resilience.CHAOS, bag_from_mapping, sharding)
        assert p[0] == p[1] == r[0] == r[1]
    finally:
        _close(ref, got)


def test_config_swap_continuity():
    """A config swap rebuilds the banks and every lane serves the NEW
    snapshot — no dropped requests, no stale verdicts."""
    kw = dict(batch_window_s=0.001, buckets=(16,), max_batch=16,
              shards=2, replicas=2)
    ref, got = _servers(lambda w: w.make_fleet_store(120, 8, seed=2), **kw)
    try:
        dicts = workloads.make_fleet_traffic(24, 120, 8, seed=2)
        rb, pb = _bags_both(dicts)
        before = got.check_many(pb)
        _assert_same(ref.check_many(rb), before)
        assert any(r.status_code == 0 for r in before)
        rev0 = got._sharded["revision"]
        spec = {"match": "",
                "actions": [{"handler": "denyall",
                             "instances": ["nothing"]}]}
        # quiet apply + one explicit rebuild: a debounced watch rebuild
        # would race the ledger read below
        key = ("rule", "istio-system", "deny-world")
        for srv, event in ((ref, RefEvent), (got, Event)):
            srv.controller.store.apply_events([event(key, dict(spec))],
                                              notify=False)
            srv.controller.rebuild()
        assert got._sharded["revision"] > rev0
        after = [f.result() for f in [got.batcher.submit(b) for b in pb]]
        ref_after = [f.result() for f in [ref.batcher.submit(b)
                                          for b in rb]]
        _assert_same(ref_after, after)
        assert all(r.status_code != 0 for r in after)
        assert len(after) == len(before)
        assert got.batcher.routing_stats()["misrouted"] == 0
        # the swap rebuilt every bank: the replicated global rule
        # changed every bank's content
        assert got._rebuild_status["banks_recompiled"] == 2
    finally:
        _close(ref, got)


def test_global_quota_rule_routes_to_shared_pool():
    """A default-namespace quota rule replicates into every bank, but
    allocation happens ONCE per request from the one controller-owned
    pool — grants equal the monolithic server's and the reference's."""
    kw = dict(batch_window_s=0.001, buckets=(16,), max_batch=16)

    def store(w):
        return w.make_fleet_store(60, 6, seed=4, with_quota=True)
    ref_plain, plain = _servers(store, **kw)
    ref_sharded, sharded = _servers(store, shards=3, replicas=2, **kw)
    try:
        for bank in sharded._sharded["banks"]:
            assert any(r.name == "quota-rule" for r in bank.snapshot.rules)
            assert bank.dispatcher.fused.quota_actions
        seen = []
        for d in workloads.make_fleet_traffic(12, 60, 6, seed=4):
            grants = []
            for srv, bag, qa in ((ref_plain, ref_bag, RefQuotaArgs),
                                 (ref_sharded, ref_bag, RefQuotaArgs),
                                 (plain, bag_from_mapping, QuotaArgs),
                                 (sharded, bag_from_mapping, QuotaArgs)):
                b = bag(d)
                r = srv.check_many([b])[0]
                q = _result(srv.quota_fused(b, "rq.istio-system",
                                            qa(quota_amount=3), r))
                assert q is not None
                grants.append((q.granted_amount, q.status_code))
            assert len(set(grants)) == 1, grants
            seen.append(grants[0])
        assert any(g == 3 for g, _ in seen)
        pools = {id(p) for p in sharded.controller.device_quotas.values()}
        assert len(pools) == 1
    finally:
        _close(ref_plain, plain, ref_sharded, sharded)


def test_instep_quota_refused_under_sharding():
    ref, got = _servers(
        lambda w: w.make_fleet_store(30, 4, seed=1, with_quota=True),
        batch_window_s=0.001, buckets=(16,), max_batch=16, shards=2,
        quota_in_step=True)
    try:
        assert got.instep_quota_target() is None
        assert ref.instep_quota_target() is None
    finally:
        _close(ref, got)


def test_rbac_snapshot_falls_back_to_replica_only():
    """Device-lowered rbac pseudo-rules reference absolute ruleset
    rows — such snapshots refuse to shard and serve replica-only,
    verdict-identical to the monolithic path and to the reference."""
    kw = dict(batch_window_s=0.001, buckets=(16,), max_batch=16,
              manifest=None)
    ref, got = _servers(lambda w: w.make_rbac_store(40), shards=2,
                        replicas=2, **kw)
    plain = RuntimeServer(workloads.make_rbac_store(40),
                          ServerArgs(rulestats_drain_s=0,
                                     batch_window_s=0.001, buckets=(16,),
                                     max_batch=16), device="cpu")
    try:
        st = got._sharded
        assert st["mode"] == ref._sharded["mode"] == "replica-only"
        assert st["fallback_reason"] == ref._sharded["fallback_reason"]
        assert "pseudo-rule" in st["fallback_reason"]
        assert got._sharded["banks"][0].dispatcher is \
            got.controller.dispatcher
        dicts = workloads.make_rbac_request_dicts(24)
        assert dicts == ref_workloads.make_rbac_request_dicts(24)
        rb, pb = _bags_both(dicts)
        have = got.check_many(pb)
        _assert_same(ref.check_many(rb), have)
        _assert_same(plain.check_many(pb), have)
    finally:
        _close(ref, got, plain)


def _records(srv) -> dict:
    """The data behind the reference's /debug/shards view, less wall
    times and the backend-sized bank_bytes."""
    st = srv._sharded
    plan = st["plan"].to_json()
    plan.pop("plan_wall_ms")
    banks = []
    for b in st["banks"]:
        s = b.stats()
        assert s.pop("bank_bytes") > 0
        banks.append(s)
    rebuild = dict(srv._rebuild_status)
    rebuild.pop("last_wall_s")
    return {"mode": st["mode"], "reason": st["fallback_reason"],
            "revision": st["revision"], "delta": st["delta"],
            "plan": plan, "banks": banks, "rebuild": rebuild,
            "routing": srv.batcher.routing_stats(),
            "replicas": srv.batcher.stats()["n_replicas"]}


def test_shard_records_zero_shaped_and_live():
    """The `_sharded` / `_rebuild_status` records and the routing
    aggregate (what /debug/shards renders): zero-shaped before traffic,
    live after, equal to the reference's."""
    ref, got = _servers(
        lambda w: w.make_fleet_store(40, 4, seed=8),
        batch_window_s=0.001, buckets=(16,), max_batch=16, shards=2,
        replicas=2)
    try:
        v = _records(got)
        assert v == _records(ref)
        assert v["mode"] == "sharded" and v["replicas"] == 2
        assert v["routing"]["rows_total"] == 0
        assert v["routing"]["misrouted"] == 0
        assert len(v["banks"]) == 2
        assert v["rebuild"]["rebuilds"] == 1
        assert v["rebuild"]["banks_recompiled"] == 2
        dicts = workloads.make_fleet_traffic(16, 40, 4, seed=8)
        rb, pb = _bags_both(dicts)
        [f.result() for f in [got.batcher.submit(b) for b in pb]]
        [f.result() for f in [ref.batcher.submit(b) for b in rb]]
        v = _records(got)
        assert v == _records(ref)
        assert v["routing"]["rows_total"] == len(pb)
        assert v["plan"]["balance"]["n_shards"] == 2
    finally:
        _close(ref, got)


def test_monolithic_server_reports_shards_disabled():
    ref, got = _servers(lambda w: w.make_fleet_store(20, 4, seed=1),
                        batch_window_s=0.001, buckets=(16,), max_batch=16)
    try:
        for srv in (ref, got):
            assert srv._sharded is None and srv._replica_router is None
        assert got._rebuild_status == ref._rebuild_status
        assert got.controller.warm_parent_plans
    finally:
        _close(ref, got)


def test_server_argument_checks_match_reference():
    """shards / replicas / fused / mesh_shape checks raise the
    reference's ValueError messages; the four fields are carried."""
    from istio_tpu_torch.runtime.server import CARRIED_ARGS

    assert {"shards", "replicas", "delta_compile",
            "shard_rebalance_budget"} <= CARRIED_ARGS
    store = workloads.make_fleet_store(8, 2)
    ref_store = ref_workloads.make_fleet_store(8, 2)
    try:
        for kw in (dict(shards=-1), dict(replicas=0),
                   dict(shards=2, fused=False),
                   dict(replicas=2, mesh_shape=(1, 1))):
            with pytest.raises(ValueError) as want:
                RefServer(ref_store, RefArgs(**REF_ARGS, **kw))
            with pytest.raises(ValueError) as have:
                RuntimeServer(store, ServerArgs(**kw), device="cpu")
            assert str(have.value) == str(want.value), kw
    finally:
        store.close()
        ref_store.close()


# ------------------------------------- the card's strict bank checkers

def _strict_banks(srv) -> None:
    """Make every bank checker of a CPU server strict, as a card
    server's are (strict_device = device.type == "cuda")."""
    for b in srv._sharded["banks"]:
        assert b.checker.strict_device is False
        b.checker.strict_device = True


def test_strict_bank_checker_raises_a_real_fault():
    """A bank fault that CHAOS did not inject raises out of check_many
    on a strict checker: no retry, no oracle answer, no breaker
    failure."""
    srv = RuntimeServer(workloads.make_fleet_store(90, 6, seed=6),
                        ServerArgs(batch_window_s=0.001, buckets=(16,),
                                   max_batch=16, shards=2, replicas=2,
                                   rulestats_drain_s=0,
                                   default_manifest=workloads.MESH_MANIFEST),
                        device="cpu")
    try:
        _strict_banks(srv)
        bags = [bag_from_mapping(d) for d in
                workloads.make_fleet_traffic(16, 90, 6, seed=6)]
        want = srv.check_many(bags)
        victim = srv._sharded["banks"][0]
        plan = victim.dispatcher.fused
        oracle_calls = []
        real_oracle = victim.checker.oracle
        victim.checker.oracle = lambda *a, **k: (
            oracle_calls.append(1), real_oracle(*a, **k))[1]

        def broken(*a, **k):
            raise RuntimeError("kernel launch failed")

        c0 = monitor.resilience_counters()
        plan.packed_check = broken
        try:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                srv.check_many(bags)
        finally:
            del plan.packed_check
        c1 = monitor.resilience_counters()
        assert oracle_calls == []
        assert victim.checker.breaker.state == "closed"
        assert c1["device_retries_total"] == c0["device_retries_total"]
        assert c1["fallback_total"] == c0["fallback_total"]
        _assert_same(want, srv.check_many(bags))
    finally:
        srv.close()
        srv.controller.store.close()


def test_chaos_fault_opens_one_bank_breaker_alone():
    """A CHAOS-injected fault on one bank (a strict checker takes it like
    the reference): that bank's breaker opens, its oracle answers, its
    sibling stays closed and serves on the device."""
    srv = RuntimeServer(workloads.make_fleet_store(90, 6, seed=6),
                        ServerArgs(batch_window_s=0.001, buckets=(16,),
                                   max_batch=16, shards=2,
                                   device_retry=False, breaker_failures=1,
                                   breaker_reset_s=60.0,
                                   rulestats_drain_s=0,
                                   default_manifest=workloads.MESH_MANIFEST),
                        device="cpu")
    try:
        _strict_banks(srv)
        plan = srv._sharded["plan"]
        dicts = workloads.make_fleet_traffic(32, 90, 6, seed=6)
        bags = [bag_from_mapping(d) for d in dicts]
        shard_of = [plan.shard_of(b.get("destination.service")[0]
                                  .split(".")[1]) for b in bags]
        one = [b for b, s in zip(bags, shard_of) if s == shard_of[0]]
        rest = [b for b, s in zip(bags, shard_of) if s != shard_of[0]]
        assert one and rest
        want = srv.check_many(bags)
        resilience.CHAOS.device_failures = 1
        got_one = srv.check_many(one)
        assert resilience.CHAOS.injected_device == 1
        states = {b.shard_id: b.checker.breaker.state
                  for b in srv._sharded["banks"]}
        assert states[shard_of[0]] == "open"
        assert [s for k, s in states.items() if k != shard_of[0]] == \
            ["closed"]
        d = srv.controller.dispatcher
        oracle = sharding.oracle_check_statuses(d.snapshot, d.fused, one)
        assert [r.status_code for r in got_one] == \
            [w["status"] for w in oracle]
        # the whole batch: the open bank answers from its oracle, the
        # closed one from the device; statuses equal the healthy run's
        got = srv.check_many(bags)
        assert [r.status_code for r in got] == [r.status_code for r in want]
        assert resilience.CHAOS.injected_device == 1
    finally:
        srv.close()
        srv.controller.store.close()
