"""Delta compilation of the port's sharded serving plane against the JAX
package's.

- the delta planner (tests/test_delta_compile.py's four planner cases):
  equal plans, stability accounting and bounded rebalance;
- shard sub-snapshots: each bank's rule list and local→global map equal
  the reference's, and the bank's compiled arrays equal a cache-free
  reference compile of the same rule list (the reference's DecompCache
  can permute the fused conjunction columns; the port has none);
- bank content keys: the same shards change their keys under the same
  edit in both packages (a one-rule constant edit changes exactly the
  owning shard's key, an instance edit every bank that references it),
  and the hex digests are equal wherever every digested leaf renders
  alike (the test names a leaf that does not);
- a delta republish at unit size: one bank recompiled, the others
  carried as the same compiled objects in shallow copies with their own
  index maps, the probe flipped, the rebuild ledger and the grant
  revocation scoped to the delta equal to the reference's; a rebuild
  that fails on a later bank leaves the serving generation untouched;
- `Controller(warm_parent_plans=False)`: the parent plan is never
  warmed and never runs a trip; every bank plan is warmed before the
  lanes see it; replica-only lanes with the rule-stats fan.
"""
import json

import numpy as np
import pytest
import torch

from istio_tpu import sharding as ref_sharding
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.compiler import ruleset as ref_ruleset
from istio_tpu.compiler.layout import InternTable as RefInternTable
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
from istio_tpu.runtime.store import Event as RefEvent
from istio_tpu.sharding import banks as ref_banks
from istio_tpu.sharding import planner as ref_planner
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import sharding
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.compiler import ruleset as pt_ruleset
from istio_tpu_torch.compiler.layout import InternTable
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.runtime.fused import FusedPlan
from istio_tpu_torch.runtime.store import Event
from istio_tpu_torch.sharding import banks, planner
from istio_tpu_torch.testing import workloads

REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)
INDEX_PARAMS = ("lit_idx", "conj_m_idx", "conj_n_idx", "eqc_col", "eqc_cid",
                "eqc_xor", "eqc_pad")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _preds(mod, n: int, n_ns: int):
    return [mod.Rule(name=f"r{i}",
                     match=f'destination.service == "s{i}.cluster"',
                     namespace=f"ns{i % n_ns}")
            for i in range(n)]


def _plan_view(p):
    return (p.n_shards, p.ns_to_shard, p.shard_rules, p.global_rules,
            p.shard_cost, p.ns_cost, p.moved_ns, p.stability, p.revision)


def _both_plans(ref_preds, preds, n, **kw):
    """plan_shards on both packages; `prev` is a (ref, port) pair."""
    prev = kw.pop("prev", (None, None))
    want = ref_sharding.plan_shards(ref_preds, ref_workloads.MESH_FINDER, n,
                                    prev=prev[0], **kw)
    got = sharding.plan_shards(preds, workloads.MESH_FINDER, n,
                               prev=prev[1], **kw)
    assert _plan_view(got) == _plan_view(want)
    return want, got


# ---------------------------------------------------------------- plan

def test_delta_plan_pure_edit_moves_nothing():
    rp, pp = _preds(ref_ruleset, 1024, 512), _preds(pt_ruleset, 1024, 512)
    base = _both_plans(rp, pp, 8)
    re_, pe = list(rp), list(pp)
    match = 'destination.service == "other.cluster" && request.method == "GET"'
    re_[0] = ref_ruleset.Rule(name="r0", match=match, namespace="ns0")
    pe[0] = pt_ruleset.Rule(name="r0", match=match, namespace="ns0")
    _, p2 = _both_plans(re_, pe, 8, prev=base)
    assert p2.stability["mode"] == "delta"
    assert p2.moved_ns == []
    assert p2.ns_to_shard == base[1].ns_to_shard
    for ns in list(base[1].ns_to_shard)[:64] + ["ghost-a", "ghost-b"]:
        assert p2.shard_of(ns) == base[1].shard_of(ns)


def test_delta_plan_single_add_and_remove():
    rp, pp = _preds(ref_ruleset, 1024, 512), _preds(pt_ruleset, 1024, 512)
    base = _both_plans(rp, pp, 8)
    new = ("newr", "connection.mtls", "brand-new-ns")
    _, p2 = _both_plans(rp + [ref_ruleset.Rule(*new)],
                        pp + [pt_ruleset.Rule(*new)], 8, prev=base)
    for ns, k in base[1].ns_to_shard.items():
        assert p2.ns_to_shard[ns] == k
    assert "brand-new-ns" in p2.ns_to_shard
    assert p2.stability["new"] == 1 and p2.moved_ns == []
    _, p3 = _both_plans([p for p in rp if p.namespace != "ns5"],
                        [p for p in pp if p.namespace != "ns5"], 8,
                        prev=base)
    assert "ns5" not in p3.ns_to_shard
    for ns, k in p3.ns_to_shard.items():
        assert base[1].ns_to_shard[ns] == k
    assert p3.stability["removed"] == 1 and p3.moved_ns == []


def test_delta_plan_rebalance_budget_is_bounded():
    import dataclasses

    rp, pp = _preds(ref_ruleset, 256, 32), _preds(pt_ruleset, 256, 32)
    base = _both_plans(rp, pp, 4)
    skew = tuple(dataclasses.replace(
        b, ns_to_shard={ns: 0 for ns in b.ns_to_shard}) for b in base)
    _, p0 = _both_plans(rp, pp, 4, prev=skew, rebalance_budget=0)
    assert p0.moved_ns == []
    _, p3 = _both_plans(rp, pp, 4, prev=skew, rebalance_budget=3)
    assert 0 < len(p3.moved_ns) <= 3
    assert p3.stability["moved"] == p3.moved_ns
    assert p3.stability["moved_kept"] == p3.moved_ns
    assert p3.stability["kept"] == \
        len(skew[1].ns_to_shard) - len(p3.moved_ns)
    assert max(p3.shard_cost) < max(p0.shard_cost)
    drift = {ns for ns in skew[1].ns_to_shard
             if p3.ns_to_shard[ns] != skew[1].ns_to_shard[ns]}
    assert drift == set(p3.moved_ns)


def test_delta_plan_shard_width_change_replans_from_scratch():
    rp, pp = _preds(ref_ruleset, 128, 16), _preds(pt_ruleset, 128, 16)
    base = _both_plans(rp, pp, 4)
    _, p2 = _both_plans(rp, pp, 8, prev=base)
    assert p2.stability.get("mode") != "delta"
    assert p2.n_shards == 8


def test_plan_with_ruleset_costs_matches_reference():
    """The publish path's plan: plan_shards over costs_from_ruleset of the
    compiled snapshot, in scratch mode and in delta mode with a bounded
    rebalance, equal to the reference's."""
    import dataclasses

    rs, ps, rstore, pstore = _snapshots(
        lambda w: w.make_fleet_store(600, 24, seed=12))
    try:
        rp = rs.ruleset.rules[:rs.n_config_rules]
        pp = ps.ruleset.rules[:ps.n_config_rules]
        rc = ref_planner.costs_from_ruleset(rs.ruleset, rs.finder)
        pc = planner.costs_from_ruleset(ps.ruleset, ps.finder)
        assert pc.tolist() == rc.tolist()
        base = _both_plans(rp, pp, 4, costs=None)
        scratch = (ref_sharding.plan_shards(rp, rs.finder, 4, costs=rc),
                   sharding.plan_shards(pp, ps.finder, 4, costs=pc))
        assert _plan_view(scratch[1]) == _plan_view(scratch[0])
        assert scratch[1].ns_to_shard == base[1].ns_to_shard
        skew = tuple(dataclasses.replace(
            p, ns_to_shard={ns: 0 for ns in p.ns_to_shard})
            for p in scratch)
        for budget in (0, 2, 5):
            want = ref_sharding.plan_shards(rp, rs.finder, 4, costs=rc,
                                            prev=skew[0],
                                            rebalance_budget=budget)
            got = sharding.plan_shards(pp, ps.finder, 4, costs=pc,
                                       prev=skew[1],
                                       rebalance_budget=budget)
            assert _plan_view(got) == _plan_view(want)
            assert len(got.moved_ns) <= budget
    finally:
        rstore.close()
        pstore.close()


# ------------------------------------------------------ shard snapshots

def _snapshots(make_store):
    """(reference snapshot, port snapshot) of each package's own store,
    the reference's built without its DecompCache."""
    rb = RefBuilder(ref_workloads.MESH_MANIFEST, RefInternTable())
    rb.decomp_cache = None
    rs, ps = make_store(ref_workloads), make_store(workloads)
    return (rb.build(rs), SnapshotBuilder(workloads.MESH_MANIFEST,
                                          InternTable(),
                                          device="cpu").build(ps), rs, ps)


def _parent_plans(rs, ps, n):
    want = ref_sharding.plan_shards(rs.ruleset.rules[:rs.n_config_rules],
                                    rs.finder, n)
    got = sharding.plan_shards(ps.ruleset.rules[:ps.n_config_rules],
                               ps.finder, n)
    assert _plan_view(got) == _plan_view(want)
    return want, got


@pytest.mark.parametrize("world", ["fleet", "overlay"])
def test_shard_snapshots_match_reference(world):
    """Each bank's rule list and local→global map equal the reference's,
    and its arrays a cache-free reference compile of the same rules."""
    make = {"fleet": lambda w: w.make_fleet_store(240, 8, seed=3),
            "overlay": lambda w: w.make_store(120, host_overlay_every=10,
                                              seed=5)}[world]
    rs, ps, rstore, pstore = _snapshots(make)
    try:
        want_plan, plan = _parent_plans(rs, ps, 3)
        for k in range(3):
            sub, l2g = banks.shard_snapshot(ps, plan, k)
            # the parent snapshot carries no DecompCache: the reference's
            # bank compile is cache-free
            assert rs.decomp_cache is None
            ref_sub, ref_l2g = ref_banks.shard_snapshot(rs, want_plan, k)
            idxs = want_plan.shard_rules[k]
            np.testing.assert_array_equal(l2g, ref_l2g)
            np.testing.assert_array_equal(l2g, np.asarray(idxs, np.int64))
            assert [(r.name, r.namespace, r.match) for r in sub.rules] == \
                [(r.name, r.namespace, r.match) for r in ref_sub.rules] == \
                [(rs.rules[i].name, rs.rules[i].namespace,
                  rs.rules[i].match) for i in idxs]
            assert sub.n_config_rules == ref_sub.n_config_rules == len(idxs)
            assert sub.compile_kwargs == ps.compile_kwargs
            assert sub.ruleset.device == ps.ruleset.device
            ref_rs = ref_sub.ruleset
            got = sub.ruleset
            for name in INDEX_PARAMS:
                np.testing.assert_array_equal(
                    got.params[name].numpy(), np.asarray(ref_rs.params[name]),
                    err_msg=f"bank {k} {name}")
            np.testing.assert_array_equal(got.rule_ns, ref_rs.rule_ns)
            np.testing.assert_array_equal(got.attr_mask, ref_rs.attr_mask)
            assert got.ns_ids == ref_rs.ns_ids
            assert got.host_fallback.keys() == ref_rs.host_fallback.keys()
            assert got.geometry.items() >= ref_rs.geometry.items()
            # the retained decomposition the planner prices from
            assert got.per_rule_dnf == ref_rs.per_rule_dnf
        assert ps.ruleset.per_rule_dnf == rs.ruleset.per_rule_dnf
    finally:
        rstore.close()
        pstore.close()


def test_rbac_snapshot_refuses_to_shard():
    from istio_tpu.attribute.global_dict import \
        GLOBAL_MANIFEST as REF_GLOBAL
    from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST

    rb = RefBuilder(REF_GLOBAL, RefInternTable())
    rstore = ref_workloads.make_rbac_store(12)
    pstore = workloads.make_rbac_store(12)
    try:
        rs = rb.build(rstore)
        ps = SnapshotBuilder(GLOBAL_MANIFEST, InternTable(),
                             device="cpu").build(pstore)
        assert ps.n_config_rules == rs.n_config_rules
        assert len(ps.ruleset.rules) == len(rs.ruleset.rules) > \
            ps.n_config_rules
        plan = sharding.plan_shards(ps.ruleset.rules[:ps.n_config_rules],
                                    ps.finder, 2)
        want = ref_sharding.plan_shards(
            rs.ruleset.rules[:rs.n_config_rules], rs.finder, 2)
        with pytest.raises(ref_sharding.ShardingUnsupported) as r:
            ref_sharding.shard_snapshot(rs, want, 0)
        with pytest.raises(sharding.ShardingUnsupported) as p:
            sharding.shard_snapshot(ps, plan, 0)
        assert str(p.value) == str(r.value)
    finally:
        rstore.close()
        pstore.close()


# ------------------------------------------------------------ bank keys

KEY_KW = dict(identity_attr="destination.service", buckets=(16,),
              rule_telemetry=False)


def _keys(mod, snap, plan):
    static = mod.snapshot_static_digest(snap, **KEY_KW)
    return [mod.bank_content_key(snap, plan, k, static)
            for k in range(plan.n_shards)]


def _leaves_alike(rs, ps) -> list:
    """The digested leaves of the static digest whose renderings differ
    between the packages (none for these worlds)."""
    from istio_tpu.compiler.cache import manifest_digest as ref_md
    from istio_tpu_torch.compiler.cache import manifest_digest

    out = [k for k in sorted(rs.compile_kwargs)
           if json.dumps(rs.compile_kwargs[k], sort_keys=True, default=str)
           != json.dumps(ps.compile_kwargs.get(k), sort_keys=True,
                         default=str)]
    if ref_md(rs.finder) != manifest_digest(ps.finder):
        out.append("manifest")
    return out


def _edit(stores, key, spec):
    for store, event in zip(stores, (RefEvent, Event)):
        store.apply_events([event(key, dict(spec))], notify=False)


def test_bank_content_keys_deterministic_and_delta_scoped():
    def make(w):
        return w.make_fleet_store(240, 8, seed=3)
    rs1, ps1, rstore, pstore = _snapshots(make)
    try:
        assert _leaves_alike(rs1, ps1) == []
        plan1 = _parent_plans(rs1, ps1, 4)
        keys1 = _keys(banks, ps1, plan1[1])
        assert keys1 == _keys(ref_banks, rs1, plan1[0])
        assert len(set(keys1)) == 4
        # same store, fresh build → identical plan + keys
        rs2, ps2, _, _ = _snapshots(lambda w: rstore if w is ref_workloads
                                    else pstore)
        plan2 = _both_plans(rs2.ruleset.rules[:rs2.n_config_rules],
                            ps2.ruleset.rules[:ps2.n_config_rules], 4,
                            prev=plan1)
        assert plan2[1].ns_to_shard == plan1[1].ns_to_shard
        assert _keys(banks, ps2, plan2[1]) == keys1
        # constant-only edit of one rule → exactly its shard's key flips
        key = next(k for k in pstore.list("rule") if k[1] == "ns1")
        spec = dict(pstore.get(key))
        spec["match"] = spec["match"].replace('"svc', '"edited-svc', 1)
        _edit((rstore, pstore), key, spec)
        rs3, ps3, _, _ = _snapshots(lambda w: rstore if w is ref_workloads
                                    else pstore)
        plan3 = _both_plans(rs3.ruleset.rules[:rs3.n_config_rules],
                            ps3.ruleset.rules[:ps3.n_config_rules], 4,
                            prev=plan1)
        keys3 = _keys(banks, ps3, plan3[1])
        assert keys3 == _keys(ref_banks, rs3, plan3[0])
        changed = [k for k in range(4) if keys3[k] != keys1[k]]
        assert changed == [plan1[1].shard_of("ns1")]
    finally:
        rstore.close()
        pstore.close()


def test_bank_content_keys_track_instance_edits():
    def make(w):
        return w.make_fleet_store(240, 8, seed=3)
    rs1, ps1, rstore, pstore = _snapshots(make)
    try:
        plan = _parent_plans(rs1, ps1, 4)
        keys1 = _keys(banks, ps1, plan[1])
        # the denier's checknothing instance is referenced from every
        # bank — editing it must invalidate all
        _edit((rstore, pstore), ("instance", "istio-system", "nothing"),
              {"template": "checknothing", "params": {"x": 1}})
        rs2, ps2, _, _ = _snapshots(lambda w: rstore if w is ref_workloads
                                    else pstore)
        keys2 = _keys(banks, ps2, plan[1])
        assert keys2 == _keys(ref_banks, rs2, plan[0])
        assert all(a != b for a, b in zip(keys1, keys2))
    finally:
        rstore.close()
        pstore.close()


# ------------------------------------------------ the delta republish

N, NS, SHARDS = 400, 16, 4
DELTA_KW = dict(batch_window_s=0.001, max_batch=16, buckets=(16,),
                shards=SHARDS, replicas=1, rule_telemetry=False,
                initial_prewarm=False, check_grants=True)


def _delta_servers():
    ref = RefServer(ref_workloads.make_fleet_store(N, NS, seed=7),
                    RefArgs(**REF_ARGS,
                            **{k: v for k, v in DELTA_KW.items()
                               if k != "initial_prewarm"},
                            default_manifest=ref_workloads.MESH_MANIFEST))
    got = RuntimeServer(workloads.make_fleet_store(N, NS, seed=7),
                        ServerArgs(**DELTA_KW, rulestats_drain_s=0,
                                   default_manifest=workloads.MESH_MANIFEST),
                        device="cpu")
    return ref, got


def _probe():
    """scripts/delta_smoke.py's probe: a denier rule with a
    source-namespace literal that a constant-only edit can swap."""
    from istio_tpu_torch.testing.workloads import _fleet_ns_assignment
    probe_i = next(i for i in range(0, N, 12) if i % 3 == 0 and i % 4 < 2)
    ns = f"ns{int(_fleet_ns_assignment(N, NS, 7)[probe_i])}"
    bag = {"destination.service": f"svc{probe_i}.{ns}.svc.cluster.local",
           "source.namespace": "probe-team", "source.user": "sidecar-probe",
           "request.method": "GET", "connection.mtls": True,
           "request.path": "/probe"}
    return probe_i, ns, bag


def _ledger(srv) -> dict:
    st = dict(srv._rebuild_status)
    st.pop("last_wall_s")
    return {"status": st, "delta": srv._sharded["delta"],
            "mode": srv._sharded["mode"],
            "revision": srv._sharded["revision"]}


def test_delta_republish_recompiles_one_bank():
    ref, got = _delta_servers()
    try:
        assert _ledger(got) == _ledger(ref)
        st = got._rebuild_status
        assert (st["rebuilds"], st["banks_reused"],
                st["banks_recompiled"]) == (1, 0, SHARDS)
        plan0 = got._sharded["plan"]
        banks0 = {b.shard_id: b for b in got._sharded["banks"]}
        l2g0 = {k: b.local_to_global for k, b in banks0.items()}
        old_router = got.batcher.routers[0]
        probe_i, probe_ns, probe = _probe()
        dicts = workloads.make_fleet_traffic(64, N, NS, seed=7)
        assert got.check_many([bag_from_mapping(probe)])[0].status_code == 7
        key = ("rule", probe_ns, f"fleet{probe_i}")
        spec = dict(got.controller.store.get(key))
        locked = f'"locked{probe_i % 5}"'
        assert locked in spec["match"]
        spec["match"] = spec["match"].replace(locked, '"probe-team"')
        g0 = (got.grants.generation, ref.grants.generation)
        for srv, event in ((ref, RefEvent), (got, Event)):
            srv.controller.store.apply_events([event(key, dict(spec))],
                                              notify=False)
            srv.controller.rebuild()
        assert _ledger(got) == _ledger(ref)
        want_shard = plan0.shard_of(probe_ns)
        delta = got._sharded["delta"]
        assert delta["recompiled"] == [want_shard]
        assert delta["reused"] == [k for k in range(SHARDS)
                                   if k != want_shard]
        assert (got._rebuild_status["banks_reused"],
                got._rebuild_status["banks_recompiled"]) == (SHARDS - 1, 1)
        plan1 = got._sharded["plan"]
        assert plan1.ns_to_shard == plan0.ns_to_shard
        assert plan1.stability == {
            "mode": "delta", "kept": len(plan0.ns_to_shard), "new": 0,
            "removed": 0, "moved": [], "moved_kept": [],
            "rebalance_budget": 0}
        assert plan1.stability == ref._sharded["plan"].stability
        carried = {b.shard_id: b for b in got._sharded["banks"]}
        for k in range(SHARDS):
            if k == want_shard:
                assert carried[k].dispatcher is not banks0[k].dispatcher
                assert carried[k].content_key != banks0[k].content_key
                continue
            # shallow copies: the compiled artifact shared, the index
            # map the new generation's own; the old generation's router
            # keeps the original objects
            assert carried[k] is not banks0[k]
            assert carried[k].dispatcher is banks0[k].dispatcher
            assert carried[k].checker is banks0[k].checker
            assert carried[k].snapshot is banks0[k].snapshot
            assert carried[k].local_to_global is not l2g0[k]
            assert old_router.banks[k] is banks0[k]
            assert old_router.banks[k].local_to_global is l2g0[k]
            np.testing.assert_array_equal(carried[k].local_to_global,
                                          plan1.shard_rules[k])
        # grant revocation scoped to the changed shard's namespaces
        assert (got.grants.generation, ref.grants.generation) == \
            (g0[0] + 1, g0[1] + 1)
        want_ns = {ns for ns, s in plan1.ns_to_shard.items()
                   if s == want_shard}
        assert set(got.grants._ns_change) == set(ref.grants._ns_change) \
            == want_ns
        assert got.check_many([bag_from_mapping(probe)])[0].status_code == 0
        assert ref.check_many([ref_bag(probe)])[0].status_code == 0
        pb = [bag_from_mapping(d) for d in dicts]
        have = got.check_many(pb)
        d = got.controller.dispatcher
        want = sharding.oracle_check_statuses(d.snapshot, d.fused, pb)
        assert [(r.status_code, r.deny_rule) for r in have] == \
            [(w["status"], w["deny_rule"]) for w in want]
        assert [(r.status_code, r.deny_rule) for r in
                ref.check_many([ref_bag(x) for x in dicts])] == \
            [(r.status_code, r.deny_rule) for r in have]
    finally:
        for srv in (ref, got):
            srv.close()
            srv.controller.store.close()


def test_failed_rebuild_keeps_the_serving_generation(monkeypatch):
    """A rebuild whose second bank compile fails publishes nothing of
    the sharded generation: routers, banks and plan stay as they were,
    the ledger records the error (as the reference's), grants revoke
    globally, and serving answers from the old generation."""
    import istio_tpu.sharding as ref_pkg
    import istio_tpu_torch.sharding as pt_pkg

    ref, got = _delta_servers()
    try:
        dicts = workloads.make_fleet_traffic(32, N, NS, seed=7)
        before = got.check_many([bag_from_mapping(d) for d in dicts])
        for pkg in (ref_pkg, pt_pkg):
            real = pkg.compile_shard_bank
            calls = {"n": 0}

            def failing(*a, _real=real, _calls=calls, **k):
                _calls["n"] += 1
                if _calls["n"] == 2:
                    raise RuntimeError("bank compile failed")
                return _real(*a, **k)
            monkeypatch.setattr(pkg, "compile_shard_bank", failing)
        state0, routers0 = got._sharded, list(got.batcher.routers)
        # a global rule changes every bank's content
        spec = {"match": 'request.method == "DELETE"',
                "actions": [{"handler": "denyall", "instances": []}]}
        key = ("rule", "istio-system", "global-edit")
        for srv, event in ((ref, RefEvent), (got, Event)):
            srv.controller.store.apply_events([event(key, dict(spec))],
                                              notify=False)
            srv.controller.rebuild()
        assert _ledger(got) == _ledger(ref)
        st = got._rebuild_status
        assert st["errors"] == 1 and st["rebuilds"] == 1
        assert st["last_error"] == "RuntimeError: bank compile failed"
        assert st["last_error_revision"] == \
            got.controller.dispatcher.snapshot.revision == 2
        assert got._sharded is state0
        assert got.batcher.routers == routers0
        assert got.grants._global_change > 0
        after = got.check_many([bag_from_mapping(d) for d in dicts])
        assert [(r.status_code, r.deny_rule) for r in after] == \
            [(r.status_code, r.deny_rule) for r in before]
    finally:
        for srv in (ref, got):
            srv.close()
            srv.controller.store.close()


# ------------------------------------------- the parent plan never runs

def test_parent_plan_never_warmed_or_run(monkeypatch):
    """Under sharding the controller neither warms nor runs the parent
    plan (Controller(warm_parent_plans=False)); every bank plan is warmed
    at every serving shape before set_routers, and serving runs only
    bank plans."""
    ran: list = []
    real = FusedPlan.packed_check

    def spy(self, *a, **k):
        ran.append(id(self))
        return real(self, *a, **k)

    monkeypatch.setattr(FusedPlan, "packed_check", spy)
    srv = RuntimeServer(workloads.make_fleet_store(120, 8, seed=2),
                        ServerArgs(shards=2, buckets=(8, 16), max_batch=16,
                                   rulestats_drain_s=0,
                                   default_manifest=workloads.MESH_MANIFEST),
                        device="cpu")
    try:
        assert srv.controller.warm_parent_plans is False
        parent = srv.controller.dispatcher.fused
        bank_plans = [b.dispatcher.fused for b in srv._sharded["banks"]]
        assert id(parent) not in ran
        for p in bank_plans:
            # every bucket (one byte tier in this world) warmed
            assert ran.count(id(p)) == 2
            assert p._warmed_shapes
        ran.clear()
        srv.check_many([bag_from_mapping(d) for d in
                        workloads.make_fleet_traffic(40, 120, 8, seed=2)])
        assert ran and id(parent) not in ran
        assert set(ran) <= {id(p) for p in bank_plans}
        # the lanes' virtual devices: the CPU has no stream
        assert [r.lane.id for r in srv.batcher.routers] == [0]
        assert srv.batcher.routers[0].lane.stream is None
    finally:
        srv.close()
        srv.controller.store.close()


def test_replica_only_lanes_and_rulestats_fan():
    """shards=0, replicas=2: lane 0 rides the published dispatcher, lane
    1 its own plan; responses and name-keyed rule counts equal a server
    without replicas and the reference's replica-only server."""
    kw = dict(batch_window_s=0.001, buckets=(16,), max_batch=16)
    ref = RefServer(ref_workloads.make_store(120, seed=4),
                    RefArgs(**REF_ARGS, replicas=2, **kw))
    got = RuntimeServer(workloads.make_store(120, seed=4),
                        ServerArgs(replicas=2, rulestats_drain_s=0, **kw),
                        device="cpu")
    plain = RuntimeServer(workloads.make_store(120, seed=4),
                          ServerArgs(rulestats_drain_s=0, **kw),
                          device="cpu")
    try:
        st = got._sharded
        assert st["mode"] == ref._sharded["mode"] == "replica-only"
        assert st["fallback_reason"] == ""
        lanes = st["banks"]
        assert lanes[0].dispatcher is got.controller.dispatcher
        assert lanes[1].dispatcher.fused is not lanes[0].dispatcher.fused
        assert len({id(r.lane) for r in got.batcher.routers}) == 2
        dicts, _ = workloads.make_hit_requests(120, 48, seed=9)
        dicts += workloads.make_request_dicts(48, seed=9)
        pb = [bag_from_mapping(d) for d in dicts]
        rb = [ref_bag(d) for d in dicts]
        got_r = [f.result() for f in [got.batcher.submit(b) for b in pb]]
        ref_r = [f.result() for f in [ref.batcher.submit(b) for b in rb]]
        plain_r = plain.check_many([bag_from_mapping(d) for d in dicts])
        fields = ("status_code", "status_message", "valid_duration_s",
                  "valid_use_count", "referenced", "deny_rule")
        for a, b, c in zip(ref_r, got_r, plain_r):
            for f in fields:
                assert getattr(b, f) == getattr(a, f) == getattr(c, f), f
        # both lanes served rows
        rows = got.batcher.routing_stats()["rows_per_shard"]
        assert len([n for n in rows.values() if n]) == 2

        def counts(srv):
            srv.rulestats.drain()
            return {n: (c["hits"], c["denies"], c["errors"])
                    for n, c in srv.rulestats.counts().items()
                    if c["hits"] or c["denies"] or c["errors"]}
        have = counts(got)
        assert have == counts(ref) == counts(plain)
        assert have
    finally:
        for srv in (ref, got, plain):
            srv.close()
            srv.controller.store.close()
