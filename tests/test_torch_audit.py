"""The port's mesh audit plane (istio_tpu_torch/runtime/audit.py) on the
CPU, against the JAX package's (istio_tpu/runtime/audit.py).

  * Every case of tests/test_audit.py, run on both packages through
    `both(scenario)` (each package's own AuditPlane, SEAMS, INJECTIONS,
    monitor, forensics and slo) with the outcomes compared: the
    AuditCheck shape, the negative residue, the stuck detector's count
    and time, the typed residue, the ledger's coalescing, matching and
    expiry, the grant watermark and coherence, the plane-agreement seam,
    monolithic routing, the pool view, the discovery scope pairs, the
    scorecard fusion, evaluate / snapshot.
  * The injection hook: CHAOS.on_inject fires once at each of the six
    commit points, outside the chaos lock, survives reset(), and an
    observer that raises never changes what a seam does.
  * Parity of a served pair: the reference's RuntimeServer and the
    port's CPU server over one store, driven with one bag stream (check,
    report, quota), one wedged adapter and one device fault, then the
    counter seams: the six invariants' statuses and evidence (counter
    readings as deltas over each package's own baseline, walls left out)
    and the explainability records are equal after every step.
  * Discovery attached, a tampered pair, routing over shards, grant
    coherence across a publish: equal on both packages.
  * ServerArgs: audit=False builds no plane and raises nothing; the
    default builds a running `mesh-audit` thread that close() stops;
    the four audit fields are carried.

Each test resets both packages' SEAMS, INJECTIONS, CHAOS and event ring
before and after (process-wide; --dist loadfile shares workers).
"""
from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest
import torch

from istio_tpu.adapters.sdk import QuotaArgs as RefQuotaArgs
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.pilot.discovery import DiscoveryService as RefDS
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime import audit as ref_audit
from istio_tpu.runtime import forensics as ref_forensics
from istio_tpu.runtime import grants as ref_grants
from istio_tpu.runtime import monitor as ref_monitor
from istio_tpu.runtime import resilience as ref_resilience
from istio_tpu.runtime import slo as ref_slo
from istio_tpu.runtime.store import Event as RefEvent
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.adapters.sdk import QuotaArgs
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.pilot.discovery import DiscoveryService
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.runtime import (audit, forensics, grants, monitor,
                                     resilience, slo)
from istio_tpu_torch.runtime.store import Event
from istio_tpu_torch.testing import workloads

CI = "cilist.istio-system"

REF = SimpleNamespace(
    name="ref", Server=RefServer, Args=RefArgs, audit=ref_audit,
    monitor=ref_monitor, forensics=ref_forensics, slo=ref_slo,
    grants=ref_grants, CHAOS=ref_resilience.CHAOS, bag=ref_bag,
    QuotaArgs=RefQuotaArgs, DS=RefDS, Event=RefEvent,
    workloads=ref_workloads, kw={}, ds_kw={},
    generation=lambda: ref_monitor.DISCOVERY_GENERATION.value())
PORT = SimpleNamespace(
    name="port", Server=RuntimeServer, Args=ServerArgs, audit=audit,
    monitor=monitor, forensics=forensics, slo=slo, grants=grants,
    CHAOS=resilience.CHAOS, bag=bag_from_mapping, QuotaArgs=QuotaArgs,
    DS=DiscoveryService, Event=Event, workloads=workloads,
    kw=dict(device="cpu"), ds_kw=dict(device="cpu"),
    generation=lambda: monitor.DISCOVERY_GENERATION.value())


def _reset_both() -> None:
    for p in (REF, PORT):
        p.audit.SEAMS.reset()
        p.audit.INJECTIONS.reset()
        p.CHAOS.reset()
        p.forensics.EVENTS.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _isolated():
    _reset_both()
    try:
        yield
    finally:
        _reset_both()


def both(scenario):
    """scenario(package) on the reference, then on the port; the outcomes
    must be equal. → the port's."""
    out = []
    for p in (REF, PORT):
        _reset_both()
        try:
            out.append(scenario(p))
        finally:
            _reset_both()
    assert out[1] == out[0]
    return out[1]


def _stores(make):
    """One store built by the reference's workloads, and the port's copy
    of it."""
    ref_store = make(ref_workloads)
    return {"ref": ref_store,
            "port": interop.store_from_reference(ref_store)}


def _server(p, store, **kw):
    args = dict(batch_window_s=0.0005, max_batch=8, buckets=(4, 8),
                default_manifest=p.workloads.MESH_MANIFEST,
                initial_prewarm=False, rulestats_drain_s=0)
    args.update(kw)
    srv = p.Server(store, p.Args(**args), **p.kw)
    plan = srv.controller.dispatcher.fused
    if plan is not None:
        plan.prewarm(args["buckets"])
    return srv


@pytest.fixture(scope="module")
def srvs():
    """test_audit.py's server (make_store(8), grants on) on both
    packages, over one store."""
    stores = _stores(lambda wl: wl.make_store(8))
    out = {p.name: _server(p, stores[p.name], check_grants=True)
           for p in (REF, PORT)}
    yield out
    for p in (REF, PORT):
        out[p.name].close()
        stores[p.name].close()


def _check(snap: dict, name: str) -> dict:
    return next(c for c in snap["checks"] if c["name"] == name)


# ---------------------------------------------------------------------
# the cases of tests/test_audit.py, on both packages
# ---------------------------------------------------------------------

def test_audit_check_as_dict_shape():
    def scenario(p):
        d = p.audit.AuditCheck("report_conservation", evidence={"x": 1},
                               note="n").as_dict()
        return d, sorted(d)
    d, keys = both(scenario)
    assert d["status"] == "ok" and keys == sorted(
        {"name", "status", "evidence", "generation", "wall", "note"})


def test_invariant_and_fault_vocabulary_agree():
    for name in ("AUDIT_INVARIANTS", "AUDIT_STATUSES", "FAULT_KINDS"):
        assert getattr(monitor, name) == getattr(ref_monitor, name)
    assert audit.INVARIANTS == ref_audit.INVARIANTS
    assert (audit.OK, audit.DEGRADED, audit.VIOLATED) == \
        (ref_audit.OK, ref_audit.DEGRADED, ref_audit.VIOLATED)
    assert set(vars(audit.AuditSeams())) == set(vars(ref_audit.AuditSeams()))


def test_negative_residue_violates_immediately():
    def scenario(p):
        aud = p.audit.AuditPlane(None)
        p.audit.SEAMS.report_accepted_skew = -(
            p.monitor.report_conservation()["accepted"] + 3)
        chk = aud._report_conservation()
        return chk.status, chk.evidence["in_flight"] < 0, chk.note
    assert both(scenario)[:2] == ("violated", True)


def test_stuck_promotion_needs_count_and_time():
    def scenario(p):
        aud = p.audit.AuditPlane(None, stuck_after=3, stuck_floor_s=0.4)
        p.audit.SEAMS.report_accepted_skew = 5
        seen = []
        for _ in range(4):
            chk = aud._report_conservation()
        seen.append((chk.status, chk.evidence["stuck_evaluations"] >= 3))
        time.sleep(0.45)
        chk = aud._report_conservation()
        seen.append((chk.status, chk.evidence["frozen_s"] >= 0.4))
        p.audit.SEAMS.reset()
        seen.append(aud._report_conservation().status)
        return seen
    assert both(scenario) == [("degraded", True), ("violated", True), "ok"]


def test_check_accounting_typed_residue_is_ok():
    def scenario(p):
        aud = p.audit.AuditPlane(None, stuck_after=2, stuck_floor_s=0.05)
        rc = p.monitor.resilience_counters()
        typed = (rc["shed_total"] + rc["expired_total"]
                 + rc["cancelled_shed_total"])
        p.audit.SEAMS.check_decoded_skew = typed + 1 \
            - p.monitor.serving_counters()["in_flight"]
        aud._check_accounting()
        time.sleep(0.1)
        first = aud._check_accounting().status
        p.audit.SEAMS.check_decoded_skew -= 1
        aud._check_accounting()
        time.sleep(0.1)
        chk = aud._check_accounting()
        return first, chk.status, bool(typed) and "typed rejections" in \
            chk.note
    first, second, _covered = both(scenario)
    assert (first, second) == ("violated", "ok")


@pytest.mark.parametrize("direct", [True, False])
def test_check_accounting_reads_the_front_counters(direct):
    """The fronts are not ported: their counters move here by direct
    increments (or the seam) and check_accounting reads them alike."""
    def scenario(p):
        aud = p.audit.AuditPlane(None, stuck_after=2, stuck_floor_s=0.05)
        before = aud._check_accounting()
        if direct:
            p.monitor.CHECK_REQUESTS.inc(3)
        else:
            p.audit.SEAMS.check_decoded_skew = 3
        mid = aud._check_accounting()
        if direct:
            p.monitor.CHECK_RESPONSES.inc(3)
        else:
            p.audit.SEAMS.check_decoded_skew = 0
        after = aud._check_accounting()
        return (before.status, mid.status,
                mid.evidence["in_flight"] - before.evidence["in_flight"],
                after.status, after.evidence["in_flight"]
                - before.evidence["in_flight"])
    assert both(scenario) == ("ok", "degraded", 3, "ok", 0)


def _ledger_view(out: dict) -> dict:
    return {**{k: out[k] for k in ("rate", "matched", "unexplained",
                                   "pending")},
            "records": [{k: r[k] for k in r if k != "wall"}
                        for r in out["records"]]}


def test_injection_ledger_coalesces_and_matches_by_event():
    def scenario(p):
        led = p.audit.InjectionLedger(coalesce_s=5.0)
        led.note("device")
        led.note("device")
        p.forensics.record_event("breaker", name="device")
        return _ledger_view(led.evaluate(window_s=30.0))
    out = both(scenario)
    assert out["matched"] == 2 and out["unexplained"] == 0
    recs = [r for r in out["records"] if r["kind"] == "device"]
    assert len(recs) == 1 and recs[0]["n"] == 2
    assert recs[0]["matched_by"] == "event:breaker device"


def test_injection_ledger_expires_unmatched():
    def scenario(p):
        led = p.audit.InjectionLedger()
        led.note("oracle")
        time.sleep(0.05)
        out = _ledger_view(led.evaluate(window_s=0.01))
        led.reset()
        return out, led.evaluate(window_s=1.0)["rate"]
    out, fresh = both(scenario)
    assert (out["unexplained"], out["matched"], out["rate"], fresh) == \
        (1, 0, 0.0, 1.0)


@pytest.mark.parametrize("kind,detail", [
    ("wedge", {"handler": CI}), ("adapter", {"handler": CI}),
    ("quota", {"handler": "rq"}), ("discovery", {}), ("oracle", {})])
def test_injection_ledger_signature_per_kind(kind, detail):
    """Every fault kind's record, before and after its expected evidence
    (a counter delta or an event) lands; unmatched kinds expire alike."""
    def scenario(p):
        led = p.audit.InjectionLedger(coalesce_s=5.0)
        led.note(kind, **detail)
        out = [_ledger_view(led.evaluate(window_s=30.0))]
        if kind in ("wedge", "adapter", "quota"):
            p.forensics.record_event("breaker", name=f"host:"
                                     f"{detail['handler']}")
        elif kind == "discovery":
            gen = p.generation()
            p.monitor.DISCOVERY_GENERATION.set(gen + 1)
        else:
            p.monitor.CHECK_BATCH_FAILURES.inc()
        try:
            out.append(_ledger_view(led.evaluate(window_s=30.0)))
        finally:
            if kind == "discovery":
                p.monitor.DISCOVERY_GENERATION.set(gen)
        return out
    pending, matched = both(scenario)
    assert pending["pending"] == 1 and matched["matched"] == 1


def test_grant_watermark_and_coherence(srvs):
    def scenario(p):
        srv = srvs[p.name]
        wm = srv.grants.watermark()
        chk = srv.audit._grant_coherence()
        p.audit.SEAMS.grant_issue_skew = wm["generation"] + 10
        bad = srv.audit._grant_coherence()
        return (sorted(wm), wm["issued_at_generation"] <= wm["generation"],
                chk.status, chk.evidence["enabled"], bad.status,
                "watermark" in bad.note)
    assert both(scenario)[2:] == ("ok", True, "violated", True)


def test_plane_agreement_seam_detects_divergence(srvs):
    def scenario(p):
        aud = srvs[p.name].audit
        first = aud._plane_agreement()
        p.audit.SEAMS.plane_pairs_extra = [
            ("seam-pair", 'source.service == "a"',
             'source.service == "b"')]
        bad = aud._plane_agreement()
        p.audit.SEAMS.reset()
        again = aud._plane_agreement()
        return (first.status, first.evidence["n_pairs"], bad.status,
                bad.evidence["findings"], bad.evidence["digest"],
                again.status)
    out = both(scenario)
    assert out[0] == "ok" and out[2] == "violated" and out[5] == "ok"
    assert any(f["code"] == "plane-divergence" for f in out[3])


def test_routing_disabled_on_monolithic(srvs):
    def scenario(p):
        chk = srvs[p.name].audit._routing_conservation()
        return chk.status, chk.evidence
    assert both(scenario) == ("ok", {"enabled": False})


def test_device_pool_audit_view(srvs):
    def scenario(p):
        pools = srvs[p.name].controller.device_quotas
        return {k: v.audit_view() for k, v in sorted(pools.items())}
    views = both(scenario)
    assert views
    for view in views.values():
        assert view["negative_cells"] == view["over_cap_cells"] == \
            view["nonzero_beyond_keymap"] == 0
        assert view["n_used"] <= view["n_buckets"]


DISCOVERY_WORLD = dict(n_services=12, n_namespaces=3, replicas=2,
                       source_ns=2, seed=3)


def _discovery(p, world):
    registry, store = world if p is REF else \
        interop.discovery_world_from_reference(*world)
    return p.DS(registry, store, **p.ds_kw)


def test_discovery_scope_pairs_agree():
    registry, store, _nodes, _meta = ref_workloads.make_discovery_world(
        **DISCOVERY_WORLD)

    def scenario(p):
        ds = _discovery(p, (registry, store))
        try:
            pairs = ds._snapshot.scope_audit_pairs()
            assert all(served == compiled
                       for _n, served, compiled in pairs)
            return pairs, ds._snapshot.scope_audit_pairs(limit=3)
        finally:
            ds.stop()
    pairs, few = both(scenario)
    assert pairs and len(few) == 3


def test_discovery_attached_plane_agreement(srvs):
    """attach_discovery folds the scope program's pairs in: ok with
    n_discovery_pairs > 0, a tampered pair violated with a witness, the
    pairs themselves equal across packages."""
    registry, store, _nodes, _meta = ref_workloads.make_discovery_world(
        **DISCOVERY_WORLD)

    def scenario(p):
        aud = srvs[p.name].audit
        ds = _discovery(p, (registry, store))
        try:
            aud.attach_discovery(ds)
            ok = aud._plane_agreement()
            memo = aud._plane_agreement()
            p.audit.SEAMS.plane_pairs_extra = [
                ("tampered[0]", 'source.service == "reviews"', "true")]
            bad = aud._plane_agreement()
            return (ok.status, ok.evidence, memo.evidence["memoized"],
                    bad.status, bad.evidence["findings"], bad.note)
        finally:
            aud._discovery = None
            aud._plane_digest = None
            ds.stop()
    ok, ev, memo, bad, findings, _note = both(scenario)
    assert ok == "ok" and ev["n_discovery_pairs"] > 0 and memo
    assert bad == "violated"
    assert [f["code"] for f in findings] == ["plane-divergence"]


def test_slo_scorecard_verdict_fusion():
    def scenario(p):
        s = p.slo
        fused = (s._worst(["ok", "no_data"]), s._worst(["ok", "miss"]),
                 s._worst(["no_data"]))
        card = s.scorecard(p.monitor, p.forensics)
        bad = s.scorecard(p.monitor, p.forensics, audit={
            "healthy": False, "explainability": {"rate": 1.0},
            "checks": [{"name": "report_conservation",
                        "status": "violated"}]})
        good = s.scorecard(p.monitor, p.forensics, audit={
            "healthy": True, "explainability": {"rate": 1.0},
            "checks": [{"name": "report_conservation", "status": "ok"}]})
        return (fused, sorted(card["planes"]),
                card["planes"]["audit"]["verdict"], bad["planes"]["audit"],
                bad["overall"], good["planes"]["audit"])
    fused, planes, none, bad, overall, good = both(scenario)
    assert fused == ("ok", "miss", "no_data") and none == "no_data"
    assert planes == sorted({"check_wire", "report_export",
                             "discovery_push", "quota_flush", "audit"})
    assert bad["verdict"] == overall == "miss"
    assert bad["violated"] == ["report_conservation"]
    assert good["verdict"] == "ok"


def test_audit_plane_snapshot_and_evaluate(srvs):
    def scenario(p):
        snap = srvs[p.name].audit.evaluate()
        assert snap["enabled"] and snap["evaluations"] >= 1
        assert 0.0 <= snap["explainability"]["rate"] <= 1.0
        return ([c["name"] for c in snap["checks"]], snap["healthy"],
                sorted(snap), sorted(snap["counters"]))
    names, healthy, _keys, _counters = both(scenario)
    assert names == list(monitor.AUDIT_INVARIANTS) and healthy is True


# ---------------------------------------------------------------------
# the injection hook
# ---------------------------------------------------------------------

def _hook_calls(p) -> list:
    chaos = p.CHAOS
    calls = []

    def observer(kind, **detail):
        # outside the chaos lock: a non-blocking acquire succeeds
        free = chaos._lock.acquire(blocking=False)
        if free:
            chaos._lock.release()
        calls.append((kind, detail, free))

    prev = chaos.on_inject
    chaos.on_inject = observer
    try:
        chaos.reset()                 # keeps the observer
        chaos.wedge_adapter("h")
        chaos.unwedge_adapter("h")
        chaos.adapter_failures = {"h": 1}
        with pytest.raises(RuntimeError, match="adapter"):
            chaos.adapter_call("h")
        chaos.adapter_call("h")       # disarmed: no call
        chaos.quota_failures = {"q": 1}
        with pytest.raises(RuntimeError, match="quota"):
            chaos.quota_call("q")
        chaos.discovery_push_delay_s = 0.001
        chaos.discovery_publish()
        chaos.discovery_push_delay_s = 0.0
        chaos.discovery_publish()     # no delay: no injection
        chaos.device_failures = 1
        with pytest.raises(RuntimeError, match="device"):
            chaos.device_step()
        chaos.oracle_failures = 1
        with pytest.raises(RuntimeError, match="oracle"):
            chaos.oracle_step()

        def broken(kind, **detail):
            raise ValueError("observer")
        chaos.on_inject = broken
        chaos.device_failures = 1
        with pytest.raises(RuntimeError, match="device"):
            chaos.device_step()
        chaos.wedge_adapter("h2")
        chaos.reset()
        assert chaos.on_inject is broken
    finally:
        chaos.reset()
        chaos.on_inject = prev
    return calls


def test_chaos_on_inject_fires_at_each_commit_point():
    calls = both(_hook_calls)
    assert [c[0] for c in calls] == ["wedge", "adapter", "quota",
                                     "discovery", "device", "oracle"]
    assert all(free for *_c, free in calls)


def test_servers_install_the_ledger_as_observer(srvs):
    assert resilience.CHAOS.on_inject == audit.INJECTIONS.note
    assert ref_resilience.CHAOS.on_inject == ref_audit.INJECTIONS.note


# ---------------------------------------------------------------------
# parity of a served pair
# ---------------------------------------------------------------------

PAIR_ARGS = dict(max_batch=16, buckets=(8, 16), check_grants=True,
                 host_breaker_failures=2, host_breaker_reset_s=30.0,
                 audit_quota_every=1)
COUNTERS = ("report_conservation", "check_accounting")


def _delta(a, b):
    if isinstance(a, dict):
        return {k: _delta(v, b.get(k, 0)) for k, v in a.items()}
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return a - b
    return a


def _view(snap: dict, base: dict) -> dict:
    """Statuses, evidence and notes of every invariant (the two ledgers'
    readings as deltas over `base`, the stuck detector's seconds left
    out) and the explainability records, less walls."""
    checks = {}
    for c in snap["checks"]:
        ev = {k: v for k, v in c["evidence"].items() if k != "frozen_s"}
        if c["name"] in COUNTERS:
            ev = _delta(ev, _check(base, c["name"])["evidence"])
        checks[c["name"]] = (c["status"], ev, c["generation"],
                             "" if "frozen" in c["note"] else c["note"])
    return {"healthy": snap["healthy"], "checks": checks,
            "explainability": _ledger_view(snap["explainability"])}


def _overlay_bag(p, i: int, n_services: int = 20):
    return p.bag({
        "destination.service":
            f"svc{i % n_services}.ns{i % 23}.svc.cluster.local",
        "source.namespace": "ns2", "request.method": "GET",
        "request.path": f"/api/v{i % 3}/items"})


def _served_pair(p, store) -> list:
    """The drive, one package: → the audit views after each step."""
    srv = _server(p, store, **PAIR_ARGS)
    views = []
    try:
        aud = srv.audit
        aud.stop()                    # evaluations only where the test asks
        far = time.perf_counter() + 60
        dicts = p.workloads.make_request_dicts(24, seed=7)
        bags = [p.bag(d) for d in dicts]
        ci = [_overlay_bag(p, i) for i in range(2, 40, 5)
              if (i // 5) % 3 == 0]
        srv.check(ci[0], deadline=far)            # warm the host lane
        srv.quota(bags[0], "rq.istio-system",
                  p.QuotaArgs(quota_amount=1), deadline=far)
        base = aud.evaluate()
        # clean traffic: check, report, quota
        srv.check_many(bags[:16])
        for b in bags[16:]:
            srv.check(b, deadline=far)
        srv.report(bags[:12])
        for b in bags[:6]:
            srv.quota(b, "rq.istio-system", p.QuotaArgs(quota_amount=2),
                      deadline=far)
        views.append(_view(aud.evaluate(), base))
        # a wedged adapter: two overruns open the lane breaker, the
        # third call meets it open
        p.CHAOS.wedge_adapter(CI)
        try:
            codes = [srv.check(ci[k % len(ci)],
                               deadline=time.perf_counter() + 0.2
                               ).status_code for k in range(3)]
        finally:
            p.CHAOS.unwedge_adapter(CI)
        # a device fault, answered by the oracle
        p.CHAOS.device_failures = 2
        codes += [srv.check(b, deadline=far).status_code
                  for b in bags[:3]]
        p.CHAOS.reset()
        time.sleep(0.3)
        views.append(_view(aud.evaluate(), base))
        views.append(codes)
        # the counter seams, one at a time
        for seam, value in (("report_accepted_skew", 7),
                            ("quota_negative_cells_skew", 1),
                            ("grant_issue_skew", 1000),
                            ("check_decoded_skew", -1)):
            setattr(p.audit.SEAMS, seam, value)
            views.append(_view(aud.evaluate(), base))
            p.audit.SEAMS.reset()
        views.append(_view(aud.evaluate(), base))
    finally:
        srv.close()
    return views


def test_served_pair_audits_alike():
    stores = _stores(lambda wl: wl.make_store(40, host_overlay_every=5))
    try:
        views = both(lambda p: _served_pair(p, stores[p.name]))
    finally:
        for s in stores.values():
            s.close()
    clean, chaos, codes, report, quota, grant, check, after = views
    assert {n: c[0] for n, c in clean["checks"].items()} == \
        dict.fromkeys(monitor.AUDIT_INVARIANTS, "ok")
    assert clean["checks"]["report_conservation"][1]["exported"] == 12
    quota_ev = clean["checks"]["quota_conservation"][1]
    assert quota_ev["host_backends"]["mq.istio-system"]["cells_checked"] > 0
    assert quota_ev["device_pools"]["mq.istio-system"]["n_buckets"] > 0
    assert clean["explainability"]["rate"] == 1.0
    ex = chaos["explainability"]
    kinds = {r["kind"]: r for r in ex["records"] if r["matched"]}
    assert set(kinds) == {"wedge", "device"}, ex
    assert all(r["matched_by"] for r in kinds.values())
    assert ex["rate"] == 1.0 and ex["unexplained"] == 0
    assert report["checks"]["report_conservation"][0] == "degraded"
    assert report["checks"]["report_conservation"][1]["in_flight"] == 7
    assert quota["checks"]["quota_conservation"][0] == "violated"
    assert grant["checks"]["grant_coherence"][0] == "violated"
    assert check["checks"]["check_accounting"][0] == "violated"
    for v in (quota, grant, check):
        assert v["healthy"] is False
    assert after["healthy"] is True


def test_routing_conservation_over_shards():
    stores = _stores(lambda wl: wl.make_store(40))

    def scenario(p):
        srv = _server(p, stores[p.name], shards=2, buckets=(8,),
                      max_batch=8)
        try:
            srv.audit.stop()
            srv.check_many([p.bag(d) for d in
                            p.workloads.make_request_dicts(16, seed=3)])
            ok = srv.audit._routing_conservation()
            p.audit.SEAMS.routing_misrouted_skew = 2
            bad = srv.audit._routing_conservation()
            return ok.status, ok.evidence, bad.status, bad.note
        finally:
            srv.close()
    try:
        status, ev, bad, _note = both(scenario)
    finally:
        for s in stores.values():
            s.close()
    assert status == "ok" and ev["enabled"] and ev["rows_total"] == 16
    assert bad == "violated"


def test_grant_coherence_across_a_publish(monkeypatch):
    frozen = SimpleNamespace(monotonic=lambda: 1000.0)
    monkeypatch.setattr(ref_grants, "time", frozen)
    monkeypatch.setattr(grants, "time", frozen)
    stores = _stores(lambda wl: wl.make_store(16))

    def scenario(p):
        store = stores[p.name]
        srv = _server(p, store, check_grants=True)
        try:
            srv.audit.stop()
            bags = [p.bag(d) for d in
                    p.workloads.make_request_dicts(8, seed=4)]
            srv.check_many(bags)
            before = srv.audit._grant_coherence()
            store.apply_events([p.Event(("rule", "istio-system", "late"), {
                "match": 'request.method == "PATCH"',
                "actions": [{"handler": "denyall",
                             "instances": ["nothing"]}]})], notify=False)
            srv.controller.rebuild()
            srv.check_many(bags)
            after = srv.audit._grant_coherence()
            return before.status, before.evidence, after.status, \
                after.evidence
        finally:
            srv.close()
    try:
        s0, ev0, s1, ev1 = both(scenario)
    finally:
        for s in stores.values():
            s.close()
    assert s0 == s1 == "ok"
    assert ev1["publishes_since_audit_start"] == 1
    assert ev1["revocations_since_audit_start"] >= 1


# ---------------------------------------------------------------------
# ServerArgs
# ---------------------------------------------------------------------

def _audit_threads() -> set:
    return {t for t in threading.enumerate()
            if t.name == "mesh-audit" and t.is_alive()}


def test_audit_off_builds_no_plane():
    store = workloads.make_store(8)
    try:
        srv = RuntimeServer(store, ServerArgs(audit=False,
                                              initial_prewarm=False),
                            device="cpu")
        try:
            assert srv.audit is None
        finally:
            srv.close()
    finally:
        store.close()


def test_default_server_runs_the_auditor_and_close_stops_it():
    store = workloads.make_store(8)
    before = _audit_threads()
    try:
        srv = RuntimeServer(store, ServerArgs(initial_prewarm=False,
                                              audit_interval_s=0.05),
                            device="cpu")
        try:
            thread = srv.audit._thread
            assert thread is not None and thread.is_alive()
            assert thread in _audit_threads() - before
            deadline = time.perf_counter() + 10
            while srv.audit.snapshot()["evaluations"] < 2:
                assert time.perf_counter() < deadline
                time.sleep(0.02)
            assert srv.audit.snapshot()["running"] is True
        finally:
            srv.close()
        assert not thread.is_alive()
        # no mesh-audit thread outlives the server (threads of servers
        # built before it may end meanwhile)
        assert _audit_threads() <= before
        assert srv.audit.snapshot()["running"] is False
    finally:
        store.close()


@pytest.mark.parametrize("field,value", [
    ("audit", False), ("audit_interval_s", 1.0), ("audit_quota_every", 2),
    ("audit_explain_window_s", 1.0)])
def test_audit_fields_carried(field, value):
    store = workloads.make_store(8)
    try:
        srv = RuntimeServer(store, ServerArgs(**{field: value},
                                              initial_prewarm=False),
                            device="cpu")
        try:
            if field == "audit":
                assert srv.audit is None
            else:
                assert srv.audit is not None
                got = {"audit_interval_s": srv.audit.interval_s,
                       "audit_quota_every": srv.audit.quota_every,
                       "audit_explain_window_s":
                           srv.audit.explain_window_s}[field]
                assert got == value
        finally:
            srv.close()
    finally:
        store.close()
