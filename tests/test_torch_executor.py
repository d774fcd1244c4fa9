"""The port's adapter-executor plane against the JAX package's.

Every scenario of tests/test_executor.py runs on both packages from the
same inputs (each package's own make_store / make_opa_store /
make_shared_quota_store, CHAOS, monitor and bag_from_mapping), and the
outcomes must be equal: responses (status code and message, TTL and use
count), the `host_action_counters()` deltas by handler, the late and
retry counts and the lane-breaker states. Then the checks of
scripts/executor_smoke.py on a RuntimeServer of each package, less its
gRPC front and its /debug/executor scrape (neither is ported; the lane
state is read from `executor.snapshot()` instead), and the port's own
contract: a lane breaker never moves the device breaker's gauge or
transitions, and an exception between submit and claim leaves the
conservation ledger exact.

Scenarios whose counts depend on thread timing (how many submits a full
lane sheds) compare the reference test's invariants, not the counts.
Every test runs with both packages' CHAOS seams reset around it, every
wedge released (`_isolated`): the suite shares worker processes under
`-n 6 --dist loadfile`, and a leaked wedge would hang later files. The
reference's servers are built with `initial_prewarm=False` and then warm
their serving shapes before any deadline is set: a reference executor
sheds a host action whose deadline its first JAX compile outlives.
"""
import threading
import time
from types import SimpleNamespace

import pytest

from istio_tpu.adapters.list_adapter import ListHandler as RefListHandler
from istio_tpu.adapters.memquota import QuotaBackend as RefQuotaBackend
from istio_tpu.adapters.sdk import QuotaArgs as RefQuotaArgs
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import MemStore as RefMemStore
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime import dispatcher as ref_dispatcher
from istio_tpu.runtime import executor as ref_executor
from istio_tpu.runtime import monitor as ref_monitor
from istio_tpu.runtime import resilience as ref_resilience
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch.adapters.list_adapter import ListHandler
from istio_tpu_torch.adapters.memquota import QuotaBackend
from istio_tpu_torch.adapters.sdk import QuotaArgs
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.runtime import MemStore, RuntimeServer, ServerArgs
from istio_tpu_torch.runtime import dispatcher, executor, monitor, resilience
from istio_tpu_torch.testing import workloads

UNAVAILABLE = 14
CI = "cilist.istio-system"
PROV = "provlist.istio-system"
STATES = ("closed", "half_open", "open")


def _ref_transitions() -> dict:
    return {s: int(ref_monitor.BREAKER_TRANSITIONS.labels(to=s)._value.get())
            for s in STATES}


def _port_transitions() -> dict:
    return {s: int(monitor.BREAKER_TRANSITIONS.value(s)) for s in STATES}


REF = SimpleNamespace(
    name="ref", Server=RefServer, Args=RefArgs, monitor=ref_monitor,
    CHAOS=ref_resilience.CHAOS, res=ref_resilience, bag=ref_bag,
    workloads=ref_workloads, executor=ref_executor,
    dispatcher=ref_dispatcher, ListHandler=RefListHandler,
    QuotaBackend=RefQuotaBackend, QuotaArgs=RefQuotaArgs,
    MemStore=RefMemStore, transitions=_ref_transitions,
    breaker_gauge=lambda: ref_monitor.BREAKER_STATE._value.get(),
    counter=lambda c: int(c._value.get()),
    # the planes the port does not carry, off where they would act
    # behind the test's back
    extra=dict(audit=False), kw={})
PORT = SimpleNamespace(
    name="port", Server=RuntimeServer, Args=ServerArgs, monitor=monitor,
    CHAOS=resilience.CHAOS, res=resilience, bag=bag_from_mapping,
    workloads=workloads, executor=executor, dispatcher=dispatcher,
    ListHandler=ListHandler, QuotaBackend=QuotaBackend,
    QuotaArgs=QuotaArgs, MemStore=MemStore, transitions=_port_transitions,
    breaker_gauge=lambda: monitor.BREAKER_STATE.value(),
    counter=lambda c: int(c.value()),
    extra={}, kw=dict(device="cpu"))


def _reset_both() -> None:
    for p in (REF, PORT):
        p.CHAOS.reset()


@pytest.fixture(autouse=True)
def _isolated():
    """Both packages' CHAOS seams, every wedge released, before and
    after every test, whatever the test did."""
    _reset_both()
    try:
        yield
    finally:
        _reset_both()


def both(scenario):
    """Run `scenario(pkg)` on the reference, then on the port, each
    between resets of both packages' seams; → (ref, port) outcomes."""
    out = []
    for p in (REF, PORT):
        _reset_both()
        try:
            out.append(scenario(p))
        finally:
            _reset_both()
    return out


def _server(p, store, **kw):
    """test_executor.py's server, warmed at its serving shapes before
    any deadline."""
    args = dict(batch_window_s=0.0005, max_batch=16, buckets=(8, 16),
                default_manifest=p.workloads.MESH_MANIFEST,
                initial_prewarm=False, rulestats_drain_s=0, **p.extra)
    args.update(kw)
    srv = p.Server(store, p.Args(**args), **p.kw)
    plan = srv.controller.dispatcher.fused
    if plan is not None:
        plan.prewarm(args["buckets"])
    return srv


def _overlay_bag(p, i: int, n_services: int = 30):
    """A bag matching make_store(host_overlay_every=5) rule `i`
    (i % 5 == 2 rules carry a host list action; k = (i // 5) % 3 picks
    cilist / provlist / dynpat)."""
    return p.bag({
        "destination.service":
            f"svc{i % n_services}.ns{i % 23}.svc.cluster.local",
        "source.namespace": "ns2",
        "request.method": "GET",
        "request.path": f"/api/v{i % 3}/items",
    })


def hc_delta(p, before: dict) -> dict:
    """host_action_counters() growth since `before`: totals, outcomes,
    late, retries and the per-handler submitted / outcome counts."""
    after = p.monitor.host_action_counters()
    by = {}
    for h, v in after["by_handler"].items():
        b = before["by_handler"].get(h, {"submitted": 0, "outcomes": {}})
        outs = {o: n - b["outcomes"].get(o, 0)
                for o, n in v["outcomes"].items()
                if n != b["outcomes"].get(o, 0)}
        sub = v["submitted"] - b["submitted"]
        if sub or outs:
            by[h] = {"submitted": sub, "outcomes": outs}
    return {"submitted": after["submitted"] - before["submitted"],
            "outcomes": {o: after["outcomes"][o] - before["outcomes"][o]
                         for o in after["outcomes"]},
            "late": {k: after["late"][k] - before["late"][k]
                     for k in after["late"]},
            "retries": after["retries"] - before["retries"],
            "by_handler": by, "exact": after["exact"]}


def resp(r) -> tuple:
    return (r.status_code, r.status_message, r.valid_duration_s,
            r.valid_use_count)


def _settle(p, base: dict, timeout: float = 5.0) -> dict:
    """hc_delta once every late completion has landed (the late_*
    counters move on a worker thread after the fold answered)."""
    end = time.monotonic() + timeout
    d = hc_delta(p, base)
    while time.monotonic() < end and \
            sum(d["late"].values()) < d["outcomes"]["overrun"] + \
            d["outcomes"]["expired"]:
        time.sleep(0.01)
        d = hc_delta(p, base)
    return d


# ---------------------------------------------------------------------
# the scenarios of tests/test_executor.py
# ---------------------------------------------------------------------

def test_wedged_adapter_bulkhead_and_recovery():
    """One handler wedged: other handlers' verdicts unchanged (bulkhead),
    the wedged rules answer the fail policy within the deadline, the lane
    breaker opens, the half-open probe closes it once unwedged, and the
    conservation stays exact."""
    deadline_s = 0.4

    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store, host_breaker_failures=2,
                      host_breaker_reset_s=0.3)
        try:
            base = p.monitor.host_action_counters()
            ci_bag, prov_bag = _overlay_bag(p, 2), _overlay_bag(p, 7)
            clean_ci = resp(srv.check(ci_bag))
            clean_prov = resp(srv.check(prov_bag))
            p.CHAOS.wedge_adapter(CI)
            walls, wedged = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                wedged.append(resp(srv.check(
                    ci_bag, deadline=time.perf_counter() + deadline_s)))
                walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            prov = resp(srv.check(prov_bag))
            prov_wall = time.perf_counter() - t0
            lane = srv.executor.lane(CI)
            opened = lane.breaker.state
            while_open = resp(srv.check(
                ci_bag, deadline=time.perf_counter() + deadline_s))
            p.CHAOS.unwedge_adapter(CI)
            time.sleep(0.35)
            recovered = resp(srv.check(ci_bag))
            closed = lane.breaker.state
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()
        return {"clean": (clean_ci, clean_prov), "wedged": wedged,
                "prov": prov, "opened": opened, "while_open": while_open,
                "recovered": recovered, "closed": closed,
                "walls_ok": max(walls) < deadline_s + 0.35,
                "prov_fast": prov_wall < deadline_s,
                "counts": _settle(p, base)}

    ref, port = both(scenario)
    assert ref == port
    assert all(r[0] == UNAVAILABLE for r in port["wedged"])
    assert port["prov"] == port["clean"][1]
    assert port["recovered"] == port["clean"][0]
    assert (port["opened"], port["closed"]) == ("open", "closed")
    assert port["walls_ok"] and port["prov_fast"]
    d = port["counts"]
    assert d["exact"] and d["outcomes"]["overrun"] == 2
    assert d["outcomes"]["breaker_open"] == 2
    assert d["submitted"] == sum(d["outcomes"].values())


def test_bulkhead_overflow_sheds_typed_with_deadline():
    """A wedged lane's queue fills to its cap; later submits shed typed
    at once and the batch folds in about one action-timeout window."""
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store, executor_queue_cap=1, executor_workers=1,
                      host_breaker_failures=100,
                      host_action_timeout_ms=300.0)
        try:
            base = p.monitor.host_action_counters()
            p.CHAOS.wedge_adapter(CI)
            t0 = time.perf_counter()
            out = srv.check_many([_overlay_bag(p, 2) for _ in range(8)])
            wall = time.perf_counter() - t0
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()
        d = _settle(p, base)
        o = d["outcomes"]
        return {"statuses": sorted({r.status_code for r in out}),
                "messages": sorted({r.status_message for r in out}),
                "fast": wall < 2.5, "shed_ge_5": o["shed"] >= 5,
                "typed": o["shed"] + o["overrun"] + o["expired"],
                "ok": o["ok"], "exact": d["exact"],
                "submitted": d["submitted"]}

    ref, port = both(scenario)
    # which of the two non-shed actions overran or expired is timing
    assert {k: v for k, v in ref.items() if k != "messages"} == \
        {k: v for k, v in port.items() if k != "messages"}
    assert port["statuses"] == [UNAVAILABLE]
    assert set(port["messages"]) <= {
        f"host adapter unavailable ({o})"
        for o in ("shed", "overrun", "expired")}
    assert port["fast"] and port["shed_ge_5"] and port["exact"]
    assert port["typed"] == port["submitted"] == 8


def test_adapter_errors_keep_safedispatch_parity_and_trip_breaker():
    """Injected adapter exceptions: one retry, then the action's own
    INTERNAL verdict (the inline path's), and consecutive failures trip
    the lane breaker; an open breaker answers the fail policy."""
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store, host_breaker_failures=3,
                      host_breaker_reset_s=60.0)
        try:
            base = p.monitor.host_action_counters()
            bag = _overlay_bag(p, 2)
            clean = resp(srv.check(bag))
            p.CHAOS.adapter_failures[CI] = 10 ** 6
            failing = [resp(srv.check(bag)) for _ in range(3)]
            state = srv.executor.lane(CI).breaker.state
            opened = resp(srv.check(bag))
            mid = hc_delta(p, base)
            p.CHAOS.reset()
            srv.executor.lane(CI).breaker.record_success()   # force close
            again = resp(srv.check(bag))
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()
        return {"clean": clean, "failing": failing, "state": state,
                "opened": opened, "mid": mid, "again": again,
                "counts": hc_delta(p, base)}

    ref, port = both(scenario)
    assert ref == port
    assert [r[0] for r in port["failing"]] == [13, 13, 13]
    assert port["failing"][0][1] == ("adapter panic: RuntimeError: chaos: "
                                     f"injected adapter failure ({CI})")
    assert port["state"] == "open" and port["opened"][0] == UNAVAILABLE
    mid = port["mid"]
    assert (mid["outcomes"]["error"], mid["outcomes"]["breaker_open"],
            mid["retries"]) == (3, 1, 3)
    assert port["again"] == port["clean"]


def test_fail_open_policy_answers_ok_with_short_ttl():
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store, host_fail_policy="open",
                      host_action_timeout_ms=100.0)
        try:
            p.CHAOS.wedge_adapter(CI)
            return resp(srv.check(_overlay_bag(p, 2)))
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port
    assert port[0] == 0 and port[2] <= 1.0 and port[3] == 1


def test_deadline_inherited_from_request_bounds_host_actions():
    """The batcher's earliest deadline reaches the executor's fold, so a
    wedged adapter never holds a request past its own budget."""
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store)
        try:
            p.CHAOS.wedge_adapter(CI)
            t0 = time.perf_counter()
            r = resp(srv.check(_overlay_bag(p, 2),
                               deadline=time.perf_counter() + 0.25))
            return r, time.perf_counter() - t0 < 0.25 + 0.35
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port
    assert port[0][:2] == (UNAVAILABLE, "host adapter unavailable (overrun)")
    assert port[1]


def test_ns_invisible_fallback_pairs_skipped():
    """The overlay decode host-evaluates only (bag, rule) pairs whose
    namespace can see the rule, and counts only their errors."""
    def scenario(p):
        s = p.MemStore()
        s.set(("handler", "nsa", "deny"), {
            "adapter": "denier", "params": {"status_code": 7}})
        s.set(("instance", "nsa", "nothing"), {
            "template": "checknothing", "params": {}})
        s.set(("rule", "nsa", "dynkey"), {
            "match": 'request.headers[request.method] == "yes"',
            "actions": [{"handler": "deny", "instances": ["nothing"]}]})
        srv = _server(p, s)
        try:
            d = srv.controller.dispatcher
            rs = d.snapshot.ruleset
            calls = []
            real = rs.host_eval

            def spy(ridx, bag):
                calls.append(ridx)
                return real(ridx, bag)

            rs.host_eval = spy
            try:
                vis = p.bag({"destination.service": "x.nsa.svc.cluster.local",
                             "request.method": "GET",
                             "request.headers": {"GET": "yes"}})
                invis = p.bag({
                    "destination.service": "x.nsb.svc.cluster.local",
                    "request.method": "GET",
                    "request.headers": {"GET": "yes"}})
                out = [r.status_code for r in d.check([vis, invis, invis])]
                n_calls = len(calls)
                oracle = [r.status_code
                          for r in d.check_host_oracle([vis, invis, invis])]
                calls.clear()
                err0 = p.counter(p.monitor.RESOLVE_ERRORS)
                d.check([p.bag({
                    "destination.service": "x.nsb.svc.cluster.local"})])
                return (bool(rs.host_fallback), out, n_calls, oracle,
                        list(calls),
                        p.counter(p.monitor.RESOLVE_ERRORS) - err0)
            finally:
                rs.host_eval = real
        finally:
            srv.close()
            s.close()

    ref, port = both(scenario)
    assert ref == port == (True, [7, 0, 0], 1, [7, 0, 0], [], 0)


def test_list_provider_refresh_failure_keeps_last_good(tmp_path):
    """A failing file:// provider keeps serving the last good list, the
    refresh counters move, and the failure shows in the refresh stats and
    the executor's maintenance view."""
    def scenario(p):
        path = tmp_path / f"allow-{p.name}.txt"
        path.write_text("ns0\nns2\n")
        h = p.ListHandler({"provider_url": f"file://{path}",
                           "refresh_interval_s": 60.0}, env=None)
        seen = [h.handle_check("listentry", {"value": "ns2"}).ok]
        t0 = p.counter(p.monitor.LIST_REFRESH_TOTAL)
        f0 = p.counter(p.monitor.LIST_REFRESH_FAILURES)
        ex = p.executor.AdapterExecutor(p.executor.ExecutorConfig())
        try:
            ex.register_refreshables({"lh.ns": h})
            path.unlink()
            seen.append(ex.refresh_now("lh.ns"))
            seen += [h.handle_check("listentry", {"value": "ns2"}).ok,
                     h.handle_check("listentry", {"value": "ns1"}).ok,
                     p.counter(p.monitor.LIST_REFRESH_TOTAL) - t0,
                     p.counter(p.monitor.LIST_REFRESH_FAILURES) - f0]
            st = h.refresh_stats()
            seen += [st["refresh_failures"], st["last_refresh_error"],
                     st["entries"], st["provider"]]
            m = ex.snapshot()["maintenance"]["lh.ns"]
            seen += [m["refresh_failures"], m["refresh_total"],
                     m["last_error"], m["interval_s"]]
            path.write_text("ns1\n")
            seen += [ex.refresh_now("lh.ns"),
                     h.handle_check("listentry", {"value": "ns1"}).ok,
                     h.refresh_stats()["last_refresh_error"],
                     ex.refresh_now("missing")]
        finally:
            ex.close()
        return seen

    ref, port = both(scenario)
    # the messages name each package's own file
    assert [str(x).replace("allow-ref", "allow-port") for x in ref] == \
        [str(x) for x in port]
    assert port[:7] == [True, True, True, False, 1, 1, 1]
    assert port[7].startswith("FileNotFoundError")
    assert port[-4:] == [True, True, None, False]


def test_maintenance_scheduler_drives_periodic_refresh():
    def scenario(p):
        pulls = []

        class H:
            refresh_interval_s = 0.05
            _provider = staticmethod(lambda: [])

            def refresh(self):
                pulls.append(time.monotonic())

        class NoProvider(H):
            _provider = None

        ex = p.executor.AdapterExecutor(
            p.executor.ExecutorConfig(maintenance_tick_s=0.01))
        try:
            ex.register_refreshables({"h.ns": H(), "quiet.ns": NoProvider(),
                                      "plain.ns": object()})
            end = time.monotonic() + 3.0
            while len(pulls) < 2 and time.monotonic() < end:
                time.sleep(0.02)
            return len(pulls) >= 2, sorted(ex.snapshot()["maintenance"])
        finally:
            ex.close()

    ref, port = both(scenario)
    assert ref == port == (True, ["h.ns"])


def test_opa_scenario_oracle_parity_and_verdicts():
    """The Rego engine as an overlay scenario on the executor's opa lane:
    allow and deny verdicts equal to the host oracle's."""
    def scenario(p):
        store = p.workloads.make_opa_store(42)
        srv = _server(p, store)
        try:
            base = p.monitor.host_action_counters()
            bags = [p.bag(x) for x in p.workloads.make_opa_requests(24, 42)]
            d = srv.controller.dispatcher
            fused = [resp(r) for r in d.check(bags)]
            oracle = [resp(r) for r in d.check_host_oracle(bags)]
            return fused, oracle, hc_delta(p, base)
        finally:
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port
    fused, oracle, d = port
    assert [r[0] for r in fused] == [r[0] for r in oracle]
    assert {r[0] for r in fused} >= {0, 7}
    assert d["by_handler"]["opah.istio-system"]["outcomes"]["ok"] >= 12
    assert d["exact"]


def test_shared_quota_dedup_across_replicas():
    """memquota over one shared QuotaBackend behind two servers, the
    allocations on the executor's mq lane: a dedup_id retried on the
    other server replays the grant, and the shared window holds under
    concurrency."""
    def scenario(p):
        backend = p.QuotaBackend()
        stores = [p.workloads.make_shared_quota_store(backend,
                                                      max_amount=32)
                  for _ in range(2)]
        a, b = (_server(p, s) for s in stores)
        try:
            base = p.monitor.host_action_counters()
            bag = p.bag({"source.user": "u1",
                         "destination.service": "x.ns0.svc.cluster.local"})
            r1 = a.quota(bag, "rq.istio-system",
                         p.QuotaArgs(quota_amount=5, dedup_id="d-1"))
            r2 = b.quota(bag, "rq.istio-system",
                         p.QuotaArgs(quota_amount=5, dedup_id="d-1"))
            granted = []
            lock = threading.Lock()

            def worker(srv, n):
                for _ in range(n):
                    r = srv.quota(bag, "rq.istio-system",
                                  p.QuotaArgs(quota_amount=3,
                                              best_effort=True))
                    with lock:
                        granted.append(r.granted_amount)

            ts = [threading.Thread(target=worker, args=(s, 10))
                  for s in (a, b)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            return ((r1.granted_amount, r2.granted_amount),
                    backend.dedup["d-1"][0], sum(granted), len(granted),
                    hc_delta(p, base))
        finally:
            a.close()
            b.close()
            for s in stores:
                s.close()

    ref, port = both(scenario)
    assert ref == port
    assert port[:4] == ((5, 5), 5, 27, 20)
    d = port[4]
    assert d["by_handler"]["mq.istio-system"] == {
        "submitted": 22, "outcomes": {"ok": 22}}


def test_inline_path_parity_when_executor_disabled():
    """host_executor=False runs the inline loop, with the same verdicts
    on the same traffic."""
    def scenario(p):
        stores = [p.workloads.make_store(60, host_overlay_every=5)
                  for _ in range(2)]
        srv_ex = _server(p, stores[0])
        srv_in = _server(p, stores[1], host_executor=False)
        try:
            bags = [_overlay_bag(p, i) for i in (2, 7, 12, 22, 32, 42)]
            d_ex, d_in = (x.controller.dispatcher for x in (srv_ex, srv_in))
            return (srv_in.executor is None, d_in.executor is None,
                    d_ex.executor is srv_ex.executor,
                    [resp(r) for r in d_ex.check(bags)],
                    [resp(r) for r in d_in.check(bags)])
        finally:
            srv_ex.close()
            srv_in.close()
            for s in stores:
                s.close()

    ref, port = both(scenario)
    assert ref == port
    assert port[:3] == (True, True, True) and port[3] == port[4]


def test_abandon_keeps_conservation_exact_without_breaker_blame():
    """A fold unwinding past submitted actions accounts each exactly once
    and does not charge the adapter's breaker."""
    def scenario(p):
        ex = p.executor.AdapterExecutor(p.executor.ExecutorConfig())
        try:
            base = p.monitor.host_action_counters()
            p.CHAOS.wedge_adapter("h.ns")
            running = ex.submit("h.ns", lambda: "never", lambda pol, r: None)
            done = ex.submit("ok.ns", lambda: "fast", lambda pol, r: None)
            claimed = ex.resolve(done)
            ex.abandon(done)
            ex.abandon(running)
            d = hc_delta(p, base)
            return claimed, d, ex.lane("h.ns").breaker.state
        finally:
            p.CHAOS.reset()
            ex.close()

    ref, port = both(scenario)
    assert ref == port
    claimed, d, state = port
    assert claimed == "fast" and state == "closed" and d["exact"]
    assert d["outcomes"] == {"ok": 1, "error": 0, "shed": 0, "expired": 1,
                             "overrun": 0, "breaker_open": 0}


def test_quota_adapter_call_bounded_by_server_default_deadline():
    """quota() without a caller deadline takes the server's
    default_check_deadline_ms: a wedged quota backend cannot hold the
    caller unbounded."""
    def scenario(p):
        store = p.workloads.make_shared_quota_store(max_amount=8)
        srv = _server(p, store, default_check_deadline_ms=250.0)
        try:
            bag = p.bag({"source.user": "u1",
                         "destination.service": "x.ns0.svc.cluster.local"})
            p.CHAOS.wedge_adapter("mq.istio-system")
            t0 = time.perf_counter()
            r = srv.quota(bag, "rq.istio-system", p.QuotaArgs(quota_amount=2))
            wall = time.perf_counter() - t0
            return (r.granted_amount, r.status_code, r.status_message,
                    wall < 0.25 + 0.35)
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port == (0, UNAVAILABLE,
                           "quota adapter unavailable (overrun)", True)


def test_executor_survives_config_swap_with_breaker_state():
    """Lanes and their breakers persist across a republish: a wedged
    handler stays short-circuited through a swap."""
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store, host_breaker_failures=1,
                      host_breaker_reset_s=60.0,
                      host_action_timeout_ms=100.0)
        try:
            p.CHAOS.wedge_adapter(CI)
            first = resp(srv.check(_overlay_bag(p, 2)))
            opened = srv.executor.lane(CI).breaker.state
            store.set(("rule", "ns1", "rule1"), {
                "match": 'destination.service == "zz.ns1.svc.cluster.local"',
                "actions": [{"handler": "denyall.istio-system",
                             "instances": []}]})
            srv.controller.rebuild()
            same = srv.controller.dispatcher.executor is srv.executor
            kept = srv.executor.lane(CI).breaker.state
            after = resp(srv.check(_overlay_bag(p, 2)))
            return first, opened, same, kept, after
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port
    first, opened, same, kept, after = port
    assert first[0] == after[0] == UNAVAILABLE
    assert after[1] == "host adapter unavailable (breaker_open)"
    assert (opened, same, kept) == ("open", True, "open")


# ---------------------------------------------------------------------
# scripts/executor_smoke.py's checks, less the gRPC front and the HTTP
# scrape
# ---------------------------------------------------------------------

def test_executor_smoke_checks():
    """A wedged handler under closed-loop load with the server's default
    deadline: every call answers within the budget, typed UNAVAILABLE;
    the other handler's rules keep their clean verdicts; overruns and
    breaker short-circuits are counted and the ledger is exact; the
    executor's snapshot shows the wedged lane open and the provider in
    its maintenance view; the lane recovers by its half-open probe."""
    # the lane breaker's reset outlasts the short-circuited checks, so no
    # half-open probe lands inside the loop on a slow or loaded CPU and
    # both packages count the same overruns and short-circuits
    n_rules, n_checks, deadline_ms, reset_s = 60, 24, 400.0, 2.0

    def scenario(p):
        n_services = n_rules // 2
        store = p.workloads.make_store(n_rules, host_overlay_every=5)
        srv = _server(p, store, default_check_deadline_ms=deadline_ms,
                      host_breaker_failures=2, host_breaker_reset_s=reset_s)
        try:
            base = p.monitor.host_action_counters()
            ci_rules = [i for i in range(2, n_rules, 5) if (i // 5) % 3 == 0]
            prov_rules = [i for i in range(2, n_rules, 5)
                          if (i // 5) % 3 == 1]
            ci_bag = _overlay_bag(p, ci_rules[0], n_services)
            prov_bag = _overlay_bag(p, prov_rules[0], n_services)
            clean_ci = resp(srv.check(ci_bag))
            clean_prov = resp(srv.check(prov_bag))
            p.CHAOS.wedge_adapter(CI)
            budget_s = deadline_ms / 1e3 + 0.35
            codes, slow = [], 0
            for k in range(n_checks):
                t0 = time.perf_counter()
                # the default deadline, as the native front applies it
                r = srv.check(_overlay_bag(p, ci_rules[k % len(ci_rules)],
                                           n_services),
                              deadline=time.perf_counter()
                              + deadline_ms / 1e3)
                slow += time.perf_counter() - t0 > budget_s
                codes.append(r.status_code)
            t0 = time.perf_counter()
            prov = resp(srv.check(prov_bag))
            prov_fast = time.perf_counter() - t0 <= budget_s
            mid = hc_delta(p, base)
            snap = srv.executor.snapshot()
            lane_state = snap["lanes"][CI]["breaker"]["state"]
            maint = sorted(snap["maintenance"])
            same_ledger = snap["counters"]["submitted"] == \
                p.monitor.host_action_counters()["submitted"]
            p.CHAOS.unwedge_adapter(CI)
            time.sleep(reset_s + 0.05)
            recovered = resp(srv.check(ci_bag))
            closed = srv.executor.lane(CI).breaker.state
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()
        return {"codes": codes, "slow": slow, "prov": prov,
                "clean": (clean_ci, clean_prov), "prov_fast": prov_fast,
                "overrun": mid["outcomes"]["overrun"],
                "breaker_open": mid["outcomes"]["breaker_open"],
                "exact": mid["exact"], "lane": lane_state, "maint": maint,
                "same_ledger": same_ledger, "recovered": recovered,
                "closed": closed}

    ref, port = both(scenario)
    assert ref == port
    assert port["codes"] == [UNAVAILABLE] * n_checks and port["slow"] == 0
    assert port["prov"] == port["clean"][1] and port["prov_fast"]
    assert port["overrun"] >= 2 and port["breaker_open"] >= 1
    assert port["exact"] and port["same_ledger"]
    assert port["lane"] == "open" and port["maint"] == [PROV]
    assert port["recovered"] == port["clean"][0]
    assert port["closed"] == "closed"


# ---------------------------------------------------------------------
# the port's contract
# ---------------------------------------------------------------------

def test_lane_breaker_never_moves_the_device_breaker_counters():
    """A lane breaker trips and recovers without moving the device
    breaker's transitions counter or its state gauge (chip_smoke's gate
    reads the counter); the device breaker still publishes both."""
    def scenario(p):
        t0, g0 = p.transitions(), p.breaker_gauge()
        lane_b = p.res.CircuitBreaker(failures=1, reset_s=0.05,
                                      publish=False, name="handler:x")
        lane_b.record_failure()
        seen = [lane_b.state, p.breaker_gauge() == g0]
        time.sleep(0.06)
        seen += [lane_b.allow_device(), lane_b.state]
        lane_b.record_success()
        seen += [lane_b.state, p.transitions() == t0,
                 p.breaker_gauge() == g0]
        dev = p.res.CircuitBreaker(failures=1, reset_s=60.0)
        dev.record_failure()
        seen += [p.breaker_gauge(), p.transitions()["open"] - t0["open"]]
        p.res.CircuitBreaker()      # a new device breaker resets the gauge
        return seen

    ref, port = both(scenario)
    assert ref == port == ["open", True, True, "half_open", "closed", True,
                           True, 2, 1]


def test_lane_trips_leave_the_device_breaker_alone():
    """Served end to end: lane errors and an open lane breaker move the
    host counters only; the device breaker stays closed, its transitions
    and the check fallbacks unmoved."""
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store, host_breaker_failures=2,
                      host_breaker_reset_s=60.0)
        try:
            t0 = p.transitions()
            r0 = p.monitor.resilience_counters()
            p.CHAOS.adapter_failures[CI] = 10 ** 6
            out = [resp(srv.check(_overlay_bag(p, 2))) for _ in range(3)]
            r1 = p.monitor.resilience_counters()
            return (out, srv.executor.lane(CI).breaker.state,
                    srv.resilience.breaker.state, p.transitions() == t0,
                    r1["fallback_total"] - r0["fallback_total"],
                    r1["device_retries_total"] - r0["device_retries_total"])
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port
    out, lane, device, unmoved, fb, retries = port
    assert [r[0] for r in out] == [13, 13, UNAVAILABLE]
    assert (lane, device, unmoved, fb, retries) == ("open", "closed", True,
                                                    0, 0)


def test_exception_between_submit_and_claim_abandons_every_action():
    """A fold that raises after its host actions were submitted (here:
    the first merge of a claimed result) abandons every unclaimed one:
    the ledger stays exact, no lane breaker is charged, and the next
    batch serves normally."""
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store)
        d = srv.controller.dispatcher
        real = p.dispatcher.Dispatcher._combine
        try:
            bags = [_overlay_bag(p, i) for i in (2, 7, 12, 22, 32, 42)]
            clean = [resp(r) for r in d.check(bags)]
            base = p.monitor.host_action_counters()

            def boom(resp_, r):
                raise RuntimeError("fold failed")

            p.dispatcher.Dispatcher._combine = staticmethod(boom)
            try:
                with pytest.raises(RuntimeError, match="fold failed"):
                    d.check(bags)
            finally:
                p.dispatcher.Dispatcher._combine = staticmethod(real)
            dd = _settle(p, base)
            states = sorted({srv.executor.lane(h).breaker.state
                             for h in dd["by_handler"]})
            again = [resp(r) for r in d.check(bags)]
            return (dd["exact"], dd["submitted"],
                    sum(dd["outcomes"].values()), states, again == clean)
        finally:
            p.dispatcher.Dispatcher._combine = staticmethod(real)
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port == (True, 6, 6, ["closed"], True)


def test_failed_submission_pass_abandons_what_it_submitted():
    """An instance build that raises (not an EvalError, so the batch
    fails, as the inline loop's would) part way through the submission
    pass abandons the actions already submitted: the ledger stays exact.
    The port's own contract: the reference's fold starts its unwind only
    after the submission pass, so those actions stay unresolved there."""
    store = workloads.make_store(60, host_overlay_every=5)
    srv = _server(PORT, store)
    try:
        d = srv.controller.dispatcher
        ib = d.snapshot.instances["nsinst.istio-system"]
        real = ib.build
        calls = []

        def build(bag):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("instance build failed")
            return real(bag)

        base = monitor.host_action_counters()
        ib.build = build
        try:
            # nsinst rows 2, 7, 22, 32 and pathinst row 12: the third
            # nsinst build (row 22) raises after 3 submits
            with pytest.raises(RuntimeError, match="instance build failed"):
                d.check([_overlay_bag(PORT, i)
                         for i in (2, 7, 12, 22, 32, 42)])
        finally:
            ib.build = real
        dd = _settle(PORT, base)
        assert (dd["exact"], dd["submitted"],
                sum(dd["outcomes"].values())) == (True, 3, 3)
        assert {srv.executor.lane(h).breaker.state
                for h in dd["by_handler"]} == {"closed"}
    finally:
        srv.close()
        store.close()


def test_retried_device_fault_submits_host_actions_once():
    """A CHAOS device fault that the ResilientChecker retries fails
    before any host action is submitted: the retried batch submits each
    action once, and the ledger stays exact."""
    def scenario(p):
        store = p.workloads.make_store(60, host_overlay_every=5)
        srv = _server(p, store)
        try:
            bags = [_overlay_bag(p, i) for i in (2, 7, 12, 22, 32, 42)]
            clean = [resp(r) for r in srv.check_many(bags)]
            base = p.monitor.host_action_counters()
            r0 = p.monitor.resilience_counters()["device_retries_total"]
            p.CHAOS.device_failures = 1
            got = [resp(r) for r in srv.check_many(bags)]
            dd = hc_delta(p, base)
            return (got == clean, dd["submitted"], dd["outcomes"]["ok"],
                    dd["exact"],
                    p.monitor.resilience_counters()["device_retries_total"]
                    - r0)
        finally:
            p.CHAOS.reset()
            srv.close()
            store.close()

    ref, port = both(scenario)
    assert ref == port == (True, 6, 6, True, 1)


def test_chaos_adapter_levers_are_armed_and_reset_releases_wedges():
    """The adapter levers show in armed() and snapshot(), and reset()
    releases a call blocked on a wedge."""
    def scenario(p):
        c = p.CHAOS
        c.wedge_adapter("w.ns")
        snap = c.snapshot()
        box = {}
        t = threading.Thread(target=lambda: box.update(
            done=c.adapter_call("w.ns") is None))
        t.start()
        time.sleep(0.05)
        blocked = t.is_alive()
        c.reset()
        t.join(5.0)
        return (snap["adapter_wedged"], blocked, box.get("done"),
                snap["injected_adapter"])

    ref, port = both(scenario)
    assert ref == port == (["w.ns"], True, True, 0)
    chaos = resilience.CHAOS
    chaos.wedge_adapter("w.ns")
    assert chaos.armed() == ["adapter_wedged"]
    chaos.unwedge_adapter("w.ns")
    assert chaos.armed() == []


def test_executor_fields_are_carried():
    """The executor and grant fields of ServerArgs reach the executor
    and the grant policy; a bad host_fail_policy raises the reference's
    ValueError; Dispatcher and Controller take executor= and grants=."""
    store = workloads.make_store(8)
    try:
        srv = RuntimeServer(store, ServerArgs(
            initial_prewarm=False, executor_workers=3,
            executor_queue_cap=7, host_fail_policy="open",
            host_action_timeout_ms=250.0, host_breaker_failures=4,
            host_breaker_reset_s=0.1, default_check_deadline_ms=30.0,
            check_grants=True, grant_ttl_floor_s=0.5, grant_ttl_cap_s=2.0,
            grant_ttl_ramp_per_s=1.5), device="cpu")
        try:
            cfg = srv.executor.config
            assert (cfg.workers, cfg.queue_cap, cfg.fail_policy,
                    cfg.action_timeout_s, cfg.breaker_failures,
                    cfg.breaker_reset_s) == (3, 7, "open", 0.25, 4, 0.1)
            g = srv.grants
            assert (g.ttl_floor_s, g.ttl_cap_s, g.ttl_ramp_per_s,
                    g.generation) == (0.5, 2.0, 1.5, 1)
            d = srv.controller.dispatcher
            assert d.executor is srv.executor and d.grants is srv.grants
            again = type(d)(d.snapshot, d.handlers, fused=d.fused,
                            executor=srv.executor, grants=srv.grants)
            assert again.executor is srv.executor
        finally:
            srv.close()
        off = RuntimeServer(store, ServerArgs(initial_prewarm=False,
                                              host_executor=False),
                            device="cpu")
        try:
            assert off.executor is None and off.grants is None
            assert off.controller.dispatcher.executor is None
        finally:
            off.close()
        for p in (REF, PORT):
            with pytest.raises(ValueError, match="fail_policy"):
                p.executor.AdapterExecutor(
                    p.executor.ExecutorConfig(fail_policy="maybe"))
        with pytest.raises(ValueError, match="fail_policy"):
            RuntimeServer(store, ServerArgs(host_fail_policy="maybe"),
                          device="cpu")
    finally:
        store.close()
