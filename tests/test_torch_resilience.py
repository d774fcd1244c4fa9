"""The port's Check() resilience plane against the JAX package's.

Every scenario of tests/test_resilience.py but two (the /healthz probe
needs the introspect server, the chunked-front expiry the gRPC front;
neither is ported) runs on both packages from the same inputs, and the
outcomes must be equal: responses, typed error class and gRPC code,
counter deltas, breaker states. Then scripts/chaos_smoke.py's checks
(without its introspect scrape) on a small RuntimeServer of each
package, the continuous-batching lane across a config publish, quota() (with the
server's default_check_deadline_ms bounding a wedged quota lane on the
executor), and the seven resilience fields of ServerArgs. The card's strict checker (a device fault that
CHAOS did not inject raises) is held against the reference's chain for
the faults CHAOS injects.

Scenarios whose exact counts depend on thread timing (how many submits
a full queue sheds) compare the reference test's invariants, not the
counts. Every test runs with both packages' CHAOS seams and live
latency windows reset around it (`_isolated`): the suite shares worker
processes under `-n 6 --dist loadfile`, and a leaked `device_failures`
would fail later files on the same worker.
"""
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime import batcher as ref_batcher
from istio_tpu.runtime import monitor as ref_monitor
from istio_tpu.runtime import resilience as ref_resilience
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.runtime import batcher, monitor, resilience
from istio_tpu_torch.testing import workloads

STATES = ("closed", "half_open", "open")


def _ref_transitions() -> dict:
    return {s: int(ref_monitor.BREAKER_TRANSITIONS.labels(to=s)._value.get())
            for s in STATES}


def _port_transitions() -> dict:
    return {s: int(monitor.BREAKER_TRANSITIONS.value(s)) for s in STATES}


REF = SimpleNamespace(
    name="ref", batcher=ref_batcher, monitor=ref_monitor, res=ref_resilience,
    CHAOS=ref_resilience.CHAOS, bag=ref_bag, transitions=_ref_transitions,
    tensorized=lambda: ref_monitor.CHECK_STAGE_SECONDS.count(
        stage="tensorize"))
PORT = SimpleNamespace(
    name="port", batcher=batcher, monitor=monitor, res=resilience,
    CHAOS=resilience.CHAOS, bag=bag_from_mapping,
    transitions=_port_transitions,
    tensorized=lambda: monitor.CHECK_STAGE_SECONDS.state("tensorize")[2])

# the reference server with the planes the port does not carry switched
# off where they would act behind the test's back
REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)


def _reset_both() -> None:
    for p in (REF, PORT):
        p.CHAOS.reset()
        p.monitor.reset_latency_window()


@pytest.fixture(autouse=True)
def _isolated():
    """The one place that arms nothing and disarms everything: both
    packages' CHAOS seams and live latency windows, before and after
    every test, whatever the test did."""
    _reset_both()
    try:
        yield
    finally:
        _reset_both()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def counters(p) -> dict:
    c = p.monitor.resilience_counters()
    c["transitions"] = p.transitions()
    c["cancelled"] = c["cancelled_shed_total"]
    return c


def delta(after, before):
    """after - before, key by key (the counters are process-wide)."""
    if isinstance(after, dict):
        return {k: delta(v, before[k]) for k, v in after.items()
                if k != "breaker_state"}
    return after - before


def outcome(fn):
    """('ok', value) or (error class name, grpc code, message)."""
    try:
        return ("ok", fn())
    except Exception as exc:   # noqa: BLE001 — the outcome is the point
        return (type(exc).__name__, getattr(exc, "grpc_code", None),
                str(exc))


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


def fields(r) -> tuple:
    return (r.status_code, r.valid_duration_s, r.valid_use_count)


# ---------------------------------------------------------------------
# circuit breaker state machine
# ---------------------------------------------------------------------

def test_breaker_trips_after_threshold_and_recovers():
    def scenario(p):
        t0 = p.transitions()
        b = p.res.CircuitBreaker(failures=3, reset_s=0.05)
        seen = [b.state]
        for _ in range(2):
            b.record_failure()
        seen += [b.state, b.allow_device()]
        b.record_failure()
        seen += [b.state, b.allow_device()]
        time.sleep(0.06)
        seen += [b.allow_device(), b.state, b.allow_device()]
        b.record_success()
        seen += [b.state, b.allow_device(), delta(p.transitions(), t0)]
        return seen

    ref, port = both(scenario)
    assert ref == port
    assert port[:-1] == ["closed", "closed", True, "open", False, True,
                         "half_open", False, "closed", True]
    assert port[-1] == {"closed": 1, "half_open": 1, "open": 1}


def test_breaker_probe_failure_reopens():
    def scenario(p):
        b = p.res.CircuitBreaker(failures=1, reset_s=0.05)
        b.record_failure()
        seen = [b.state]
        time.sleep(0.06)
        seen.append(b.allow_device())
        b.record_failure()
        seen += [b.state, b.allow_device(), b.snapshot()["probe_inflight"]]
        return seen

    ref, port = both(scenario)
    assert ref == port == ["open", True, "open", False, False]


# ---------------------------------------------------------------------
# ResilientChecker (stub device / oracle)
# ---------------------------------------------------------------------

def _fast_config(p, **kw):
    kw.setdefault("retry_backoff_s", 0.001)
    kw.setdefault("retry_jitter_s", 0.001)
    return p.res.ResilienceConfig(**kw)


def test_retry_absorbs_transient_device_fault():
    def scenario(p):
        calls = {"n": 0}

        def device(bags):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")
            return ["dev"] * len(bags)

        rc = p.res.ResilientChecker(device,
                                    lambda bags: ["oracle"] * len(bags),
                                    config=_fast_config(p))
        c0 = counters(p)
        out = rc.run_batch(["a", "b"])
        return out, calls["n"], rc.breaker.state, delta(counters(p), c0)

    ref, port = both(scenario)
    assert ref == port
    out, n, state, d = port
    assert out == ["dev", "dev"] and n == 2 and state == "closed"
    assert d["device_retries_total"] == 1 and d["fallback_total"] == 0


def test_double_failure_falls_back_to_oracle_and_counts():
    def scenario(p):
        def device(bags):
            raise RuntimeError("down")

        def oracle(bags):
            # the real check_host_oracle answers per REAL row
            return ["oracle"] * len(p.batcher.trim_pads(list(bags)))

        rc = p.res.ResilientChecker(
            device, oracle, config=_fast_config(p, breaker_failures=2))
        c0 = counters(p)
        seen = [rc.run_batch(["a", "b", p.batcher.PadBag()]),
                rc.breaker.state, delta(counters(p), c0)["fallback"]]
        rc.run_batch(["c"])
        seen.append(rc.breaker.state)
        seen.append(rc.run_batch(["d"]))
        seen.append(delta(counters(p), c0))
        return seen

    ref, port = both(scenario)
    assert ref == port
    first, state1, fb1, state2, open_out, d = port
    assert first == ["oracle", "oracle"] and state1 == "closed"
    # pad rows carry no caller: the per-request counter skips them
    assert fb1["device_error"] == 2
    assert state2 == "open" and open_out == ["oracle"]
    assert d["fallback"] == {"breaker_open": 1, "device_error": 3,
                             "fail_open": 0}
    assert d["transitions"] == {"closed": 0, "half_open": 0, "open": 1}


def test_half_open_probe_released_on_typed_rejection():
    def scenario(p):
        calls = {"n": 0}

        def device(bags):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("down")
            if calls["n"] == 2:
                raise p.res.UnavailableError("typed rejection mid-probe")
            return ["dev"] * len(bags)

        rc = p.res.ResilientChecker(
            device, lambda bags: ["oracle"] * len(bags),
            config=_fast_config(p, breaker_failures=1, breaker_reset_s=0.05,
                                retry=False))
        seen = [rc.run_batch(["a"]), rc.breaker.state]
        time.sleep(0.06)
        seen.append(outcome(lambda: rc.run_batch(["b"])))
        seen.append(rc.breaker.state)
        seen += [rc.run_batch(["c"]), rc.breaker.state]
        return seen

    ref, port = both(scenario)
    assert ref == port
    assert port[0] == ["oracle"] and port[1] == "open"
    assert port[2][:2] == ("UnavailableError", 14)
    assert port[3] == "half_open"
    assert port[4:] == [["dev"], "closed"]


def _broken(bags):
    raise RuntimeError("down")


def test_fail_open_short_ttls():
    def scenario(p):
        rc = p.res.ResilientChecker(
            _broken, _broken, config=_fast_config(p, fail_policy="open"))
        c0 = counters(p)
        return ([fields(r) for r in rc.run_batch(["a"])],
                delta(counters(p), c0)["fallback"])

    ref, port = both(scenario)
    assert ref == port
    assert port[0] == [(0, 1.0, 1)]
    assert port[1]["fail_open"] == 1


def test_fail_closed_raises_unavailable():
    def scenario(p):
        rc = p.res.ResilientChecker(
            _broken, _broken, config=_fast_config(p, fail_policy="closed"))
        c0 = counters(p)
        out = outcome(lambda: rc.run_batch(["a"]))
        return out[:2], delta(counters(p), c0)["fallback_total"]

    ref, port = both(scenario)
    assert ref == port == (("UnavailableError", 14), 0)


def test_fail_open_answers_ok():
    def scenario(p):
        rc = p.res.ResilientChecker(
            _broken, _broken, config=_fast_config(p, fail_policy="open"))
        return [fields(r) for r in
                rc.run_batch(["a", "b", p.batcher.PadBag()])]

    ref, port = both(scenario)
    assert ref == port == [(0, 1.0, 1), (0, 1.0, 1)]


# ---------------------------------------------------------------------
# the card's strict checker: only CHAOS-injected faults are absorbed
# ---------------------------------------------------------------------

def _chaos_device(p):
    """A device callable whose trip starts at the package's CHAOS
    device seam, as FusedPlan.packed_check's does."""
    def device(bags):
        p.CHAOS.device_step()
        return ["dev"] * len(bags)
    return device


def _checker(p, device, oracle, strict: bool, **cfg):
    kw = {"strict_device": True} if strict and p is PORT else {}
    return p.res.ResilientChecker(device, oracle,
                                  config=_fast_config(p, **cfg), **kw)


def test_chaos_armed_names_every_lever():
    """CHAOS.armed() (chip_smoke's gate reads it) names each lever that
    reset() defines, alone, and nothing once reset."""
    chaos = resilience.CHAOS
    modifiers = {"device_exception"}   # shapes a fault, injects none
    # the injection observer (the audit plane's ledger) is set after
    # reset() and is not a lever
    observers = {"on_inject"}
    levers = [k for k in vars(chaos) if not k.startswith(("_", "injected_"))
              and k not in modifiers | observers]
    assert chaos.armed() == []
    for k in levers:
        v = getattr(chaos, k)
        setattr(chaos, k, {"rq": 1} if isinstance(v, dict) else 1)
        try:
            assert chaos.armed() == [k], k
        finally:
            chaos.reset()


@pytest.mark.parametrize("retry", [True, False])
def test_strict_device_raises_a_real_fault(retry):
    """A strict checker raises a device fault that CHAOS did not inject:
    no retry, no oracle call, no fallback, no breaker failure. The same
    fault through the reference's checker (and the port's default one)
    is retried and answered by the oracle."""
    oracle_calls = []

    def oracle(bags):
        oracle_calls.append(len(bags))
        return ["oracle"] * len(bags)

    def device(bags):
        raise RuntimeError("kernel launch failed")

    def run(p, strict):
        rc = _checker(p, device, oracle, strict, retry=retry,
                      breaker_failures=1)
        c0 = counters(p)
        out = outcome(lambda: rc.run_batch(["a", "b"]))
        return out, rc.breaker.state, delta(counters(p), c0)

    ref, port = both(lambda p: run(p, strict=False))
    assert ref == port
    assert port[0] == ("ok", ["oracle", "oracle"]) and port[1] == "open"
    oracle_calls.clear()
    _reset_both()
    out, state, d = run(PORT, strict=True)
    assert out == ("RuntimeError", None, "kernel launch failed")
    assert state == "closed" and oracle_calls == []
    assert (d["device_retries_total"], d["fallback_total"],
            d["transitions"]) == (0, 0, {"closed": 0, "half_open": 0,
                                         "open": 0})


def test_strict_device_takes_injected_faults_like_the_reference():
    """Faults injected through CHAOS's device seam take the reference's
    whole chain on a strict checker: one absorbed by the retry, then
    two that open the breaker and are answered by the oracle, a batch
    while open, the half-open probe that closes it."""
    def scenario(p):
        rc = _checker(p, _chaos_device(p),
                      lambda bags: ["oracle"] * len(bags), strict=True,
                      breaker_failures=1, breaker_reset_s=0.05)
        c0 = counters(p)
        p.CHAOS.device_failures = 1
        seen = [rc.run_batch(["a"]), rc.breaker.state]
        p.CHAOS.device_failures = 2
        seen += [rc.run_batch(["b"]), rc.breaker.state, rc.run_batch(["c"])]
        time.sleep(0.06)
        seen += [rc.run_batch(["d"]), rc.breaker.state,
                 p.CHAOS.snapshot()["injected_device"],
                 delta(counters(p), c0)]
        return seen

    ref, port = both(scenario)
    assert ref == port
    assert port[:7] == [["dev"], "closed", ["oracle"], "open", ["oracle"],
                        ["dev"], "closed"]
    assert port[7] == 3 and port[8]["device_retries_total"] == 2
    assert port[8]["fallback"] == {"breaker_open": 1, "device_error": 1,
                                   "fail_open": 0}


def test_strict_probe_real_fault_releases_the_slot():
    """A half-open probe that meets a real fault on a strict checker
    raises it and returns the probe slot: the next batch probes again
    and closes the breaker."""
    calls = {"n": 0}

    def device(bags):
        calls["n"] += 1
        if calls["n"] == 1:
            PORT.CHAOS.device_failures = 1
            PORT.CHAOS.device_step()
        if calls["n"] == 2:
            raise RuntimeError("kernel launch failed")
        return ["dev"] * len(bags)

    rc = _checker(PORT, device, lambda bags: ["oracle"] * len(bags),
                  strict=True, retry=False, breaker_failures=1,
                  breaker_reset_s=0.05)
    seen = [rc.run_batch(["a"]), rc.breaker.state]
    time.sleep(0.06)
    seen.append(outcome(lambda: rc.run_batch(["b"]))[0])
    seen += [rc.breaker.state, rc.breaker.snapshot()["probe_inflight"]]
    seen += [rc.run_batch(["c"]), rc.breaker.state]
    assert seen == [["oracle"], "open", "RuntimeError", "half_open", False,
                    ["dev"], "closed"]


# ---------------------------------------------------------------------
# batcher admission control and deadlines
# ---------------------------------------------------------------------

def _blocked_batcher(p, release: threading.Event, max_batch: int = 1,
                     **kw):
    """pipeline=1 and a run_batch that blocks: the first batch occupies
    the worker, the second wedges the flusher in _flush's semaphore,
    and everything after queues."""
    seen: list = []

    def run_batch(bags):
        seen.append(list(bags))
        release.wait(timeout=30)
        return [("ok", i) for i in range(len(bags))]

    b = p.batcher.CheckBatcher(run_batch, window_s=0.0005,
                               max_batch=max_batch, pipeline=1,
                               buckets=(max_batch,), pad_batches=False, **kw)
    return b, seen


def _shed_scenario(p, reason: str, **kw):
    """Submit 8 behind a blocked batcher with a queue cap of 2 (or 4
    with brownout). → the reference test's invariants."""
    release = threading.Event()
    b, _ = _blocked_batcher(p, release, **kw)
    try:
        c0 = counters(p)
        futs = [b.submit(f"bag{i}") for i in range(8)]
        shed = [f for f in futs
                if f.done() and isinstance(f.exception(),
                                           p.res.ResourceExhaustedError)
                and (reason != "brownout" or "brownout" in
                     str(f.exception()))]
        depth = b.stats()["depth"]
        release.set()
        served = [f.result(timeout=10)[0] for f in futs if f not in shed
                  and f.exception(timeout=10) is None]
        d = delta(counters(p), c0)
        return {"some_shed": bool(shed),
                "counter_equals_sheds": d["shed"][reason] == len(shed),
                "depth_within_cap": depth <= kw["max_queue"],
                "admitted_served": set(served) <= {"ok"},
                "grpc_codes": sorted({f.exception().grpc_code
                                      for f in shed})}
    finally:
        release.set()
        b.close()


def test_queue_cap_sheds_resource_exhausted():
    ref, port = both(lambda p: _shed_scenario(p, "queue_full",
                                              max_queue=2))
    assert ref == port == {"some_shed": True, "counter_equals_sheds": True,
                           "depth_within_cap": True,
                           "admitted_served": True, "grpc_codes": [8]}


def test_brownout_sheds_newest_when_p99_over_target():
    def scenario(p):
        # an SLO-breaching live window (p99 >> the 1 ms target)
        for _ in range(64):
            p.monitor.observe_check_e2e(0.100)
        return _shed_scenario(p, "brownout", max_queue=4, brownout=True)

    ref, port = both(scenario)
    assert ref == port
    assert port["some_shed"] and port["counter_equals_sheds"]
    assert port["grpc_codes"] == [8]


def test_brownout_needs_p99_over_target():
    """The other half of the brownout condition: a window under the
    target (or empty) sheds nothing by brownout, however deep the
    queue."""
    def scenario(p):
        for _ in range(64):
            p.monitor.observe_check_e2e(0.0001)
        under = p.monitor.refresh_latency_gauges()["under_target"]
        return _shed_scenario(p, "brownout", max_queue=4, brownout=True), \
            under

    ref, port = both(scenario)
    assert ref == port
    assert port[1] is True
    assert not port[0]["some_shed"] and port[0]["counter_equals_sheds"]


def test_deadline_expired_at_submit_rejects():
    def scenario(p):
        b = p.batcher.CheckBatcher(lambda bags: [1] * len(bags),
                                   window_s=0.0005)
        try:
            c0 = counters(p)
            t0 = p.tensorized()
            fut = b.submit("bag", deadline=time.perf_counter() - 0.1)
            out = outcome(lambda: fut.result(timeout=5))
            return (out[:2], delta(counters(p), c0)["expired_total"],
                    p.tensorized() - t0)
        finally:
            b.close()

    ref, port = both(scenario)
    assert ref == port == (("DeadlineExceededError", 4), 1, 0)


def test_deadline_expired_in_queue_shed_before_run_batch():
    def scenario(p):
        release = threading.Event()
        b, seen = _blocked_batcher(p, release, max_batch=4)
        try:
            f1 = b.submit("first")       # trip 1 occupies the worker
            time.sleep(0.02)
            f2 = b.submit("stale", deadline=time.perf_counter() + 0.01)
            time.sleep(0.05)             # expire behind trip 1
            release.set()
            return (outcome(lambda: f2.result(timeout=10))[:2],
                    f1.result(timeout=10)[0],
                    any("stale" in batch for batch in seen))
        finally:
            release.set()
            b.close()

    ref, port = both(scenario)
    assert ref == port == (("DeadlineExceededError", 4), "ok", False)


def test_occupancy_hold_never_outlasts_deadline():
    def scenario(p):
        release = threading.Event()
        seen: list = []

        def run_batch(bags):
            seen.append(list(bags))
            if len(seen) == 1:
                release.wait(timeout=30)
            return ["ok"] * len(bags)

        b = p.batcher.CheckBatcher(run_batch, window_s=0.0005, max_batch=64,
                                   pipeline=2, buckets=(64,),
                                   pad_batches=False, hold_at=1)
        try:
            f1 = b.submit("first")
            time.sleep(0.02)             # trip 1 in flight -> busy
            t0 = time.perf_counter()
            f2 = b.submit("held", deadline=time.perf_counter() + 0.05)
            got = outcome(lambda: f2.result(timeout=10))
            waited = time.perf_counter() - t0
            # served before its deadline, or shed if dispatch lost the
            # race — never held for the 30 s trip
            ok = got == ("ok", "ok") and any("held" in x for x in seen) \
                or got[:2] == ("DeadlineExceededError", 4)
            release.set()
            return ok, waited < 2.0, f1.result(timeout=10)
        finally:
            release.set()
            b.close()

    ref, port = both(scenario)
    assert ref == port == (True, True, "ok")


def test_cancelled_future_shed_at_batch_build():
    def scenario(p):
        seen: list = []

        def run_batch(bags):
            seen.append(list(bags))
            return ["ok"] * len(bags)

        b = p.batcher.CheckBatcher(run_batch, window_s=0.2, max_batch=8,
                                   buckets=(8,), pad_batches=False)
        try:
            c0 = counters(p)
            f1 = b.submit("keep1")
            f2 = b.submit("gone")
            f3 = b.submit("keep2")
            cancelled = f2.cancel()
            return (cancelled, f1.result(timeout=10), f3.result(timeout=10),
                    bool(seen) and all("gone" not in x for x in seen),
                    delta(counters(p), c0)["cancelled"],
                    delta(counters(p), c0)["shed_total"])
        finally:
            b.close()

    ref, port = both(scenario)
    assert ref == port == (True, "ok", "ok", True, 1, 0)


def test_batch_failure_counter_and_typed_error():
    def scenario(p):
        def run_batch(bags):
            raise RuntimeError("device exploded")

        b = p.batcher.CheckBatcher(run_batch, window_s=0.0005)
        try:
            c0 = counters(p)
            fut = b.submit("bag")
            return (outcome(lambda: fut.result(timeout=10)),
                    delta(counters(p), c0)["batch_failures_total"])
        finally:
            b.close()

    ref, port = both(scenario)
    assert ref == port == (("RuntimeError", None, "device exploded"), 1)


def test_report_batcher_does_not_pollute_check_counters():
    def scenario(p):
        def run_batch(bags):
            raise RuntimeError("boom")

        b = p.batcher.CheckBatcher(run_batch, window_s=0.0005,
                                   size_hist=p.monitor.REPORT_BATCH_SIZE,
                                   observe_latency=False, max_queue=1,
                                   brownout=False)
        try:
            c0 = counters(p)
            fut = b.submit("bag")
            out = outcome(lambda: fut.result(timeout=10))
            d = delta(counters(p), c0)
            return out[0], d["batch_failures_total"], d["shed_total"]
        finally:
            b.close()

    ref, port = both(scenario)
    assert ref == port == ("RuntimeError", 0, 0)


# ---------------------------------------------------------------------
# flusher-thread watchdog and the submit()-vs-close() race
# ---------------------------------------------------------------------

def test_watchdog_dead_flusher_fails_fast():
    def scenario(p):
        b = p.batcher.CheckBatcher(lambda bags: ["ok"] * len(bags),
                                   window_s=0.0005, max_batch=4,
                                   buckets=(4,), pad_batches=False)
        try:
            seen = [b.submit("warm").result(timeout=10)]
            # kill the flusher: the next dispatch explodes inside _flush
            b._pool.submit = None
            f2 = b.submit("bag2")
            deadline = time.time() + 10
            while b._dead is None and time.time() < deadline:
                time.sleep(0.005)
            ok, err = b.healthy()
            seen += [b._dead is not None, ok, "died" in err,
                     outcome(lambda: f2.result(timeout=10))[:2]]
            c0 = counters(p)
            f3 = b.submit("bag3")
            seen += [outcome(lambda: f3.result(timeout=10))[:2],
                     delta(counters(p), c0)["shed"]["batcher_dead"],
                     b.stats()["healthy"]]
            return seen
        finally:
            b._pool.submit = type(b._pool).submit.__get__(b._pool)
            b._closed = True             # close() would join a dead
            b._pool.shutdown(wait=False)  # thread; tear down manually

    ref, port = both(scenario)
    assert ref == port == ["ok", True, False, True, ("UnavailableError", 14),
                           ("UnavailableError", 14), 1, False]


def _racing_close(p, poison: bool):
    seen: list = []

    def run_batch(bags):
        seen.append(list(bags))
        if "poison" in bags:
            raise RuntimeError("drain batch failed")
        return [f"ok:{bag}" for bag in bags]

    b = p.batcher.CheckBatcher(run_batch, window_s=10.0, max_batch=8,
                               buckets=(8,), pad_batches=False)
    fa = b.submit("early")               # the loop is collecting [early]
    time.sleep(0.02)
    # the race: the sentinel enters the queue, then a request that beat
    # the _closed flag lands BEHIND it
    fb: Future = Future()
    fb._t_enq = time.perf_counter()
    b._closed = True
    b._queue.put(None)
    b._queue.put(("poison" if poison else "racer", fb))
    b._thread.join(timeout=10)
    alive = b._thread.is_alive()
    out = (alive, outcome(lambda: fa.result(timeout=5)),
           outcome(lambda: fb.result(timeout=5)),
           any(("poison" if poison else "racer") in x for x in seen))
    b._pool.shutdown(wait=True)
    return out


def test_requests_racing_past_close_resolve_via_drain():
    ref, port = both(lambda p: _racing_close(p, poison=False))
    assert ref == port == (False, ("ok", "ok:early"), ("ok", "ok:racer"),
                           True)


def test_drain_on_close_failing_batch_resolves_with_exception():
    ref, port = both(lambda p: _racing_close(p, poison=True))
    assert ref == port == (False, ("ok", "ok:early"),
                           ("RuntimeError", None, "drain batch failed"),
                           True)


# ---------------------------------------------------------------------
# end to end: RuntimeServer + ChaosHooks (a small server of each package)
# ---------------------------------------------------------------------

SMALL_ARGS = dict(batch_window_s=0.0005, max_batch=8, buckets=(8,),
                  breaker_failures=2, breaker_reset_s=0.2)


def _server_pair(n_rules: int, **args):
    ref_store = ref_workloads.make_store(n_rules)
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(
        default_manifest=ref_workloads.MESH_MANIFEST, **args, **REF_ARGS))
    got = RuntimeServer(pt_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST, initial_prewarm=False,
        **args), device="cpu")
    for srv in (ref, got):
        plan = srv.controller.dispatcher.fused
        if plan is not None:
            plan.prewarm(args.get("buckets", (8,)))
    return {"ref": ref, "port": got, "stores": (ref_store, pt_store)}


def _close_pair(pair) -> None:
    _reset_both()
    pair["port"].close()
    pair["ref"].close()
    for st in pair["stores"]:
        st.close()


@pytest.fixture(scope="module")
def small_servers():
    pair = _server_pair(12, **SMALL_ARGS)
    yield pair
    _close_pair(pair)


def _dicts(n: int, seed: int = 1) -> list[dict]:
    return workloads.make_request_dicts(n, seed=seed)


def _deny_dicts(n: int = 4) -> list[dict]:
    """Requests that hit make_store's deny rules (every 3rd rule
    denies), so a parity sample carries non-OK statuses."""
    return [{"destination.service": f"svc{3 * i}.ns{(3 * i) % 23}"
                                    ".svc.cluster.local",
             "source.namespace": "ns1", "request.method": "GET"}
            for i in range(n)]


def test_breaker_fallback_parity_end_to_end(small_servers):
    dicts = _dicts(10)

    def scenario(p):
        srv = small_servers[p.name]
        bags = [p.bag(d) for d in dicts]
        c0 = counters(p)
        clean = [srv.check(b).status_code for b in bags]
        p.CHAOS.device_failures = 10**9
        try:
            degraded = [srv.check(b).status_code for b in bags]
        finally:
            p.CHAOS.reset()
        opened = srv.resilience.breaker.state
        time.sleep(0.25)                 # past breaker_reset_s
        probe = srv.check(bags[0]).status_code
        return (clean, degraded, opened, probe,
                srv.resilience.breaker.state,
                delta(counters(p), c0)["transitions"])

    ref, port = both(scenario)
    assert ref == port
    clean, degraded, opened, probe, closed, moved = port
    assert degraded == clean and probe == clean[0]
    assert (opened, closed) == ("open", "closed")
    assert moved == {"closed": 1, "half_open": 1, "open": 1}


def test_fail_policy_end_to_end(small_servers):
    d = _dicts(1)[0]

    def scenario(p):
        srv = small_servers[p.name]
        bag = p.bag(d)
        p.CHAOS.device_failures = 10**9
        p.CHAOS.oracle_failures = 10**9
        cfg = srv.resilience.config
        old = cfg.fail_policy
        try:
            cfg.fail_policy = "closed"
            closed = outcome(lambda: srv.check(bag))[:2]
            cfg.fail_policy = "open"
            opened = fields(srv.check(bag))
        finally:
            cfg.fail_policy = old
            p.CHAOS.reset()
            srv.resilience.breaker.record_success()
        return closed, opened, srv.resilience.breaker.state

    ref, port = both(scenario)
    assert ref == port == (("UnavailableError", 14), (0, 1.0, 1), "closed")


def test_oracle_fallback_matches_device_responses(small_servers):
    """Under a device outage check_many answers every field as the
    device path does, on both packages: two batches fail their retry
    (device_error) and open the breaker (breaker_failures=2), a third
    goes straight to the oracle (breaker_open)."""
    dicts = _dicts(16, seed=5) + _deny_dicts()

    def scenario(p):
        srv = small_servers[p.name]
        bags = [p.bag(d) for d in dicts]
        want = srv.check_many(bags)
        c0 = counters(p)
        p.CHAOS.device_failures = 10**9
        try:
            got = srv.check_many(bags)
            got2 = srv.check_many(bags)   # opens the breaker
            opened = srv.resilience.breaker.state
            got3 = srv.check_many(bags)
        finally:
            p.CHAOS.reset()
        d = delta(counters(p), c0)
        time.sleep(0.25)
        srv.check_many(bags[:1])          # the probe closes it
        return ([fields(r) for r in want],
                [[fields(r) for r in x] for x in (got, got2, got3)],
                d["fallback"], d["device_retries_total"], opened,
                srv.resilience.breaker.state,
                sorted({r.status_code for r in want}))

    ref, port = both(scenario)
    assert ref == port
    want, degraded, fb, retries, opened, state, codes = port
    assert degraded == [want] * 3 and 7 in codes
    n = len(dicts)
    assert fb == {"breaker_open": n, "device_error": 2 * n, "fail_open": 0}
    assert retries == 2 and (opened, state) == ("open", "closed")


# ---------------------------------------------------------------------
# scripts/chaos_smoke.py's checks (its /metrics and /debug scrape needs
# the introspect server, which is not ported)
# ---------------------------------------------------------------------

CHAOS_ARGS = dict(batch_window_s=0.0005, max_batch=16, buckets=(8, 16),
                  check_queue_cap=32, breaker_failures=2,
                  breaker_reset_s=0.2)


@pytest.fixture(scope="module")
def chaos_servers():
    pair = _server_pair(24, **CHAOS_ARGS)
    yield pair
    _close_pair(pair)


def test_chaos_device_outage_parity_and_recovery(chaos_servers):
    dicts = _dicts(40) + _deny_dicts()

    def scenario(p):
        srv = chaos_servers[p.name]
        bags = [p.bag(d) for d in dicts]
        clean = [srv.check(b).status_code for b in bags]
        c0 = counters(p)
        p.CHAOS.device_failures = 10**9
        degraded = [srv.check(b).status_code for b in bags]
        state = srv.resilience.breaker.state
        fb = delta(counters(p), c0)["fallback_total"]
        p.CHAOS.reset()
        time.sleep(0.25)
        recovered = srv.check(bags[0]).status_code
        return (clean, degraded == clean, state, fb >= len(bags),
                recovered == clean[0], srv.resilience.breaker.state)

    ref, port = both(scenario)
    assert ref == port
    assert any(port[0])                  # the sample carries denials
    assert port[1:] == (True, "open", True, True, "closed")


def test_chaos_queue_saturation_sheds(chaos_servers):
    dicts = _dicts(40)

    def scenario(p):
        srv = chaos_servers[p.name]
        bags = [p.bag(d) for d in dicts]
        srv.check(bags[0])
        p.CHAOS.device_latency_s = 0.05
        c0 = counters(p)
        futs = [srv.batcher.submit(bags[i % len(bags)]) for i in range(200)]
        depth = srv.batcher.stats()["depth"]
        n_shed = n_ok = 0
        other = []
        for f in futs:
            try:
                f.result(timeout=30)
                n_ok += 1
            except p.res.ResourceExhaustedError:
                n_shed += 1
            except Exception as exc:   # noqa: BLE001
                other.append(type(exc).__name__)
        p.CHAOS.reset()
        d = delta(counters(p), c0)
        return (depth <= 32, n_shed > 0, n_ok > 0, other,
                d["shed"]["queue_full"] == n_shed)

    ref, port = both(scenario)
    assert ref == port == (True, True, True, [], True)


def test_chaos_expired_deadlines_rejected_pre_tensorize(chaos_servers):
    dicts = _dicts(5)

    def scenario(p):
        srv = chaos_servers[p.name]
        tz0, c0 = p.tensorized(), counters(p)
        outs = [outcome(lambda b=p.bag(d): srv.check(
            b, deadline=time.perf_counter() - 1.0))[:2] for d in dicts]
        return (outs, delta(counters(p), c0)["expired_total"],
                p.tensorized() - tz0)

    ref, port = both(scenario)
    assert ref == port == ([("DeadlineExceededError", 4)] * 5, 5, 0)


# ---------------------------------------------------------------------
# the continuous-batching lane
# ---------------------------------------------------------------------

def test_continuous_lane_dispatches_without_a_window():
    """With a 10 s window the occupancy-fill policy would hold a lone
    request; the continuous lane dispatches it at once, and never holds
    past a row's deadline while every slot is busy."""
    def scenario(p):
        release = threading.Event()
        seen: list = []

        def run_batch(bags):
            seen.append(list(bags))
            if bags[0] == "slow":
                release.wait(timeout=30)
            return ["ok"] * len(bags)

        # depth 1 of a pipeline of 2: one trip in flight fills the lane
        b = p.batcher.CheckBatcher(run_batch, window_s=10.0, max_batch=8,
                                   pipeline=2, buckets=(8,),
                                   pad_batches=False, continuous=True,
                                   continuous_depth=1)
        try:
            t0 = time.perf_counter()
            fast = b.submit("lone").result(timeout=5)
            lone_s = time.perf_counter() - t0
            slow = b.submit("slow")       # occupies the lane's slot
            time.sleep(0.02)
            t1 = time.perf_counter()
            held = b.submit("held", deadline=t1 + 0.05)
            got = outcome(lambda: held.result(timeout=10))
            waited = time.perf_counter() - t1
            # held while the slot was busy, then dispatched close to its
            # deadline: served, or shed if dispatch lost the race
            ok = got == ("ok", "ok") and any("held" in x for x in seen) \
                or got[:2] == ("DeadlineExceededError", 4)
            release.set()
            return (fast, lone_s < 2.0, ok, 0.03 < waited < 2.0,
                    slow.result(timeout=10), b.stats()["continuous"])
        finally:
            release.set()
            b.close()

    ref, port = both(scenario)
    assert ref == port == ("ok", True, True, True, "ok", True)


def _deny_unavailable(*stores) -> None:
    """Every denier now answers UNAVAILABLE with a short TTL."""
    spec = {"adapter": "denier",
            "params": {"status_code": 14, "valid_duration_s": 1.5}}
    for store in stores:
        store.set(("handler", "istio-system", "denyall"), spec)


def test_continuous_lane_across_a_publish():
    """Concurrent check() callers on a continuous-batching server while
    the config publishes: every response equals the reference's answer
    for the generation it was served under, and no request submitted
    after the publish returned gets the old generation's answer."""
    pair = _server_pair(60, batch_window_s=0.0005, max_batch=16,
                        buckets=(16,), continuous_batching=True,
                        continuous_depth=2)
    stop = threading.Event()
    try:
        hits, _ = workloads.make_hit_requests(60, 8, seed=8)
        dicts = _deny_dicts(8) + hits
        ref, got = pair["ref"], pair["port"]
        gen_a = [fields(r) for r in
                 ref.check_many([ref_bag(d) for d in dicts])]
        results = {"ref": [], "port": []}
        published = {}

        def caller(name, srv, mk, k):
            i = k
            while not stop.is_set():
                d = dicts[i % len(dicts)]
                t = time.perf_counter()
                r = srv.check(mk(d))
                results[name].append((i % len(dicts), t, fields(r)))
                i += 3

        threads = [threading.Thread(target=caller, args=(
            name, pair[name], mk, k)) for name, mk in
            (("ref", ref_bag), ("port", bag_from_mapping)) for k in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        old = {n: pair[n].controller.dispatcher for n in ("ref", "port")}
        _deny_unavailable(*pair["stores"])
        end = time.perf_counter() + 60
        for n in ("ref", "port"):
            while pair[n].controller.dispatcher is old[n]:
                assert time.perf_counter() < end, "publish never landed"
                time.sleep(0.005)
            published[n] = time.perf_counter()
        # serve on until each package answered every bag after its
        # publish returned
        while time.perf_counter() < end and not all(
                {i for i, t, _ in results[n] if t > published[n]}
                == set(range(len(dicts))) for n in ("ref", "port")):
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        gen_b = [fields(r) for r in
                 ref.check_many([ref_bag(d) for d in dicts])]
        changed = {i for i, (a, b) in enumerate(zip(gen_a, gen_b))
                   if a != b}
        assert changed, "the publish changed no answer"
        for name in ("ref", "port"):
            rows = results[name]
            assert rows, name
            after = [(i, r) for i, t, r in rows if t > published[name]]
            assert all(r in (gen_a[i], gen_b[i]) for i, _, r in rows), name
            assert all(r == gen_b[i] for i, r in after), name
            assert {i for i, _ in after} >= changed, name
        assert got.batcher.stats()["continuous"]
    finally:
        stop.set()
        _close_pair(pair)


# ---------------------------------------------------------------------
# quota() and the ServerArgs fields
# ---------------------------------------------------------------------

def test_default_check_deadline_stays_unported():
    """default_check_deadline_ms is carried (the name predates it): a
    quota() call without a deadline of the caller's takes the server's
    default, so a wedged quota lane on the executor answers the host fail
    policy (UNAVAILABLE, granted 0) within that deadline, as the
    reference's does; a call with a deadline of its own keeps it. With
    the executor off (host_executor=False, the inline loop) quota()
    answers alike on both packages, with or without a deadline."""
    def wedged(p_name, srv, mk):
        CHAOS = ref_resilience.CHAOS if p_name == "ref" else resilience.CHAOS
        d = _dicts(1)[0]
        # the reference's first one-bag resolve compiles: warm it under a
        # deadline it cannot outlive, before the default one applies
        srv.quota(mk(d), "rq", deadline=time.perf_counter() + 600.0)
        clean = srv.quota(mk(d), "rq")
        CHAOS.wedge_adapter("mq.istio-system")
        try:
            t0 = time.perf_counter()
            r = srv.quota(mk(d), "rq")
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            own = srv.quota(mk(d), "rq", deadline=time.perf_counter() + 0.05)
            own_wall = time.perf_counter() - t0
        finally:
            CHAOS.reset()
        return ((clean.granted_amount, clean.status_code),
                (r.granted_amount, r.status_code, r.status_message),
                wall < 0.25 + 0.35, wall >= 0.25,
                (own.granted_amount, own.status_code), own_wall < 0.25)

    pair = _server_pair(12, default_check_deadline_ms=250.0)
    try:
        seen = {name: wedged(name, pair[name], mk)
                for name, mk in (("ref", ref_bag), ("port", bag_from_mapping))}
        assert seen["ref"] == seen["port"]
        assert seen["port"][1] == (0, 14, "quota adapter unavailable "
                                          "(overrun)")
        assert seen["port"][2:4] == (True, True)
        assert seen["port"][4] == (0, 14) and seen["port"][5]
    finally:
        _close_pair(pair)
    pair = _server_pair(12, host_executor=False)
    try:
        d = _dicts(1)[0]
        seen = {}
        for name, mk in (("ref", ref_bag), ("port", bag_from_mapping)):
            srv = pair[name]
            seen[name] = [
                (r.granted_amount, r.status_code) for r in (
                    srv.quota(mk(d), "rq"),
                    srv.quota(mk(d), "rq",
                              deadline=time.perf_counter() + 5.0))]
        assert seen["ref"] == seen["port"]
    finally:
        _close_pair(pair)


def test_resilience_fields_are_carried():
    store = workloads.make_store(8)
    try:
        args = ServerArgs(brownout=True,
                          check_fail_policy="open", breaker_failures=4,
                          breaker_reset_s=0.1, device_retry=False,
                          continuous_batching=True, continuous_depth=3,
                          initial_prewarm=False)
        srv = RuntimeServer(store, args, device="cpu")
        try:
            cfg = srv.resilience.config
            assert (cfg.fail_policy, cfg.breaker_failures,
                    cfg.breaker_reset_s, cfg.retry) == ("open", 4, 0.1,
                                                        False)
            # the reference's full chain for a CPU server; a card
            # server's checker is strict (chip_smoke phase 14 (j))
            assert srv.resilience.strict_device is False
            st = srv.batcher.stats()
            assert (st["brownout"], st["continuous"],
                    st["continuous_depth"]) == (True, True, 3)
            # the report coalescer gets none of the check lane's policy
            rb = srv._report_batcher.stats()
            assert (rb["brownout"], rb["continuous"]) == (False, False)
        finally:
            srv.close()
        with pytest.raises(ValueError, match="check_fail_policy"):
            RuntimeServer(store, ServerArgs(check_fail_policy="maybe"),
                          device="cpu")
    finally:
        store.close()
