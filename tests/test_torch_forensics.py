"""The port's tail-latency forensics plane (istio_tpu_torch/runtime/
forensics.py) on the CPU, and against the JAX package's.

  * The unit cases of tests/test_forensics.py, run on the port: the
    threshold gate, the ring bound and its typed drops, stage and
    host-wait attribution on the tape, the disabled recorder, the
    wire-decode pre-mark, event overlap with its pre-window, coalescing
    and its identity rule, the adaptive floor, thread stacks and the
    profile capture (a torch.profiler Chrome trace here; fail-soft when
    another profiler window is open, busy under a concurrent capture).
  * Parity: one scripted tape, e2e and event sequence (values from a
    numpy seed, coalesce windows wide enough to be deterministic) through
    both packages' FlightRecorder / EventTimeline must give equal
    exemplars and events, wall and perf_counter stamps excluded. Exact.
  * A served pair: the reference's RuntimeServer and the port's CPU
    server over the same store (shards=2), both recorders at a near-zero
    threshold and grants on, give equal sets of exemplar stage names and
    sources and of event kinds (config_publish, prewarm, bank_rebuild,
    grant_revoke, quiesce, shutdown),
    and the port's responses equal a recorder-off run's and the
    reference's.
  * A wedged adapter on the overlay world: on both packages an exemplar
    whose top stage is host:<handler>, with a chaos_wedge or breaker
    event beside it.

Each test restores both packages' RECORDER / EVENTS singletons and CHAOS
seams (process-wide; --dist loadfile shares workers).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime import forensics as ref_forensics
from istio_tpu.runtime import grants as ref_grants
from istio_tpu.runtime import monitor as ref_monitor
from istio_tpu.runtime import resilience as ref_resilience
from istio_tpu.runtime.store import Event as RefEvent
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.runtime import forensics, grants, monitor, resilience
from istio_tpu_torch.runtime.store import Event
from istio_tpu_torch.testing import workloads

REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)
FIELDS = ("status_code", "status_message", "valid_duration_s",
          "valid_use_count", "referenced", "referenced_presence",
          "deny_rule", "active_quota_rules")
CI = "cilist.istio-system"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _restore(fx) -> None:
    fx.RECORDER.configure(enabled=True, threshold_ms=0.0, adaptive=False,
                          capacity=256)
    fx.RECORDER.reset()
    fx.EVENTS.configure(capacity=512)
    fx.EVENTS.reset()


@pytest.fixture(autouse=True)
def _isolated():
    """Both packages' singletons at their defaults and CHAOS disarmed,
    before and after every test."""
    for fx, res in ((ref_forensics, ref_resilience),
                    (forensics, resilience)):
        _restore(fx)
        res.CHAOS.reset()
    try:
        yield
    finally:
        for fx, res in ((ref_forensics, ref_resilience),
                        (forensics, resilience)):
            res.CHAOS.reset()
            _restore(fx)


@contextlib.contextmanager
def _recorder(threshold_ms=100.0, capacity=8, adaptive=False):
    rec = forensics.RECORDER
    rec.configure(enabled=True, threshold_ms=threshold_ms,
                  adaptive=adaptive, capacity=capacity)
    rec.reset()
    yield rec


def _capture_one(rec, e2e_s=0.5, stages=(("device_step", 0.3),)):
    rec.batch_begin()
    for stage, s in stages:
        rec.stage_mark(stage, s)
    rec.note_batch(e2e_s, 4, {"traceId": "t1"})


# ---------------------------------------------------------------------
# the unit cases of tests/test_forensics.py, on the port
# ---------------------------------------------------------------------

def test_threshold_gates_capture():
    with _recorder(threshold_ms=100.0) as rec:
        base = monitor.forensics_counters()["slow_captured"]
        _capture_one(rec, e2e_s=0.05)      # under: silent
        assert rec.snapshot()["retained"] == 0
        _capture_one(rec, e2e_s=0.5)       # over: one exemplar
        snap = rec.snapshot()
        assert snap["retained"] == 1
        assert monitor.forensics_counters()["slow_captured"] == base + 1
        ex = snap["slowest"][0]
        assert ex["e2e_ms"] == 500.0
        assert ex["trace_id"] == "t1"
        assert ex["traces_link"] == "/debug/traces?trace=t1"


def test_ring_bound_and_typed_drops():
    with _recorder(threshold_ms=1.0, capacity=4) as rec:
        base = monitor.forensics_counters()["dropped"]["slow"]
        for i in range(6):
            _capture_one(rec, e2e_s=0.01 * (i + 1))
        snap = rec.snapshot(top_k=16)
        assert snap["retained"] == 4
        assert monitor.forensics_counters()["dropped"]["slow"] == base + 2
        # top-K is slowest-first over the retained (recent) window
        e2es = [e["e2e_ms"] for e in snap["slowest"]]
        assert e2es == sorted(e2es, reverse=True)


def test_dropped_family_is_zero_shaped():
    assert set(monitor.FORENSICS_DROPPED.series()) >= {"slow", "events"}
    assert set(monitor.forensics_counters()["dropped"]) == \
        {"slow", "events"}


def test_tape_attributes_stages_and_host_waits():
    with _recorder(threshold_ms=100.0) as rec:
        rec.batch_begin()
        rec.stage_mark("queue_wait", 0.05)
        rec.stage_mark("device_step", 0.1)
        rec.host_wait("mq.istio-system", 0.4)
        rec.note_batch(0.6, 2, None)
        ex = rec.snapshot()["slowest"][0]
        assert ex["stages_ms"]["host:mq.istio-system"] == 400.0
        assert ex["top_stage"] == "host:mq.istio-system"
        assert ex["stages_ms"]["device_step"] == 100.0


def test_respond_nets_out_host_waits_and_grant():
    """Host claims and the grant fold run inside the respond window:
    the respond stage is netted, so the stage sum stays <= e2e."""
    with _recorder(threshold_ms=1.0) as rec:
        rec.batch_begin()
        rec.stage_mark("device_step", 0.01)
        rec.host_wait(CI, 0.2)
        rec.stage_mark("grant", 0.03)
        rec.stage_mark("respond", 0.25)
        rec.note_batch(0.27, 1, None)
        ex = rec.snapshot()["slowest"][0]
        assert ex["stages_ms"]["respond"] == 20.0
        assert sum(ex["stages_ms"].values()) <= ex["e2e_ms"]


def test_stage_tap_feeds_the_open_tape_only():
    """monitor.observe_stage lands on this thread's open tape (the tap
    registered at import), and nowhere off-batch."""
    with _recorder(threshold_ms=1.0) as rec:
        monitor.observe_stage("tensorize", 0.5)     # off-batch: dropped
        rec.batch_begin()
        monitor.observe_stage("device_step", 0.02)
        rec.note_direct(0.03, 3)
        ex = rec.snapshot()["slowest"][0]
        assert ex["stages_ms"] == {"device_step": 20.0}
        assert ex["source"] == "prebatched" and ex["rows"] == 3


def test_tape_is_thread_local():
    with _recorder(threshold_ms=1.0) as rec:
        rec.batch_begin()
        t = threading.Thread(
            target=lambda: monitor.observe_stage("device_step", 9.0))
        t.start()
        t.join()
        monitor.observe_stage("fold", 0.01)
        rec.note_batch(0.02, 1, None)
        assert rec.snapshot()["slowest"][0]["stages_ms"] == {"fold": 10.0}


def test_disabled_recorder_is_silent_and_clears_tape():
    with _recorder(threshold_ms=1.0) as rec:
        rec.batch_begin()
        rec.stage_mark("device_step", 0.2)
        rec.configure(enabled=False)
        rec.batch_begin()              # disabled: clears the tape
        rec.stage_mark("device_step", 9.9)
        rec.note_batch(9.9, 1, None)
        assert rec.snapshot()["retained"] == 0
        rec.configure(enabled=True)


def test_wire_decode_premark_joins_next_batch():
    with _recorder(threshold_ms=10.0) as rec:
        rec.note_wire_decode(0.025)
        rec.batch_begin()
        rec.stage_mark("device_step", 0.05)
        rec.note_batch(0.2, 1, None)
        ex = rec.snapshot()["slowest"][0]
        assert ex["stages_ms"]["wire_decode"] == 25.0


def test_premarks_are_bounded_and_clearable():
    with _recorder(threshold_ms=1.0) as rec:
        for _ in range(6):
            rec.note_wire_decode(0.001)
        rec.batch_begin()
        rec.note_batch(0.01, 1, None)
        assert rec.snapshot()["slowest"][0]["stages_ms"] == \
            {"wire_decode": 4.0}
        rec.reset()
        rec.note_wire_decode(0.5)
        rec.clear_premarks()
        rec.batch_begin()
        rec.stage_mark("fold", 0.002)
        rec.note_batch(0.01, 1, None)
        assert rec.snapshot()["slowest"][0]["stages_ms"] == {"fold": 2.0}


def test_event_overlap_and_pre_window():
    ring = forensics.EventTimeline(capacity=32)
    t0 = time.perf_counter()
    ring.record("config_publish", generation=7)
    # an event 0.5 s in the past of a request that starts now still
    # annotates it (the pre-window); one 5 s back does not
    with ring._lock:
        ring._buf[0]["t"] = t0 - 0.5
    ring.record("breaker", name="device", to="open")
    with ring._lock:
        ring._buf[1]["t"] = t0 - 5.0
    got = ring.overlapping(t0, t0 + 0.01, pre_s=1.0)
    assert [e["kind"] for e in got] == ["config_publish"]


def test_event_coalescing_and_drop_counter():
    base = monitor.forensics_counters()["dropped"]["events"]
    ring = forensics.EventTimeline(capacity=8)
    for _ in range(5):
        ring.record("quota_flush", coalesce_s=10.0, items=3)
    assert len(ring) == 1
    ev = ring.snapshot()[0]
    assert ev["n"] == 5
    assert ev["detail"]["items"] == 15   # numeric fields accumulate
    for i in range(10):
        ring.record(f"kind{i}")
    assert len(ring) == 8
    # 1 coalesced + 10 distinct into capacity 8
    assert monitor.forensics_counters()["dropped"]["events"] == base + 3


def test_event_coalescing_never_masks_identity():
    ring = forensics.EventTimeline(capacity=8)
    ring.record("provider_refresh", coalesce_s=10.0, provider="a", ok=True)
    ring.record("provider_refresh", coalesce_s=10.0, provider="a", ok=False)
    ring.record("provider_refresh", coalesce_s=10.0, provider="b", ok=False)
    ring.record("provider_refresh", coalesce_s=10.0, provider="b", ok=False)
    evs = ring.snapshot()
    assert [(e["detail"]["provider"], e["detail"]["ok"], e["n"])
            for e in evs] == \
        [("a", True, 1), ("a", False, 1), ("b", False, 2)]


def test_event_ring_loses_no_record_under_threads():
    """Eight threads recording into one ring (coalescing on, a short
    switch interval): every record lands once, as an entry or in a
    coalesced entry's n and summed detail, and the counter sees each."""
    import sys
    ring = forensics.EventTimeline(capacity=10_000)
    base = monitor.forensics_counters()["events_recorded"]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(k):
            for i in range(500):
                ring.record("quota_flush", coalesce_s=1e6, items=1)
                ring.record(f"kind{k}", n_=i)
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    evs = ring.snapshot(limit=0)
    flushes = [e for e in evs if e["kind"] == "quota_flush"]
    assert sum(e["n"] for e in flushes) == 4000
    assert sum(e["detail"]["items"] for e in flushes) == 4000
    assert len(evs) - len(flushes) == 4000
    assert monitor.forensics_counters()["events_recorded"] - base == 8000


def test_snapshot_kind_filter_keeps_old_publish_findable():
    ring = forensics.EventTimeline(capacity=64)
    ring.record("config_publish", generation=1)
    for i in range(20):
        ring.record("quota_flush", items=i)
    assert [e["detail"] for e in ring.snapshot("config_publish", 1)] == \
        [{"generation": 1}]
    assert len(ring.snapshot(limit=5)) == 5


def test_record_event_never_raises(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("ring broke")
    monkeypatch.setattr(forensics.EVENTS, "record", boom)
    forensics.record_event("breaker", name="device", to="open")


def test_adaptive_threshold_never_below_base():
    with _recorder(threshold_ms=50.0, adaptive=True) as rec:
        assert rec.threshold_s() >= 0.05


def test_thread_stacks_names_this_thread():
    dump = forensics.thread_stacks()
    assert dump["n_threads"] >= 1
    names = {t["name"] for t in dump["threads"]}
    assert threading.current_thread().name in names
    assert all(t["stack"] for t in dump["threads"])


def test_capture_profile_artifact_busy_and_fail_soft(tmp_path):
    """A capture writes a Chrome trace and records a profile_capture
    event; a second capture while one runs raises ProfileBusy; a capture
    asked for inside another profiler window fails soft and leaves that
    window's session running."""
    out = forensics.capture_profile(str(tmp_path / "a"), 0.1)
    assert out["available"], out
    assert out["n_files"] >= 1 and out["bytes_total"] > 0
    with open(tmp_path / "a" / forensics.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)
    assert forensics.EVENTS.snapshot("profile_capture")[-1]["detail"] == \
        {"seconds": 0.1, "files": out["n_files"]}
    # the clamp: 0.1 s at least
    forensics._PROFILE_LOCK.acquire()
    try:
        with pytest.raises(forensics.ProfileBusy):
            forensics.capture_profile(str(tmp_path / "b"), 0.1)
    finally:
        forensics._PROFILE_LOCK.release()
    assert not (tmp_path / "b").exists()
    with torch.profiler.profile() as prof:
        torch.ones(4).sum()
        inner = forensics.capture_profile(str(tmp_path / "c"), 0.1)
        assert torch._C._autograd._profiler_enabled()
        torch.ones(4).sum()
    assert inner["available"] is False and "error" in inner
    assert not (tmp_path / "c").exists()
    assert any(e.name == "aten::sum" for e in prof.events())


def test_server_args_carry_the_forensics_fields(tmp_path):
    store = workloads.make_store(8)
    srv = RuntimeServer(store, ServerArgs(
        initial_prewarm=False, rulestats_drain_s=0,
        flight_recorder=False, slow_threshold_ms=25.0, slow_adaptive=True,
        slow_ring_capacity=17, event_ring_capacity=33,
        profile_dir=str(tmp_path)), device="cpu")
    try:
        snap = forensics.RECORDER.snapshot()
        assert (snap["enabled"], snap["threshold_configured_ms"],
                snap["adaptive"], snap["capacity"]) == \
            (False, 25.0, True, 17)
        assert forensics.EVENTS._buf.maxlen == 33
        out = srv.capture_profile(0.1)
        assert out["available"] and out["dir"] == str(tmp_path)
    finally:
        srv.close()
        store.close()


@pytest.mark.parametrize("field,value", [
    ("mtls", "strict"),
    ("mtls_identity", "spiffe://x"), ("mtls_cert_ttl_minutes", 5),
    ("mtls_rotation_fraction", 0.9), ("overlap_h2d", True),
    ("jax_compile_cache_dir", "cache")])
def test_other_unported_fields_still_raise(field, value):
    from istio_tpu_torch.device import NotPorted
    store = workloads.make_store(8)
    try:
        with pytest.raises(NotPorted, match=field):
            RuntimeServer(store, ServerArgs(**{field: value}), device="cpu")
    finally:
        store.close()


# ---------------------------------------------------------------------
# parity with the JAX package on one scripted sequence
# ---------------------------------------------------------------------

STAGES = ("queue_wait", "tensorize", "h2d", "device_step", "fold",
          "respond", "grant", "host:cilist.istio-system",
          "host:mq.istio-system", "wire_decode")


def _script(seed: int) -> list[tuple]:
    """A seeded list of steps: ("event", kind, coalesce_s, detail),
    ("batch", premarks, tape, e2e_s, rows, trace, direct) and
    ("configure", kwargs)."""
    rng = np.random.default_rng(seed)
    out: list[tuple] = [("configure", dict(threshold_ms=40.0,
                                           capacity=6))]
    for i in range(40):
        r = rng.random()
        if r < 0.45:
            kind = str(rng.choice(["config_publish", "prewarm", "breaker",
                                   "quota_flush", "provider_refresh",
                                   "grant_revoke", "bank_rebuild"]))
            if kind == "quota_flush":
                detail = {"items": int(rng.integers(1, 50))}
                co = 1e6          # wide: every flush coalesces
            elif kind == "provider_refresh":
                detail = {"provider": str(rng.choice(["a", "b"])),
                          "ok": bool(rng.random() < 0.7)}
                co = 1e6
            elif kind == "prewarm":
                detail = {"shape": f"{int(rng.choice([8, 16]))}x32",
                          "phase": str(rng.choice(["start", "end"])),
                          "wall_ms": round(float(rng.random()) * 9, 1)}
                co = 0.0
            else:
                detail = {"generation": int(rng.integers(1, 9)),
                          "name": "device", "to": "open"}
                co = 0.0
            out.append(("event", kind, co, detail))
        elif r < 0.95:
            n = int(rng.integers(0, 7))
            tape = [(str(rng.choice(STAGES[:-1])),
                     round(float(rng.random()) * 0.05, 6))
                    for _ in range(n)]
            pre = [round(float(rng.random()) * 0.01, 6)
                   for _ in range(int(rng.integers(0, 3)))]
            e2e = round(sum(s for _, s in tape) + sum(pre)
                        + float(rng.random()) * 0.05, 6)
            trace = {"traceId": f"t{i}"} if rng.random() < 0.5 else None
            out.append(("batch", pre, tape, e2e, int(rng.integers(1, 64)),
                        trace, bool(rng.random() < 0.3)))
        else:
            out.append(("configure", dict(
                threshold_ms=float(rng.choice([0.0, 5.0, 40.0])))))
    return out


def _drive(fx, mon, script) -> dict:
    """Run `script` through one package: a fresh FlightRecorder and a
    fresh EventTimeline swapped in for the module's EVENTS (what
    _capture annotates from)."""
    rec = fx.FlightRecorder()
    saved = fx.EVENTS
    fx.EVENTS = fx.EventTimeline(capacity=16)
    base = mon.forensics_counters()
    try:
        for step in script:
            if step[0] == "configure":
                rec.configure(**step[1])
            elif step[0] == "event":
                _, kind, co, detail = step
                fx.EVENTS.record(kind, coalesce_s=co, **dict(detail))
            else:
                _, pre, tape, e2e, rows, trace, direct = step
                for s in pre:
                    rec.note_wire_decode(s)
                rec.batch_begin()
                for stage, s in tape:
                    if stage.startswith("host:"):
                        rec.host_wait(stage[5:], s)
                    else:
                        rec.stage_mark(stage, s)
                if direct:
                    rec.note_direct(e2e, rows)
                else:
                    rec.note_batch(e2e, rows, trace)
        snap = rec.snapshot(top_k=64)
        events = fx.EVENTS.snapshot(limit=0)
    finally:
        fx.EVENTS = saved
    after = mon.forensics_counters()

    def strip(e):
        return {k: v for k, v in e.items() if k not in ("wall", "t")}
    snap.pop("counters")
    for ex in snap["slowest"]:
        ex.pop("wall")
        ex["events"] = [strip(e) for e in ex["events"]]
    return {"snapshot": snap, "events": [strip(e) for e in events],
            "slow": after["slow_captured"] - base["slow_captured"],
            "dropped": {r: after["dropped"][r] - base["dropped"][r]
                        for r in ("slow", "events")}}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_scripted_sequence_matches_reference(seed):
    """Exemplars (stages_ms, top_stage, rows, source, e2e, threshold,
    trace, overlapping events with n and numeric detail), the event ring
    and the slow / dropped counter deltas are equal between packages."""
    script = _script(seed)
    want = _drive(ref_forensics, ref_monitor, script)
    got = _drive(forensics, monitor, script)
    assert got == want
    assert got["slow"] > 0 and got["snapshot"]["retained"] > 0
    kinds = {e["kind"] for ex in got["snapshot"]["slowest"]
             for e in ex["events"]}
    assert kinds                      # exemplars were annotated


# ---------------------------------------------------------------------
# a served pair
# ---------------------------------------------------------------------

PAIR_ARGS = dict(shards=2, buckets=(8,), max_batch=8,
                 batch_window_s=0.0005, slow_threshold_ms=0.001,
                 check_grants=True)


def _exemplar_view(fx) -> tuple[set, set]:
    """(stage names, sources) over the retained exemplars. Which events
    annotate an exemplar depends on walls (the one-second pre-window), so
    the annotation sets are not compared between packages."""
    slow = fx.RECORDER.snapshot(top_k=256)["slowest"]
    return ({s for ex in slow for s in ex["stages_ms"]},
            {ex["source"] for ex in slow})


def _details(events) -> dict:
    """kind → the detail dicts of its events in ring order, less the
    fields that are walls."""
    out: dict = {}
    for e in events:
        out.setdefault(e["kind"], []).append(
            {k: v for k, v in e["detail"].items() if k != "wall_ms"})
    return out


def _serve(srv, bag_of, dicts) -> list:
    out = srv.check_many([bag_of(d) for d in dicts])
    out += [srv.check(bag_of(d)) for d in dicts[:3]]
    return out


def _republish(store, event_cls, rev: int) -> None:
    store.apply_events([event_cls(
        ("rule", "istio-system", f"late{rev}"),
        {"match": 'request.method == "PATCH"',
         "actions": [{"handler": "denyall", "instances": ["nothing"]}]})],
        notify=False)


def test_served_pair_records_the_same_stages_and_events(monkeypatch):
    # one frozen clock for both packages' grant policies: a grant's TTL
    # follows the wall since a publish
    frozen = types.SimpleNamespace(monotonic=lambda: 1000.0)
    monkeypatch.setattr(ref_grants, "time", frozen)
    monkeypatch.setattr(grants, "time", frozen)
    ref_store = ref_workloads.make_store(40)
    pt_store = interop.store_from_reference(ref_store)
    dicts = workloads.make_request_dicts(8, seed=5)
    ref = RefServer(ref_store, RefArgs(**REF_ARGS, **PAIR_ARGS))
    try:
        want = _serve(ref, ref_bag, dicts)
        _republish(ref_store, RefEvent, 2)
        ref.controller.rebuild()
        want2 = _serve(ref, ref_bag, dicts)
    finally:
        ref.close()
    got_srv = RuntimeServer(pt_store, ServerArgs(
        rulestats_drain_s=0, initial_prewarm=False, **PAIR_ARGS),
        device="cpu")
    try:
        got = _serve(got_srv, bag_from_mapping, dicts)
        _republish(pt_store, Event, 2)
        got_srv.controller.rebuild()
        got2 = _serve(got_srv, bag_from_mapping, dicts)
    finally:
        got_srv.close()
    ref_view, got_view = _exemplar_view(ref_forensics), \
        _exemplar_view(forensics)
    assert got_view == ref_view
    stages, sources = got_view
    # the republish's events annotate the exemplars served right after it
    assert {e["kind"] for ex in forensics.RECORDER.snapshot(
        top_k=256)["slowest"] for e in ex["events"]} & \
        {"config_publish", "prewarm", "bank_rebuild"}
    assert {"queue_wait", "tensorize", "h2d", "device_step", "fold",
            "grant", "respond"} <= stages
    assert sources == {"prebatched", "batcher"}
    ref_events = ref_forensics.EVENTS.snapshot(limit=0)
    ref_kinds = {e["kind"] for e in ref_events}
    got_events = forensics.EVENTS.snapshot(limit=0)
    assert {e["kind"] for e in got_events} == ref_kinds
    # each kind's details, its walls left out, in the order recorded
    assert _details(got_events) == _details(ref_events)
    assert {"config_publish", "prewarm", "bank_rebuild", "grant_revoke",
            "quiesce", "shutdown"} <= ref_kinds
    pubs = [e["detail"] for e in got_events if e["kind"] == "config_publish"]
    assert [p["generation"] for p in pubs] == [1, 2]
    assert [e["detail"]["recompiled"] for e in got_events
            if e["kind"] == "bank_rebuild"][0] == 2
    for a, b in zip(want + want2, got + got2):
        for f in FIELDS:
            assert getattr(b, f) == getattr(a, f), f
    # the same traffic with the recorder off: equal responses, no capture
    off_store = interop.store_from_reference(ref_workloads.make_store(40))
    off = RuntimeServer(off_store, ServerArgs(
        rulestats_drain_s=0, initial_prewarm=False, flight_recorder=False,
        **PAIR_ARGS), device="cpu")
    try:
        forensics.RECORDER.reset()
        quiet = _serve(off, bag_from_mapping, dicts)
        assert forensics.RECORDER.snapshot()["retained"] == 0
    finally:
        off.close()
        off_store.close()
    for a, b in zip(got, quiet):
        for f in FIELDS:
            assert getattr(b, f) == getattr(a, f), f
    ref_store.close()
    pt_store.close()


# ---------------------------------------------------------------------
# a wedged adapter on the overlay world
# ---------------------------------------------------------------------

def _wedged(Server, Args, extra, kw, CHAOS, wl, bag_of, fx) -> dict:
    store = wl.make_store(60, host_overlay_every=5)
    srv = Server(store, Args(
        batch_window_s=0.0005, max_batch=16, buckets=(8, 16),
        default_manifest=wl.MESH_MANIFEST, initial_prewarm=False,
        rulestats_drain_s=0, host_breaker_failures=2,
        host_breaker_reset_s=0.3, slow_threshold_ms=150.0, **extra), **kw)
    try:
        srv.controller.dispatcher.fused.prewarm((8, 16))
        ci_bag = bag_of({
            "destination.service": "svc2.ns2.svc.cluster.local",
            "source.namespace": "ns2", "request.method": "GET",
            "request.path": "/api/v2/items"})
        srv.check(ci_bag)                   # warm, far deadline
        fx.RECORDER.reset()
        CHAOS.wedge_adapter(CI)
        statuses = [srv.check(ci_bag, deadline=time.perf_counter() + 0.3
                              ).status_code for _ in range(3)]
        CHAOS.unwedge_adapter(CI)
    finally:
        CHAOS.reset()
        srv.close()
        store.close()
    slow = fx.RECORDER.snapshot(top_k=64)["slowest"]
    hosts = [ex for ex in slow if ex["top_stage"] == "host:" + CI]
    return {"statuses": statuses, "hosts": len(hosts) > 0,
            "kinds": sorted({e["kind"] for ex in hosts
                             for e in ex["events"]}
                            & {"chaos_wedge", "breaker"}),
            "sums_ok": all(sum(ex["stages_ms"].values())
                           <= ex["e2e_ms"] + 1e-3 for ex in hosts),
            "over": all(ex["e2e_ms"] >= 150.0 for ex in hosts)}


def test_wedged_adapter_is_attributed_on_both_packages():
    want = _wedged(RefServer, RefArgs, dict(audit=False), {},
                   ref_resilience.CHAOS, ref_workloads, ref_bag,
                   ref_forensics)
    got = _wedged(RuntimeServer, ServerArgs, {}, dict(device="cpu"),
                  resilience.CHAOS, workloads, bag_from_mapping, forensics)
    assert got == want
    assert got["hosts"] and got["sums_ok"] and got["over"]
    assert got["kinds"]                 # chaos_wedge and / or breaker
    kinds = {e["kind"] for e in forensics.EVENTS.snapshot(limit=0)}
    assert {"chaos_wedge", "chaos_unwedge", "breaker"} <= kinds


def test_process_singletons_are_the_tap_targets():
    """The stage tap registered at import feeds the port's RECORDER, and
    nothing of the JAX package's."""
    assert monitor._STAGE_TAP == forensics.RECORDER.stage_mark
    assert os.path.basename(forensics.__file__) == "forensics.py"


# ---------------------------------------------------------------------
# the control-plane hooks, each on both packages
# ---------------------------------------------------------------------

def _hook_grants(pkg) -> None:
    g = pkg["grants"].GrantPolicy()
    g.on_publish(None)
    g.on_publish(["ns1", "ns2"])


def _hook_breaker(pkg) -> None:
    b = pkg["resilience"].CircuitBreaker(failures=2, reset_s=0.0,
                                         publish=False, name="handler:h")
    b.record_failure()
    b.record_failure()               # closed -> open
    b.allow_device()                 # reset_s 0: open -> half_open
    b.record_success()               # half_open -> closed


def _hook_chaos(pkg) -> None:
    chaos = pkg["resilience"].CHAOS
    chaos.wedge_adapter("h.ns")
    chaos.unwedge_adapter("h.ns")
    chaos.unwedge_adapter("never-wedged")   # records nothing


def _hook_quiesce(pkg) -> None:
    for observe in (True, False):
        b = pkg["batcher"].CheckBatcher(lambda bags: [None] * len(bags),
                                        observe_latency=observe)
        try:
            b.quiesce()
        finally:
            b.close()


class _Provider:
    refresh_interval_s = 3600.0

    def __init__(self):
        self.calls = 0

    def refresh(self):
        self.calls += 1
        if self.calls == 2:
            raise RuntimeError("provider down")


def _hook_provider_refresh(pkg) -> None:
    ex = pkg["executor"].AdapterExecutor(pkg["executor"].ExecutorConfig())
    try:
        for name in ("a", "b"):
            ex.register_refreshable(name, _Provider())
        for name in ("a", "a", "a", "b"):
            ex.refresh_now(name)
    finally:
        ex.close()


def _hook_canary_veto(pkg) -> None:
    corpus = pkg["corpus"]
    pair = corpus.make_canary_snapshot_pairs(20)[0]
    store = pkg["MemStore"]()
    store.apply_events([pkg["Event"](k, dict(v)) for k, v in pair.base_docs],
                       notify=False)
    srv = pkg["Server"](store, pkg["Args"](
        batch_window_s=0.0005, max_batch=32, buckets=(16, 32),
        canary="gate", rulestats_drain_s=0,
        default_manifest=corpus.ANALYZER_MANIFEST, **pkg["extra"]),
        **pkg["kw"])
    try:
        bags = [pkg["bag"](d) for d in corpus.make_canary_traffic(pair, 20)]
        for lo in range(0, len(bags), 32):
            chunk = bags[lo:lo + 32]
            pkg["serve"](srv, pkg["pad"](chunk, (16, 32)))
        old = {k for k, _ in pair.base_docs}
        new = {k for k, _ in pair.divergent_docs}
        store.apply_events(
            [pkg["Event"](k, None) for k in old - new]
            + [pkg["Event"](k, dict(v)) for k, v in pair.divergent_docs],
            notify=False)
        srv.controller.rebuild()
        assert srv.controller.last_canary_rejection is not None
    finally:
        srv.close()
        store.close()


def _ref_pkg() -> dict:
    from istio_tpu.runtime import MemStore as RefMemStore
    from istio_tpu.runtime import batcher as ref_batcher
    from istio_tpu.runtime import executor as ref_executor
    from istio_tpu.testing import corpus as ref_corpus
    return dict(fx=ref_forensics, grants=ref_grants,
                resilience=ref_resilience, batcher=ref_batcher,
                executor=ref_executor, corpus=ref_corpus,
                MemStore=RefMemStore, Event=RefEvent, Server=RefServer,
                Args=RefArgs, extra=dict(initial_prewarm=False, audit=False),
                kw={}, bag=ref_bag, pad=ref_batcher.pad_to_bucket,
                serve=lambda srv, bags: srv.check_batch_preprocessed(bags))


def _port_pkg() -> dict:
    from istio_tpu_torch.runtime import MemStore
    from istio_tpu_torch.runtime import batcher, executor
    from istio_tpu_torch.testing import corpus
    return dict(fx=forensics, grants=grants, resilience=resilience,
                batcher=batcher, executor=executor, corpus=corpus,
                MemStore=MemStore, Event=Event, Server=RuntimeServer,
                Args=ServerArgs, extra=dict(initial_prewarm=False),
                kw=dict(device="cpu"), bag=bag_from_mapping,
                pad=batcher.pad_to_bucket,
                serve=lambda srv, bags: srv.check_many(bags))


HOOKS = {"grant_revoke": _hook_grants, "breaker": _hook_breaker,
         "chaos_wedge": _hook_chaos, "quiesce": _hook_quiesce,
         "provider_refresh": _hook_provider_refresh,
         "canary_veto": _hook_canary_veto}


@pytest.mark.parametrize("kind", list(HOOKS))
def test_control_plane_hook_records_the_reference_events(kind):
    """Each hook, driven the same way on both packages, records the same
    events: kinds, n and every detail field, in order."""
    out = []
    for pkg in (_ref_pkg(), _port_pkg()):
        pkg["fx"].EVENTS.reset()
        HOOKS[kind](pkg)
        out.append([(e["kind"], e["n"], e["detail"])
                    for e in pkg["fx"].EVENTS.snapshot(limit=0)
                    if e["kind"] not in ("config_publish", "prewarm",
                                         "quiesce", "shutdown")
                    or kind == "quiesce"])
    want, got = out
    assert got == want
    assert any(k == kind for k, _, _ in got), got
