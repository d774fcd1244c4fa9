"""Mesh audit plane: live invariant auditing + fault explainability.

Port of istio_tpu/runtime/audit.py. The plane has no device program:
its one device read is DeviceQuotaPool.audit_view's pull of a quota
pool's counter plane, a copy on the pool's private audit stream after
the event the plane's producing launch recorded (runtime/device_quota.py),
so no serving stream waits on it. The wire fronts that count decoded and
answered Check() RPCs (monitor.CHECK_REQUESTS / CHECK_RESPONSES) are not
ported yet: until they are, check_accounting reads what tests and seams
put there, 0 / 0 on a served path.

Every serving plane carries its own counters, but the invariants that
only emerge under composition — exact report conservation, quota
accounting across device pools and the host oracle, grant/generation
coherence, discovery↔mixer plane agreement — were each verified only
inside their own smoke script, never continuously at runtime. The
AuditPlane here is a background thread, strictly OFF the hot path:
it reads existing counter families and ledgers (monitor.*, the
forensics rings, GrantPolicy.watermark, DeviceQuotaPool.audit_view,
ReplicaRouter.routing_stats) and evaluates six typed mesh-wide
invariants as AuditCheck objects with status ∈ {ok, degraded,
violated}, evidence deltas and the config generation checked at:

  report_conservation    accepted == exported + typed_rejected (the
                         report-plane ledger, audited between scrapes
                         instead of only at shutdown)
  check_accounting       decoded == answered + typed-rejected residue
                         per front (serving + resilience families)
  quota_conservation     device pools' counter cells within bounds +
                         a sampled host memquota-oracle recount
  grant_coherence        no post-revocation grant carries a
                         pre-publish generation (revoke-before-swap,
                         watched live via a generation watermark)
  plane_agreement        analysis/planes equivalence over the
                         CURRENTLY SERVED snapshot pair, memoized by
                         content digest (plus the discovery scope
                         program when a DiscoveryService is attached)
  routing_conservation   routed == folded + misrouted (the replica
                         router's routing_stats fold)

CONSERVATION IS EXACT ONLY AT QUIESCENCE: while requests are in
flight the ledgers legitimately disagree by the in-flight volume, so
a non-zero residue is `degraded` (transient) and only an IMPOSSIBLE
state — negative in-flight, or a residue that sits frozen across
consecutive evaluations beyond what typed rejections account for —
is `violated`.

Violations emit forensics EVENTS (`audit_violation` with the
invariant name + evidence note), bump the zero-shaped `mixer_audit_*`
families and flip the /readyz-adjacent `mixer_audit_healthy` gauge.

The FAULT-EXPLAINABILITY SCORER: every ChaosHooks injection commits
an expected-signature record here (CHAOS.on_inject → the module
InjectionLedger) — wedge → host:<handler> breaker event / exemplar
stage wait; device fault → fallback counter delta or device breaker
event; oracle fault → batch-failure delta; adapter fault → host
error-outcome delta. The auditor matches records against the
forensics rings + counter deltas within a bounded window and
publishes `mixer_fault_explainability_rate` = matched /
(matched + expired-unmatched) — the "every injected fault must be
explainable" soak-gate metric. Vacuously 1.0 with no injections.

SEAMS is a test-only corruption shim: the tests and chip_smoke skew one
reading at the auditor's READ side (never the real counters, never
the serving path) to prove the detector fires end to end.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from istio_tpu_torch.runtime import forensics, monitor
from istio_tpu_torch.utils.log import scope

log = scope("runtime.audit")

OK = "ok"
DEGRADED = "degraded"
VIOLATED = "violated"

INVARIANTS = monitor.AUDIT_INVARIANTS


@dataclass
class AuditCheck:
    """One invariant's verdict at one evaluation."""
    name: str
    status: str = OK
    evidence: dict = field(default_factory=dict)
    generation: int = -1
    wall: float = 0.0
    note: str = ""

    def as_dict(self) -> dict:
        return {"name": self.name, "status": self.status,
                "evidence": self.evidence, "generation": self.generation,
                "wall": self.wall, "note": self.note}


class AuditSeams:
    """Test-only corruption seams, applied at the auditor's READ side.

    A gate needs to prove a corrupted counter flips audit_healthy and
    surfaces evidence in the snapshot — skewing the
    auditor's reading exercises the whole detection path without
    poisoning the process-global families other suites share."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.report_accepted_skew = 0
        self.check_decoded_skew = 0
        self.grant_issue_skew = 0
        self.routing_misrouted_skew = 0
        self.quota_negative_cells_skew = 0
        # extra (name, pilot, mixer) pairs appended to the served
        # snapshot's plane-agreement pair set
        self.plane_pairs_extra: list = []


SEAMS = AuditSeams()


class InjectionLedger:
    """Expected-signature records for ChaosHooks injections.

    note() runs at the injection-commit points (CHAOS.on_inject) —
    it must stay cheap and never raise: one lock round, counter-
    baseline reads, coalescing per (kind, handler) within a short
    window so a hard outage (10^9 armed failures) is one record with
    n=count, not a ring flood."""

    def __init__(self, capacity: int = 256,
                 coalesce_s: float = 1.0) -> None:
        self._lock = threading.Lock()
        self._capacity = capacity
        self._coalesce_s = coalesce_s
        self._records: list[dict] = []
        self._matched_n = 0
        self._expired_n = 0

    def reset(self) -> None:
        with self._lock:
            self._records = []
            self._matched_n = 0
            self._expired_n = 0

    def note(self, kind: str, **detail) -> None:
        try:
            base = self._baseline(kind)
            now = time.perf_counter()
            key = (kind, detail.get("handler", ""))
            with self._lock:
                for rec in reversed(self._records):
                    if (rec["key"] == key and not rec["matched"]
                            and now - rec["t"] <= self._coalesce_s):
                        rec["n"] += 1
                        break
                else:
                    self._records.append({
                        "key": key, "kind": kind,
                        "detail": dict(detail),
                        "t": now, "wall": time.time(), "n": 1,
                        "base": base, "matched": False,
                        "matched_by": "", "expired": False,
                    })
                    if len(self._records) > self._capacity:
                        dropped = self._records.pop(0)
                        if not dropped["matched"] \
                                and not dropped["expired"]:
                            self._expired_n += dropped["n"]
            monitor.FAULT_INJECTIONS.inc(1, kind=kind)
        except Exception:   # the chaos seam must never observe a raise
            pass

    def _baseline(self, kind: str) -> dict:
        if kind in ("device", "oracle"):
            rc = monitor.resilience_counters()
            return {"fallback_total": rc["fallback_total"],
                    "batch_failures_total": rc["batch_failures_total"]}
        if kind == "discovery":
            # note() fires INSIDE publish, before the generation bump —
            # the baseline is the generation the delayed push started
            # from; evidence is the generation advancing past it (the
            # stalled push completed)
            return {"generation":
                    int(monitor.DISCOVERY_GENERATION.value())}
        hc = monitor.host_action_counters()
        out = hc.get("outcomes", {})
        return {"error": out.get("error", 0),
                "overrun": out.get("overrun", 0),
                "breaker_open": out.get("breaker_open", 0),
                "expired": out.get("expired", 0),
                "retries": hc.get("retries", 0)}

    # -- matching (runs on the audit thread) ---------------------------

    def evaluate(self, window_s: float) -> dict:
        """Match pending records against forensics evidence; expire
        unmatched records older than the window; publish the rate."""
        now = time.perf_counter()
        events = forensics.EVENTS.snapshot(limit=256)
        try:
            exemplars = forensics.RECORDER.snapshot(
                top_k=64)["slowest"]
        except Exception:
            exemplars = []
        rc = monitor.resilience_counters()
        _hc_full = monitor.host_action_counters()
        hc = dict(_hc_full.get("outcomes", {}))
        hc["retries"] = _hc_full.get("retries", 0)
        gen = int(monitor.DISCOVERY_GENERATION.value())
        with self._lock:
            for rec in self._records:
                if rec["matched"] or rec["expired"]:
                    continue
                matched_by = self._signature(rec, events, exemplars,
                                             rc, hc, gen)
                if matched_by:
                    rec["matched"] = True
                    rec["matched_by"] = matched_by
                    self._matched_n += rec["n"]
                    monitor.FAULT_MATCHED.inc(rec["n"], kind=rec["kind"])
                elif now - rec["t"] > window_s:
                    rec["expired"] = True
                    self._expired_n += rec["n"]
            matched, expired = self._matched_n, self._expired_n
            pending = sum(r["n"] for r in self._records
                          if not r["matched"] and not r["expired"])
            recent = [{k: r[k] for k in ("kind", "detail", "wall", "n",
                                         "matched", "matched_by",
                                         "expired")}
                      for r in self._records[-32:]]
        denom = matched + expired
        rate = matched / denom if denom else 1.0
        monitor.FAULT_EXPLAINABILITY.set(rate)
        return {"rate": round(rate, 4), "matched": matched,
                "unexplained": expired, "pending": pending,
                "records": recent}

    @staticmethod
    def _signature(rec: dict, events: list, exemplars: list,
                   rc: dict, hc: dict, gen: int = 0) -> str:
        """The expected-signature match for one injection record —
        returns the evidence name, or '' while unexplained."""
        kind = rec["kind"]
        t0 = rec["t"] - 0.05           # clock slack: same process
        base = rec["base"]

        def event(kinds, name=None):
            for e in events:
                if e["kind"] in kinds and e["t"] >= t0:
                    if name is None or \
                            e.get("detail", {}).get("name") == name:
                        return e
            return None

        if kind in ("wedge", "adapter"):
            handler = rec["detail"].get("handler", "")
            lane = f"host:{handler}"
            ev = event(("breaker",), name=lane)
            if ev is not None:
                return f"event:breaker {lane}"
            for ex in exemplars:
                if ex.get("wall", 0.0) >= rec["wall"] - 0.05 and \
                        lane in ex.get("stages_ms", {}):
                    return f"exemplar:{lane}"
            if kind == "adapter" and \
                    hc.get("error", 0) > base.get("error", 0):
                return "counter:host_action error"
            if kind == "wedge":
                for oc in ("overrun", "breaker_open", "expired"):
                    if hc.get(oc, 0) > base.get(oc, 0):
                        return f"counter:host_action {oc}"
            return ""
        if kind == "device":
            if rc["fallback_total"] > base.get("fallback_total", 0):
                return "counter:fallback_total"
            ev = event(("breaker",), name="device")
            if ev is not None:
                return "event:breaker device"
            return ""
        if kind == "oracle":
            if rc["batch_failures_total"] > \
                    base.get("batch_failures_total", 0):
                return "counter:batch_failures_total"
            return ""
        if kind == "quota":
            # an injected backend failure rides the executor's mq lane
            # and lands as a typed host-action error outcome; a single
            # transient failure may instead be absorbed by the lane's
            # one jittered retry (outcome ok, retries bumped), and
            # under a storm the lane breaker may absorb the tail
            if hc.get("error", 0) > base.get("error", 0):
                return "counter:host_action error"
            if hc.get("retries", 0) > base.get("retries", 0):
                return "counter:host_action retries"
            handler = rec["detail"].get("handler", "")
            ev = event(("breaker",), name=f"host:{handler}")
            if ev is not None:
                return f"event:breaker host:{handler}"
            for oc in ("overrun", "breaker_open", "expired"):
                if hc.get(oc, 0) > base.get(oc, 0):
                    return f"counter:host_action {oc}"
            return ""
        if kind == "discovery":
            # the delayed publish completed: generation advanced past
            # the mid-publish baseline
            if gen > base.get("generation", 0):
                return "counter:discovery_generation"
            return ""
        return ""


INJECTIONS = InjectionLedger()


def install_chaos_observer() -> None:
    """Point the process-wide chaos seam at the ledger (idempotent).
    Lives outside ChaosHooks.reset() on purpose: the chaos suites
    reset the seam per scenario and the scorer must survive it."""
    from istio_tpu_torch.runtime.resilience import CHAOS
    CHAOS.on_inject = INJECTIONS.note


class AuditPlane:
    """The background auditor. One instance per RuntimeServer,
    started at the end of __init__ and stopped first in shutdown().
    Every read is a snapshot/ledger accessor that takes at most a
    brief bookkeeping lock — the auditor never times, never blocks
    and never writes the serving path."""

    def __init__(self, runtime: Any = None, *,
                 interval_s: float = 0.5,
                 explain_window_s: float = 10.0,
                 quota_every: int = 8,
                 stuck_after: int = 3,
                 stuck_floor_s: float | None = None,
                 max_pairs: int = 128) -> None:
        self.runtime = runtime
        self.interval_s = max(float(interval_s), 0.05)
        self.explain_window_s = float(explain_window_s)
        self.quota_every = max(int(quota_every), 1)
        self.stuck_after = max(int(stuck_after), 2)
        if stuck_floor_s is None:
            # a frozen residue younger than the slowest LEGITIMATE
            # request is transient by definition: cover the serving
            # deadline (a wedged adapter answers typed at deadline,
            # freezing the tuple for that long) plus slack
            deadline_ms = getattr(getattr(runtime, "args", None),
                                  "default_check_deadline_ms",
                                  None) or 0.0
            stuck_floor_s = max(self.stuck_after * self.interval_s,
                                deadline_ms / 1e3 + 0.5, 2.0)
        self.stuck_floor_s = float(stuck_floor_s)
        self.max_pairs = int(max_pairs)
        self._discovery: Any = None
        self._lock = threading.RLock()
        self._checks: dict[str, AuditCheck] = {}
        self._explain: dict = {"rate": 1.0, "matched": 0,
                               "unexplained": 0, "pending": 0,
                               "records": []}
        self._stuck: dict[str, tuple] = {}   # name → (reading, n, t0)
        self._grant_base: tuple | None = None    # (policy gen, revision)
        self._plane_digest: str | None = None
        self._plane_cached: AuditCheck | None = None
        self._quota_cached: AuditCheck | None = None
        self._evaluations = 0
        self._last_wall = 0.0
        self._stop_ev = threading.Event()
        self._thread: threading.Thread | None = None
        install_chaos_observer()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_ev.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mesh-audit")
        self._thread.start()

    def stop(self, deadline_s: float = 2.0) -> None:
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(timeout=deadline_s)
        self._thread = None

    close = stop

    def attach_discovery(self, svc: Any) -> None:
        """Fold a DiscoveryService's scope program into the
        plane_agreement check (its pairs re-derive the served routes'
        source constraints against the carried compiled program)."""
        self._discovery = svc
        self._plane_digest = None   # force re-evaluation

    def _run(self) -> None:
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.evaluate()
            except Exception:     # the auditor must never die
                log.exception("audit evaluation failed")

    # -- evaluation ----------------------------------------------------

    def evaluate(self) -> dict:
        """One full pass over every invariant + the explainability
        scorer; callable on demand (a caller refreshes before it reads
        the snapshot). Thread-safe; returns the snapshot dict."""
        with self._lock:
            wall = time.time()
            gen = self._generation()
            checks = [
                self._report_conservation(),
                self._check_accounting(),
                self._quota_conservation(),
                self._grant_coherence(),
                self._plane_agreement(),
                self._routing_conservation(),
            ]
            for chk in checks:
                chk.generation = gen
                chk.wall = wall
                monitor.AUDIT_CHECKS.inc(1, invariant=chk.name,
                                         status=chk.status)
                prev = self._checks.get(chk.name)
                if chk.status == VIOLATED and (
                        prev is None or prev.status != VIOLATED):
                    monitor.AUDIT_VIOLATIONS.inc(1, invariant=chk.name)
                    forensics.record_event(
                        "audit_violation", invariant=chk.name,
                        note=chk.note or chk.status)
                    log.warning("audit violation: %s — %s %s",
                                chk.name, chk.note, chk.evidence)
            self._checks = {c.name: c for c in checks}
            healthy = all(c.status != VIOLATED for c in checks)
            monitor.AUDIT_HEALTHY.set(1.0 if healthy else 0.0)
            monitor.AUDIT_EVALUATIONS.inc()
            self._explain = INJECTIONS.evaluate(self.explain_window_s)
            self._evaluations += 1
            self._last_wall = wall
            return self.snapshot()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "running": self._thread is not None
                and self._thread.is_alive(),
                "interval_s": self.interval_s,
                "evaluations": self._evaluations,
                "wall": self._last_wall,
                "healthy": all(c.status != VIOLATED
                               for c in self._checks.values()),
                "checks": [self._checks[n].as_dict()
                           for n in INVARIANTS if n in self._checks],
                "explainability": dict(self._explain),
                "counters": monitor.audit_counters(),
            }

    # -- helpers -------------------------------------------------------

    def _generation(self) -> int:
        try:
            return int(
                self.runtime.controller.dispatcher.snapshot.revision)
        except Exception:
            return -1

    def _stuck_state(self, name: str, reading: tuple) -> tuple:
        """(consecutive evaluations, seconds) this invariant's raw
        reading has been frozen. A non-zero in-flight residue that
        never moves is lost rows, not traffic — but only once it has
        been frozen BOTH for stuck_after evaluations AND longer than
        stuck_floor_s: a single wedged request legitimately holds the
        tuple frozen for its full deadline, and back-to-back manual
        evaluations must not promote a transient to violated."""
        now = time.perf_counter()
        prev, n, t0 = self._stuck.get(name, (None, 0, now))
        if reading == prev:
            n += 1
        else:
            n, t0 = 1, now
        self._stuck[name] = (reading, n, t0)
        return n, now - t0

    # -- invariants ----------------------------------------------------

    def _report_conservation(self) -> AuditCheck:
        cons = monitor.report_conservation()
        accepted = cons["accepted"] + SEAMS.report_accepted_skew
        in_flight = accepted - cons["exported"] - cons["rejected_total"]
        ev = {"accepted": accepted, "exported": cons["exported"],
              "rejected": cons["rejected"],
              "rejected_total": cons["rejected_total"],
              "in_flight": in_flight}
        chk = AuditCheck("report_conservation", evidence=ev)
        if in_flight < 0:
            chk.status = VIOLATED
            chk.note = ("more records exported+rejected than the wire "
                        "ever accepted")
        elif in_flight == 0:
            self._stuck.pop(chk.name, None)
        else:
            reading = (accepted, cons["exported"],
                       cons["rejected_total"])
            n, frozen_s = self._stuck_state(chk.name, reading)
            ev["stuck_evaluations"] = n
            ev["frozen_s"] = round(frozen_s, 3)
            if n >= self.stuck_after and \
                    frozen_s >= self.stuck_floor_s:
                chk.status = VIOLATED
                chk.note = (f"{in_flight} records in flight, frozen "
                            f"{frozen_s:.1f}s across {n} evaluations "
                            f"— silently dropped, not in transit")
            else:
                chk.status = DEGRADED
                chk.note = "records in flight (transient)"
        return chk

    def _check_accounting(self) -> AuditCheck:
        sc = monitor.serving_counters()
        rc = monitor.resilience_counters()
        decoded = sc["requests_decoded"] + SEAMS.check_decoded_skew
        sent = sc["responses_sent"]
        in_flight = decoded - sent
        typed = (rc["shed_total"] + rc["expired_total"]
                 + rc["cancelled_shed_total"])
        ev = {"decoded": decoded, "answered": sent,
              "in_flight": in_flight, "shed_total": rc["shed_total"],
              "expired_total": rc["expired_total"],
              "fallback_total": rc["fallback_total"],
              "cancelled_shed_total": rc["cancelled_shed_total"],
              "breaker_state": rc["breaker_state"]}
        chk = AuditCheck("check_accounting", evidence=ev)
        if in_flight < 0:
            chk.status = VIOLATED
            chk.note = "more responses sent than requests decoded"
        elif in_flight == 0:
            self._stuck.pop(chk.name, None)
        else:
            n, frozen_s = self._stuck_state(
                chk.name, (decoded, sent, typed))
            ev["stuck_evaluations"] = n
            ev["frozen_s"] = round(frozen_s, 3)
            if n < self.stuck_after or frozen_s < self.stuck_floor_s:
                chk.status = DEGRADED
                chk.note = "requests in flight (transient)"
            elif in_flight <= typed:
                # a rejected wire RPC decodes without per-row
                # responses; the typed shed/expired counters account
                # for every such row
                chk.note = (f"steady residue {in_flight} covered by "
                            f"typed rejections ({typed})")
            else:
                chk.status = VIOLATED
                chk.note = (f"{in_flight} decoded requests frozen "
                            f"{frozen_s:.1f}s unanswered, only "
                            f"{typed} typed rejections to account "
                            f"for them")
        return chk

    def _quota_conservation(self) -> AuditCheck:
        # the device half pulls counter planes — sampled every Nth
        # evaluation so the auditor's device traffic stays negligible
        # next to serving trips
        if self._quota_cached is not None and \
                self._evaluations % self.quota_every != 0:
            cached = self._quota_cached
            chk = AuditCheck(cached.name, cached.status,
                             dict(cached.evidence), note=cached.note)
            chk.evidence["sampled"] = False
            return chk
        chk = AuditCheck("quota_conservation")
        pools: dict[int, Any] = {}
        handlers: dict[str, Any] = {}
        try:
            dispatcher = self.runtime.controller.dispatcher
            for qname, pool in getattr(self.runtime.controller,
                                       "device_quotas", {}).items():
                pools.setdefault(id(pool), (qname, pool))
            for qname, h in getattr(dispatcher, "handlers",
                                    {}).items():
                backend = getattr(h, "_backend", None)
                if backend is not None and hasattr(backend, "cells"):
                    handlers[qname] = backend
        except Exception:
            pass
        device_ev, problems = {}, []
        for _pid, (qname, pool) in list(pools.items())[:4]:
            try:
                view = pool.audit_view()
            except Exception as exc:
                problems.append(f"{qname}: audit_view failed {exc}")
                continue
            view["negative_cells"] += SEAMS.quota_negative_cells_skew
            device_ev[qname] = view
            if view["negative_cells"] > 0:
                problems.append(f"{qname}: {view['negative_cells']} "
                                f"negative counter cells")
            if view["over_cap_cells"] > 0:
                problems.append(f"{qname}: {view['over_cap_cells']} "
                                f"cells above the window max "
                                f"{view['max_limit']}")
            if view["nonzero_beyond_keymap"] > 0:
                problems.append(f"{qname}: counts outside the "
                                f"allocated keymap")
        host_ev = {}
        from istio_tpu_torch.adapters.memquota import _TICKS_PER_WINDOW
        for qname, backend in list(handlers.items())[:4]:
            cells_checked = 0
            with backend.lock:
                for key, cell in list(backend.cells.items())[:256]:
                    cells_checked += 1
                    count = getattr(cell, "count", None)
                    if count is not None:      # exact cell
                        if not 0 <= count <= cell.max:
                            problems.append(
                                f"{qname}/{key}: exact count {count} "
                                f"outside [0, {cell.max}]")
                        continue
                    ticks = getattr(cell, "ticks", None)
                    if not ticks:
                        continue
                    if any(v < 0 for v in ticks.values()):
                        problems.append(
                            f"{qname}/{key}: negative tick amount")
                    newest = max(ticks)
                    recent = sum(v for t, v in ticks.items()
                                 if t > newest - _TICKS_PER_WINDOW)
                    if recent > cell.max:
                        problems.append(
                            f"{qname}/{key}: in-window usage "
                            f"{recent} > max {cell.max}")
            host_ev[qname] = {"cells_checked": cells_checked}
        chk.evidence = {"device_pools": device_ev,
                        "host_backends": host_ev, "sampled": True}
        if problems:
            chk.status = VIOLATED
            chk.note = "; ".join(problems[:4])
            chk.evidence["problems"] = problems[:16]
        self._quota_cached = chk
        return chk

    def _grant_coherence(self) -> AuditCheck:
        chk = AuditCheck("grant_coherence")
        policy = getattr(self.runtime, "grants", None)
        if policy is None:
            chk.evidence = {"enabled": False}
            return chk
        wm = policy.watermark()
        issued_at = wm["issued_at_generation"] + SEAMS.grant_issue_skew
        revision = self._generation()
        if self._grant_base is None:
            self._grant_base = (wm["generation"], revision)
        base_gen, base_rev = self._grant_base
        d_gen = wm["generation"] - base_gen
        d_rev = revision - base_rev
        chk.evidence = {"enabled": True,
                        "policy_generation": wm["generation"],
                        "issued_at_generation": issued_at,
                        "revocations": wm["revocations"],
                        "grants_issued": wm["grants_issued"],
                        "publishes_since_audit_start": d_rev,
                        "revocations_since_audit_start": d_gen}
        if issued_at > wm["generation"]:
            chk.status = VIOLATED
            chk.note = (f"a grant was issued at generation "
                        f"{issued_at}, beyond the policy watermark "
                        f"{wm['generation']}")
        elif 0 <= d_rev and d_gen < d_rev:
            # revoke-before-swap broken: a snapshot published without
            # the grant policy revoking first, so outstanding client
            # caches carry pre-publish TTLs
            chk.status = VIOLATED
            chk.note = (f"{d_rev} publishes but only {d_gen} "
                        f"revocations since audit start — a publish "
                        f"did not revoke before its swap")
        return chk

    def _plane_agreement(self) -> AuditCheck:
        from istio_tpu_torch.compiler.cache import stable_digest

        pairs: list = []
        finder = None
        try:
            snap = self.runtime.controller.dispatcher.snapshot
            finder = snap.finder
            for i in range(min(snap.n_config_rules, self.max_pairs)):
                compiled = snap.ruleset.rules[i]
                config_text = (snap.rules[i].match or "").strip() \
                    or "true"
                pairs.append((compiled.name, config_text,
                              compiled.ast if compiled.ast is not None
                              else (compiled.match.strip() or "true")))
        except Exception:
            pass
        pairs.extend(SEAMS.plane_pairs_extra)
        disc_pairs: list = []
        svc = self._discovery
        if svc is not None:
            try:
                disc_pairs = svc._snapshot.scope_audit_pairs(
                    limit=self.max_pairs)
            except Exception:
                disc_pairs = []
        digest = stable_digest([
            [(n, str(a), str(b)) for n, a, b in pairs],
            [(n, str(a), str(b)) for n, a, b in disc_pairs]])
        if digest == self._plane_digest \
                and self._plane_cached is not None:
            cached = self._plane_cached
            chk = AuditCheck(cached.name, cached.status,
                             dict(cached.evidence), note=cached.note)
            chk.evidence["memoized"] = True
            return chk
        chk = AuditCheck("plane_agreement")
        findings = []
        try:
            from istio_tpu_torch.analysis.planes import check_plane_pairs
            if pairs and finder is not None:
                findings += check_plane_pairs(pairs, finder)
            if disc_pairs:
                from istio_tpu_torch.pilot.route_nfa import ROUTE_FINDER
                findings += check_plane_pairs(disc_pairs, ROUTE_FINDER)
        except Exception as exc:
            chk.status = DEGRADED
            chk.note = f"plane check failed: {exc}"
            chk.evidence = {"n_pairs": len(pairs) + len(disc_pairs)}
            return chk
        from istio_tpu_torch.analysis.findings import Severity
        errors = [f for f in findings if f.severity == Severity.ERROR]
        warns = [f for f in findings if f.severity == Severity.WARNING]
        chk.evidence = {
            "n_pairs": len(pairs), "n_discovery_pairs": len(disc_pairs),
            "digest": digest[:16], "memoized": False,
            "findings": [{"code": f.code, "message": f.message}
                         for f in (errors + warns)[:8]],
        }
        if errors:
            chk.status = VIOLATED
            chk.note = (f"{len(errors)} witness-confirmed divergences "
                        f"between the served planes")
        elif warns:
            chk.status = DEGRADED
            chk.note = f"{len(warns)} pairs unproven"
        self._plane_digest = digest
        self._plane_cached = chk
        return chk

    def _routing_conservation(self) -> AuditCheck:
        chk = AuditCheck("routing_conservation")
        router = getattr(self.runtime, "_replica_router", None)
        if router is None:
            chk.evidence = {"enabled": False}
            return chk
        stats = router.routing_stats()
        misrouted = stats["misrouted"] + SEAMS.routing_misrouted_skew
        chk.evidence = {"enabled": True,
                        "rows_total": stats["rows_total"],
                        "rows_per_shard": stats["rows_per_shard"],
                        "misrouted": misrouted}
        if misrouted > 0:
            # the shard router counts a misroute then RAISES — any
            # non-zero count means rows reached a bank that does not
            # own their namespace
            chk.status = VIOLATED
            chk.note = f"{misrouted} rows misrouted across shards"
        return chk
