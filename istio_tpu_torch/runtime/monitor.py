"""Self-metrics of the served check and report paths.

Port of the part of istio_tpu/runtime/monitor.py that those paths call:
the Check() stage histogram (`observe_stage`), the resolve and dispatch
timers and their counters (`resolve_timer`, `dispatch_timer`,
`RESOLVE_ERRORS`, `DISPATCH_ERRORS`), the per-request end-to-end
histogram and the batch-size histograms; the overload-resilience
counters (sheds, deadline expiries, oracle fallbacks, batch failures,
device retries, the breaker state and its transitions:
`resilience_counters()`) and the live latency window behind brownout
(`CHECK_WINDOW`, `refresh_latency_gauges`, `reset_latency_window`);
the adapter-executor plane's conservation families (submitted, resolved
by handler and outcome, seconds, late completions, retries) and the
list-provider refresh totals (`host_action_counters()`);
for Report, the report stage
histogram (`observe_report_stage`), the per-template and per-exporter
record counts, and the record-conservation ledger (accepted == exported
+ rejected at quiescence; `report_conservation`); for Pilot's discovery
service, its stage histogram, push fan-out histogram, cache-event
counts and generation (`observe_discovery_stage` …
`discovery_latency_snapshot`); for the sharded serving plane, its
stage histogram and per-replica families (`SHARD_STAGES`,
`observe_shard_stage`, `observe_replica_batch`, `shard_stage_baseline`,
`shard_latency_snapshot`), which sit on utils/metrics.default_registry
as in the reference; for the tail-latency forensics plane
(runtime/forensics.py), its ring counters (`FORENSICS_DROPPED` by ring,
`FORENSICS_SLOW`, `FORENSICS_EVENTS`, `forensics_counters()`) and the
stage tap the flight recorder's tape hangs on (`set_stage_tap`: every
`observe_stage` call also lands on the open tape); and the exporters'
last dispatch wall (`REPORT_EXPORTER_LAG_MS`, on the default registry,
read by runtime/slo.py); the wire fronts' decoded / answered Check()
counts (`CHECK_REQUESTS`, `CHECK_RESPONSES`, `serving_counters()`: the
fronts that move them are not ported yet); and the mesh audit plane's
families (runtime/audit.py: `AUDIT_CHECKS` by invariant and status,
`AUDIT_VIOLATIONS`, `AUDIT_EVALUATIONS`, `AUDIT_HEALTHY`, the
explainability scorer's `FAULT_INJECTIONS` / `FAULT_MATCHED` by kind and
`FAULT_EXPLAINABILITY`; zero-shaped; `audit_counters()`). The reference
exports the others through
prometheus_client and its own registry; the port keeps plain in-process
counters for them (the card's machine has no prometheus_client), and
the exposition and /debug views wait for the fronts.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import threading
import time
from typing import Iterable

from istio_tpu_torch.utils import metrics as hostmetrics

_BUCKETS = (1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
            1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0,
            2.5, 5.0)


class Counter:
    """A count per label value. One label keys by its value; several
    (always passed in the same keyword order) key by the tuple of their
    values."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._v: dict = {}
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = next(iter(labels.values()), "") if len(labels) <= 1 \
            else tuple(labels.values())
        with self._lock:
            self._v[key] = self._v.get(key, 0.0) + n

    def value(self, label="") -> float:
        return self._v.get(label, 0.0)

    def series(self) -> dict:
        """A copy of every label key → count."""
        with self._lock:
            return dict(self._v)


class Histogram:
    """Cumulative bucket counts per label value (one label at most)."""

    def __init__(self, name: str, buckets: tuple = _BUCKETS) -> None:
        self.name = name
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._series: dict[str, list] = {}   # label → [counts, sum, n]

    def observe(self, v: float, **labels: str) -> None:
        key = next(iter(labels.values()), "")
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(self.buckets) + 1),
                                         0.0, 0]
            s[0][i] += 1
            s[1] += v
            s[2] += 1

    def sum(self, label: str = "") -> float:
        s = self._series.get(label)
        return 0.0 if s is None else s[1]

    def state(self, label: str = "") -> tuple[list[int], float, int]:
        """(per-bucket counts copy, sum, n) of one label value."""
        with self._lock:
            s = self._series.get(label)
            return ([], 0.0, 0) if s is None else (list(s[0]), s[1], s[2])


class Gauge:
    """One value, set."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def value(self) -> float:
        return self._v


class SlidingWindow:
    """Rolling window over the last `capacity` observations with exact
    quantiles computed on read (port of the reference's
    utils/metrics.SlidingWindow). observe() is hot-path cheap (a deque
    append under a lock); quantiles() sorts a snapshot and is meant for
    scrape-rate readers."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._buf: collections.deque[float] = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self._buf.append(value)
            self._total += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def total(self) -> int:
        """Observations ever seen (not just the ones still windowed)."""
        with self._lock:
            return self._total

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()

    def quantiles(self, qs: Iterable[float]) -> list[float]:
        """Exact quantiles over the current window (one sort for all of
        them); empty window → zeros."""
        with self._lock:
            data = sorted(self._buf)
        if not data:
            return [0.0 for _ in qs]
        n = len(data)
        return [data[min(int(q * n), n - 1)] for q in qs]


def quantile_from_counts(buckets: tuple, counts: list, n: int,
                         q: float) -> float:
    """The upper bound of the bucket holding the q-th observation."""
    if not counts or n <= 0:
        return 0.0
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= q * n:
            return buckets[i] if i < len(buckets) else float("inf")
    return float("inf")


RESOLVE_COUNT = Counter("mixer_runtime_resolve_count")
RESOLVE_DURATION = Histogram("mixer_runtime_resolve_duration_seconds")
RESOLVE_ERRORS = Counter("mixer_runtime_resolve_errors_total")
DISPATCH_COUNT = Counter("mixer_runtime_dispatch_count")
DISPATCH_DURATION = Histogram("mixer_runtime_dispatch_duration_seconds")
DISPATCH_ERRORS = Counter("mixer_runtime_dispatch_errors_total")

# the Check() stage decomposition, as in the reference
CHECK_STAGES = ("queue_wait", "tensorize", "h2d", "device_step", "fold",
                "respond")
CHECK_STAGE_SECONDS = Histogram("mixer_check_stage_seconds")
CHECK_E2E_SECONDS = Histogram("mixer_check_e2e_seconds")
CHECK_BATCH_SIZE = Histogram("mixer_check_batch_size",
                             buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256,
                                      512, 1024, 2048, 4096))
# the wire fronts' decoded / answered Check() counts (grpcServer.go's
# monitoring role): read by serving_counters() and the audit plane's
# check_accounting
CHECK_REQUESTS = Counter("mixer_grpc_check_requests")
CHECK_RESPONSES = Counter("mixer_grpc_check_responses")
CHECK_P99_TARGET_MS = 1.0   # BASELINE north star: <1ms p99 at 10k rules
# the live window of per-request e2e latencies: brownout reads its p99
CHECK_WINDOW = SlidingWindow(4096)
CHECK_P99_MS = Gauge("mixer_check_p99_ms")

# -- overload resilience (runtime/resilience.py and the batcher's
# admission control). Per-REQUEST counts except batch_failures (per
# batch). Labels: shed by reason, fallback by reason, transitions by
# target state.
CHECK_SHED_REASONS = ("queue_full", "brownout", "batcher_dead",
                      "draining")
CHECK_FALLBACK_REASONS = ("breaker_open", "device_error", "fail_open")
CHECK_SHED = Counter("mixer_check_shed_total")
CHECK_DEADLINE_EXPIRED = Counter("mixer_check_deadline_expired_total")
CHECK_FALLBACK = Counter("mixer_check_fallback_total")
CHECK_BATCH_FAILURES = Counter("mixer_check_batch_failures_total")
# rows dropped at batch build because the caller already cancelled
CHECK_CANCELLED_SHED = Counter("mixer_check_cancelled_shed_total")
CHECK_DEVICE_RETRIES = Counter("mixer_check_device_retries_total")
# device breaker state: 0 closed, 1 half_open, 2 open
BREAKER_STATE = Gauge("mixer_check_breaker_state")
BREAKER_TRANSITIONS = Counter("mixer_check_breaker_transitions_total")


def resilience_counters() -> dict:
    """Resilience counter snapshot as one JSON-able dict, with the
    reference's keys and values."""
    shed = {r: int(CHECK_SHED.value(r)) for r in CHECK_SHED_REASONS}
    fb = {r: int(CHECK_FALLBACK.value(r)) for r in CHECK_FALLBACK_REASONS}
    return {
        "shed": shed,
        "shed_total": sum(shed.values()),
        "expired_total": int(CHECK_DEADLINE_EXPIRED.value()),
        "fallback": fb,
        "fallback_total": sum(fb.values()),
        "batch_failures_total": int(CHECK_BATCH_FAILURES.value()),
        "cancelled_shed_total": int(CHECK_CANCELLED_SHED.value()),
        "device_retries_total": int(CHECK_DEVICE_RETRIES.value()),
        "breaker_state": int(BREAKER_STATE.value()),
    }


# -- the tail-latency forensics plane (runtime/forensics.py). Two bounded
# rings back it: the flight recorder's slow-request exemplars and the mesh
# event timeline. Overflow on either is bounded and typed: the dropped
# family is zero-shaped per ring before the first drop.
FORENSICS_RINGS = ("slow", "events")
FORENSICS_DROPPED = Counter("mixer_forensics_dropped_total")
FORENSICS_SLOW = Counter("mixer_forensics_slow_exemplars_total")
FORENSICS_EVENTS = Counter("mixer_forensics_events_total")
for _r in FORENSICS_RINGS:
    FORENSICS_DROPPED.inc(0, ring=_r)


def note_forensics_drop(ring: str) -> None:
    if ring not in FORENSICS_RINGS:
        ring = "slow"
    FORENSICS_DROPPED.inc(1, ring=ring)


def forensics_counters() -> dict:
    """The forensics counters as one JSON-able dict, with the
    reference's keys (readers delta against their own baseline)."""
    return {
        "slow_captured": int(FORENSICS_SLOW.value()),
        "events_recorded": int(FORENSICS_EVENTS.value()),
        "dropped": {r: int(FORENSICS_DROPPED.value(r))
                    for r in FORENSICS_RINGS},
    }


# -- the adapter-executor plane (runtime/executor.py). Every submitted
# host action resolves with EXACTLY one outcome: ok (adapter result
# used), error (adapter exception → safeDispatch INTERNAL), shed (lane
# queue full / closed lane), expired (request deadline gone before the
# wait), overrun (still running at the deadline → fail-policy verdict),
# breaker_open (lane breaker short-circuit); so submitted ==
# sum(outcomes) at quiescence. A worker finishing an action the fold
# already abandoned counts late_{ok,error} apart: late results are
# accounting, never verdicts. Labels: handler; handler and outcome;
# handler and result.
HOST_ACTION_OUTCOMES = ("ok", "error", "shed", "expired", "overrun",
                        "breaker_open")
HOST_ACTIONS_SUBMITTED = Counter("mixer_host_actions_submitted_total")
HOST_ACTIONS = Counter("mixer_host_actions_total")
HOST_ACTION_SECONDS = Histogram("mixer_host_action_seconds")
HOST_ACTION_LATE = Counter("mixer_host_action_late_total")
HOST_ACTION_RETRIES = Counter("mixer_host_action_retries_total")
# provider refresh on the executor's maintenance lane: attempts and the
# failures among them (a failing provider keeps its last good list)
LIST_REFRESH_TOTAL = Counter("mixer_list_provider_refresh_total")
LIST_REFRESH_FAILURES = Counter("mixer_list_provider_refresh_failures")


def note_host_action_submitted(handler: str) -> None:
    HOST_ACTIONS_SUBMITTED.inc(1, handler=handler)


def note_host_action(handler: str, outcome: str,
                     seconds: float | None = None) -> None:
    """One resolved host action (AdapterExecutor.resolve / abandon, the
    single accounting home)."""
    HOST_ACTIONS.inc(1, handler=handler, outcome=outcome)
    if seconds is not None:
        HOST_ACTION_SECONDS.observe(seconds, handler=handler)


def note_host_action_late(handler: str, result: str) -> None:
    HOST_ACTION_LATE.inc(1, handler=handler, result=result)


def note_host_action_retry(handler: str) -> None:
    HOST_ACTION_RETRIES.inc(1, handler=handler)


def host_action_counters() -> dict:
    """The executor plane's counters as one JSON-able dict, with the
    reference's keys and values. `exact` is the conservation check
    (true whenever nothing is in flight)."""
    by_handler: dict[str, dict] = {}
    submitted_total = 0
    for h, v in HOST_ACTIONS_SUBMITTED.series().items():
        by_handler.setdefault(h, {"submitted": 0, "outcomes": {}})
        by_handler[h]["submitted"] += int(v)
        submitted_total += int(v)
    resolved_total = 0
    outcome_totals = {o: 0 for o in HOST_ACTION_OUTCOMES}
    for (h, o), v in HOST_ACTIONS.series().items():
        by_handler.setdefault(h, {"submitted": 0, "outcomes": {}})
        by_handler[h]["outcomes"][o] = \
            by_handler[h]["outcomes"].get(o, 0) + int(v)
        outcome_totals[o] = outcome_totals.get(o, 0) + int(v)
        resolved_total += int(v)
    late = {"ok": 0, "error": 0}
    for (_h, r), v in HOST_ACTION_LATE.series().items():
        if r in late:
            late[r] += int(v)
    retries = sum(int(v) for v in HOST_ACTION_RETRIES.series().values())
    return {
        "submitted": submitted_total,
        "resolved": resolved_total,
        "in_flight": submitted_total - resolved_total,
        "outcomes": outcome_totals,
        "late": late,
        "retries": retries,
        "by_handler": by_handler,
        "exact": submitted_total == resolved_total,
        "refresh_total": int(LIST_REFRESH_TOTAL.value()),
        "refresh_failures": int(LIST_REFRESH_FAILURES.value()),
    }


# the Report() pipeline: coalesce_wait (report batcher), tensorize,
# device_field_eval (the packed report trip: dispatch and pull),
# intern_decode (host id → value decode), adapter_dispatch
REPORT_STAGES = ("coalesce_wait", "tensorize", "device_field_eval",
                 "intern_decode", "adapter_dispatch")
REPORT_STAGE_SECONDS = Histogram("mixer_report_stage_seconds")
REPORT_BATCH_SIZE = Histogram("mixer_report_batch_size",
                              buckets=CHECK_BATCH_SIZE.buckets)
# report instances dispatched to adapters, by template
REPORT_TEMPLATE_RECORDS = Counter("mixer_report_template_records_total")
# adapter export accounting by exporter (qualified handler name):
# records delivered, drops (handler exceptions)
REPORT_EXPORTER_RECORDS = Counter("mixer_report_exporter_records_total")
REPORT_EXPORTER_DROPS = Counter("mixer_report_exporter_drops_total")
# wall milliseconds of each exporter's most recent handle_report (label:
# exporter); runtime/slo.py reads it
REPORT_EXPORTER_LAG_MS = hostmetrics.default_registry.gauge(
    "mixer_report_exporter_last_dispatch_ms",
    "wall milliseconds of the exporter's most recent handle_report")
REPORT_EXPORTER_LAG_MS.set(0.0)
# record conservation: every record entering the plane ends in exactly
# one of exported / rejected (by reason)
REPORT_REJECT_REASONS = ("queue_full", "unavailable", "deadline", "error")
REPORT_RECORDS_ACCEPTED = Counter("mixer_report_records_accepted_total")
REPORT_RECORDS_EXPORTED = Counter("mixer_report_records_exported_total")
REPORT_RECORDS_REJECTED = Counter("mixer_report_records_rejected_total")


# the forensics stage tap (runtime/forensics.py registers the flight
# recorder's thread-local tape here at import): every check stage
# observation also lands on the open batch tape, so the recorder needs no
# second set of timers on the hot path. None until forensics loads.
_STAGE_TAP = None


def set_stage_tap(fn) -> None:
    global _STAGE_TAP
    _STAGE_TAP = fn


def observe_stage(stage: str, seconds: float) -> None:
    CHECK_STAGE_SECONDS.observe(seconds, stage=stage)
    if _STAGE_TAP is not None:
        _STAGE_TAP(stage, seconds)


def observe_check_e2e(seconds: float) -> None:
    """Per-request end-to-end observation; the live gauges refresh
    lazily (refresh_latency_gauges), never per request."""
    CHECK_E2E_SECONDS.observe(seconds)
    CHECK_WINDOW.observe(seconds)


def refresh_latency_gauges() -> dict:
    """Recompute the live p99 gauge from the window. Called by
    scrape-rate readers (brownout at most every 50 ms) — never per
    request."""
    p50, p95, p99 = CHECK_WINDOW.quantiles((0.50, 0.95, 0.99))
    p50_ms, p95_ms, p99_ms = p50 * 1e3, p95 * 1e3, p99 * 1e3
    CHECK_P99_MS.set(p99_ms)
    # an empty window is vacuously under target: an idle server is not
    # violating its SLO
    under = not len(CHECK_WINDOW) or p99_ms <= CHECK_P99_TARGET_MS
    return {"p50_ms": p50_ms, "p95_ms": p95_ms, "p99_ms": p99_ms,
            "n_window": len(CHECK_WINDOW),
            "n_total": CHECK_WINDOW.total,
            "target_ms": CHECK_P99_TARGET_MS,
            "under_target": under}


def reset_latency_window() -> None:
    """Drop the windowed observations (a scenario boundary). The
    histograms keep accumulating; only the live gauges' window
    resets."""
    CHECK_WINDOW.reset()


@contextlib.contextmanager
def resolve_timer():
    RESOLVE_COUNT.inc()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        RESOLVE_DURATION.observe(time.perf_counter() - t0)


@contextlib.contextmanager
def dispatch_timer():
    DISPATCH_COUNT.inc()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        DISPATCH_DURATION.observe(time.perf_counter() - t0)


def observe_report_stage(stage: str, seconds: float) -> None:
    REPORT_STAGE_SECONDS.observe(seconds, stage=stage)


def report_accepted(n: int = 1) -> None:
    REPORT_RECORDS_ACCEPTED.inc(n)


def report_exported(n: int = 1) -> None:
    REPORT_RECORDS_EXPORTED.inc(n)


def report_rejected(n: int, reason: str) -> None:
    if reason not in REPORT_REJECT_REASONS:
        reason = "error"
    REPORT_RECORDS_REJECTED.inc(n, reason=reason)


def report_record_done(fut) -> None:
    """The single accounting home of coalesced report records: attached
    as a done-callback to every future the report coalescer returns, so
    every accepted record is counted exported or typed-rejected exactly
    once."""
    from istio_tpu_torch.runtime import resilience

    try:
        exc = fut.exception()
    except BaseException:   # cancelled futures carry no exception
        report_rejected(1, "error")
        return
    if exc is None:
        report_exported(1)
    elif isinstance(exc, resilience.ResourceExhaustedError):
        report_rejected(1, "queue_full")
    elif isinstance(exc, resilience.DeadlineExceededError):
        report_rejected(1, "deadline")
    elif isinstance(exc, resilience.UnavailableError):
        report_rejected(1, "unavailable")
    else:
        report_rejected(1, "error")


def note_adapter_export(exporter: str, template: str, n_records: int,
                        seconds: float, error: bool = False) -> None:
    """One adapter handle_report outcome (dispatcher.report): `seconds`
    is its wall. `template` is the reference's argument, kept for its
    per-exporter /debug view, which waits for the introspection
    plane."""
    if error:
        REPORT_EXPORTER_DROPS.inc(1, exporter=exporter)
    else:
        REPORT_EXPORTER_RECORDS.inc(n_records, exporter=exporter)
    REPORT_EXPORTER_LAG_MS.set(seconds * 1e3, exporter=exporter)


def serving_counters() -> dict:
    """The serving-path counters as one JSON-able dict, with the
    reference's keys: requests decoded vs answered by the fronts, and
    how batch formation went (non-empty size buckets)."""
    counts, rows, _n = CHECK_BATCH_SIZE.state()
    hist: dict[str, int] = {}
    for i, c in enumerate(counts):
        if c:
            b = CHECK_BATCH_SIZE.buckets[i] \
                if i < len(CHECK_BATCH_SIZE.buckets) else None
            hist["inf" if b is None else str(int(b))] = int(c)
    decoded = int(CHECK_REQUESTS.value())
    sent = int(CHECK_RESPONSES.value())
    _c, report_rows, report_n = REPORT_BATCH_SIZE.state()
    return {
        "requests_decoded": decoded,
        "responses_sent": sent,
        "in_flight": decoded - sent,
        "batches_formed": sum(hist.values()),
        "batch_rows": int(rows),
        "batch_size_hist": hist,
        "report_batch_rows": int(report_rows),
        "report_batches_formed": int(report_n),
    }


def report_conservation(since: dict | None = None) -> dict:
    """accepted == exported + rejected at quiescence; in_flight is the
    transient difference and `exact` holds only when the plane is
    drained. `since`: an earlier reading — the counters are process-
    lifetime cumulative, so a scenario deltas against its own
    baseline."""
    accepted = int(REPORT_RECORDS_ACCEPTED.value())
    exported = int(REPORT_RECORDS_EXPORTED.value())
    rejected = {r: int(REPORT_RECORDS_REJECTED.value(r))
                for r in REPORT_REJECT_REASONS}
    if since is not None:
        accepted -= since.get("accepted", 0)
        exported -= since.get("exported", 0)
        base_rej = since.get("rejected", {})
        rejected = {r: v - base_rej.get(r, 0) for r, v in rejected.items()}
    rej_total = sum(rejected.values())
    return {"accepted": accepted, "exported": exported,
            "rejected": rejected, "rejected_total": rej_total,
            "in_flight": accepted - exported - rej_total,
            "exact": accepted == exported + rej_total}


# -- Pilot's discovery service (pilot/discovery.py). Stage semantics, one
# observation per unit of discovery work:
#   snapshot_build — registry/config freeze + per-namespace content
#                    digests + per-host indexes, per publish
#   scope_plan     — namespace→shard delta planning, per publish
#   invalidate     — snapshot diff + scoped cache sweep + shard
#                    version bumps/wakeups, per publish
#   route_eval     — ONE batched source-admission device trip shared by
#                    every pending node group (RouteScopeProgram
#                    .admit_rows), per batch
#   generate       — config JSON assembly + cache fill, per batch of
#                    node groups
#   serve          — cache lookup → response bytes, per endpoint call
DISCOVERY_STAGES = ("snapshot_build", "scope_plan", "invalidate",
                    "route_eval", "generate", "serve")
DISCOVERY_STAGE_SECONDS = Histogram("pilot_discovery_stage_seconds")
# publish → a parked version-watcher waking with the new generation
DISCOVERY_PUSH_FANOUT_SECONDS = Histogram(
    "pilot_discovery_push_fanout_seconds")
# hit / miss per endpoint call; carried / invalidated per publish sweep
DISCOVERY_CACHE_EVENTS = ("hit", "miss", "carried", "invalidated")
DISCOVERY_CACHE = Counter("pilot_discovery_cache_events_total")
DISCOVERY_GENERATION = Gauge("pilot_discovery_generation")


def observe_discovery_stage(stage: str, seconds: float) -> None:
    DISCOVERY_STAGE_SECONDS.observe(seconds, stage=stage)


def observe_discovery_push(seconds: float) -> None:
    DISCOVERY_PUSH_FANOUT_SECONDS.observe(seconds)


def note_discovery_cache(event: str, n: int = 1) -> None:
    if n:
        DISCOVERY_CACHE.inc(n, event=event)


def set_discovery_generation(version: int) -> None:
    DISCOVERY_GENERATION.set(float(version))


def discovery_stage_baseline() -> dict:
    """Subtraction token for discovery_latency_snapshot(since=...)."""
    token = {stage: DISCOVERY_STAGE_SECONDS.state(stage)
             for stage in DISCOVERY_STAGES}
    token["__push__"] = DISCOVERY_PUSH_FANOUT_SECONDS.state()
    return token


def _delta(state, base):
    counts, total, n = state
    bcounts, btotal, bn = base
    if bcounts:
        counts = [c - b for c, b in zip(counts, bcounts)] if counts else []
    return counts, total - btotal, n - bn


def discovery_latency_snapshot(since: dict | None = None) -> dict:
    """Discovery stage decomposition + push fan-out percentiles as one
    JSON-able dict (`since`: a discovery_stage_baseline() token)."""
    empty = ([], 0.0, 0)
    stages: dict[str, dict] = {}
    h = DISCOVERY_STAGE_SECONDS
    for stage in DISCOVERY_STAGES:
        counts, total, n = h.state(stage)
        if since is not None:
            counts, total, n = _delta((counts, total, n),
                                      since.get(stage, empty))
        if not n:
            continue
        stages[stage] = {
            "count": n,
            "sum_ms": round(total * 1e3, 3),
            "p50_ms": round(quantile_from_counts(
                h.buckets, counts, n, 0.5) * 1e3, 3),
            "p99_ms": round(quantile_from_counts(
                h.buckets, counts, n, 0.99) * 1e3, 3),
        }
    ph = DISCOVERY_PUSH_FANOUT_SECONDS
    counts, total, n = ph.state()
    if since is not None:
        counts, total, n = _delta((counts, total, n),
                                  since.get("__push__", empty))
    push = {"count": n}
    if n:
        push.update({
            "p50_ms": round(quantile_from_counts(
                ph.buckets, counts, n, 0.5) * 1e3, 3),
            "p99_ms": round(quantile_from_counts(
                ph.buckets, counts, n, 0.99) * 1e3, 3),
        })
    return {"stages": stages, "push": push}


# -- sharded serving plane (istio_tpu_torch/sharding) ------------------
#
# Stage semantics (one observation per unit of router work;
# bank_check is per (batch, bank) so a batch spanning B banks
# contributes B observations — the device-trip fan-out IS the cost
# being attributed):
#   shard_dispatch — namespace extraction + row bucketing, per batch
#   bank_check     — one bank's full fused check on its sub-batch
#                    (tensorize → device trip → overlay, the existing
#                    CHECK stages decompose it further)
#   fold           — response scatter back into row order + bank-local
#                    → global deny-index remap, per batch
SHARD_STAGES = ("shard_dispatch", "bank_check", "fold")

SHARD_STAGE_SECONDS = hostmetrics.default_registry.histogram(
    "mixer_shard_stage_seconds",
    "per-batch sharded-serving stage latency (label: stage; see "
    "runtime/monitor.py SHARD_STAGES for unit semantics)")
REPLICA_BATCH_SECONDS = hostmetrics.default_registry.histogram(
    "mixer_replica_batch_seconds",
    "per-replica served batch wall seconds (label: replica)")
REPLICA_ROWS = hostmetrics.default_registry.counter(
    "mixer_replica_rows_total",
    "check rows served per replica lane (label: replica)")
REPLICA_ROWS.inc(0)   # zero-series before the first routed batch


def observe_shard_stage(stage: str, seconds: float) -> None:
    SHARD_STAGE_SECONDS.observe(seconds, stage=stage)


def observe_replica_batch(replica: int, seconds: float,
                          rows: int) -> None:
    REPLICA_BATCH_SECONDS.observe(seconds, replica=str(replica))
    REPLICA_ROWS.inc(rows, replica=str(replica))


def shard_stage_baseline() -> dict:
    """Subtraction token for shard_latency_snapshot(since=...) — the
    same delta-window discipline as discovery_stage_baseline()."""
    return {stage: SHARD_STAGE_SECONDS.state(stage=stage)
            for stage in SHARD_STAGES}


def shard_latency_snapshot(since: dict | None = None) -> dict:
    """Sharded-path stage decomposition (count/sum/p50/p99 per stage)
    as one JSON-able dict."""
    empty = ([], 0.0, 0)
    stages: dict[str, dict] = {}
    h = SHARD_STAGE_SECONDS
    for stage in SHARD_STAGES:
        counts, total, n = h.state(stage=stage)
        if since is not None:
            counts, total, n = _delta((counts, total, n),
                                      since.get(stage, empty))
        if not n:
            continue
        stages[stage] = {
            "count": n,
            "sum_ms": round(total * 1e3, 3),
            "p50_ms": round(quantile_from_counts(
                h.buckets, counts, n, 0.5) * 1e3, 3),
            "p99_ms": round(quantile_from_counts(
                h.buckets, counts, n, 0.99) * 1e3, 3),
        }
    return {"stages": stages}


# -- the mesh audit plane (runtime/audit.py). Zero-shaped: every
# (invariant, status) series exists before the first evaluation, since
# "no audit data" and "audit never ran" are different incidents. Labels:
# invariant and status; invariant; kind.
AUDIT_INVARIANTS = ("report_conservation", "check_accounting",
                    "quota_conservation", "grant_coherence",
                    "plane_agreement", "routing_conservation")
AUDIT_STATUSES = ("ok", "degraded", "violated")
FAULT_KINDS = ("wedge", "device", "oracle", "adapter", "quota",
               "discovery")
# evaluations per invariant per verdict
AUDIT_CHECKS = Counter("mixer_audit_checks")
# transitions of an invariant into the violated state
AUDIT_VIOLATIONS = Counter("mixer_audit_violations")
AUDIT_EVALUATIONS = Counter("mixer_audit_evaluations")
# 1 while no invariant is violated
AUDIT_HEALTHY = Gauge("mixer_audit_healthy")
# chaos injections registered with the explainability scorer, and those
# matched to forensics evidence within the window
FAULT_INJECTIONS = Counter("mixer_fault_explainability_injections")
FAULT_MATCHED = Counter("mixer_fault_explainability_matched")
# matched / (matched + expired unmatched); vacuously 1.0
FAULT_EXPLAINABILITY = Gauge("mixer_fault_explainability_rate")
for _inv in AUDIT_INVARIANTS:
    AUDIT_VIOLATIONS.inc(0, invariant=_inv)
    for _st in AUDIT_STATUSES:
        AUDIT_CHECKS.inc(0, invariant=_inv, status=_st)
for _k in FAULT_KINDS:
    FAULT_INJECTIONS.inc(0, kind=_k)
    FAULT_MATCHED.inc(0, kind=_k)
AUDIT_HEALTHY.set(1.0)
FAULT_EXPLAINABILITY.set(1.0)


def audit_counters() -> dict:
    """One JSON-able reading of the audit and explainability families,
    with the reference's keys."""
    return {
        "evaluations": int(AUDIT_EVALUATIONS.value()),
        "healthy": bool(AUDIT_HEALTHY.value() >= 1.0),
        "checks": {inv: {st: int(AUDIT_CHECKS.value((inv, st)))
                         for st in AUDIT_STATUSES}
                   for inv in AUDIT_INVARIANTS},
        "violations": {inv: int(AUDIT_VIOLATIONS.value(inv))
                       for inv in AUDIT_INVARIANTS},
        "explainability_rate": float(FAULT_EXPLAINABILITY.value()),
        "injections": {k: int(FAULT_INJECTIONS.value(k))
                       for k in FAULT_KINDS},
        "matched": {k: int(FAULT_MATCHED.value(k)) for k in FAULT_KINDS},
    }
