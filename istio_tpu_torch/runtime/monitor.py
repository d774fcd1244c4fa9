"""Self-metrics of the served check and report paths.

Port of the part of istio_tpu/runtime/monitor.py that those paths call:
the Check() stage histogram (`observe_stage`), the resolve and dispatch
timers and their counters (`resolve_timer`, `dispatch_timer`,
`RESOLVE_ERRORS`, `DISPATCH_ERRORS`), the per-request end-to-end
histogram and the batch-size histograms; for Report, the report stage
histogram (`observe_report_stage`), the per-template and per-exporter
record counts, and the record-conservation ledger (accepted == exported
+ rejected at quiescence; `report_conservation`); for Pilot's discovery
service, its stage histogram, push fan-out histogram, cache-event
counts and generation (`observe_discovery_stage` …
`discovery_latency_snapshot`). The reference exports
them through prometheus_client and its own registry; the port keeps
plain in-process counters (the card's machine has no prometheus_client),
and the exposition, SLO gauges and /debug views wait for the fronts.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time

_BUCKETS = (1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
            1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0,
            2.5, 5.0)


class Counter:
    """A count per label value (one label at most)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._v: dict[str, float] = {}
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = next(iter(labels.values()), "")
        with self._lock:
            self._v[key] = self._v.get(key, 0.0) + n

    def value(self, label: str = "") -> float:
        return self._v.get(label, 0.0)


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
CHECK_BATCH_FAILURES = Counter("mixer_check_batch_failures_total")
CHECK_DEADLINE_EXPIRED = Counter("mixer_check_deadline_expired_total")
CHECK_SHED = Counter("mixer_check_shed_total")


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
# record conservation: every record entering the plane ends in exactly
# one of exported / rejected (by reason)
REPORT_REJECT_REASONS = ("queue_full", "unavailable", "deadline", "error")
REPORT_RECORDS_ACCEPTED = Counter("mixer_report_records_accepted_total")
REPORT_RECORDS_EXPORTED = Counter("mixer_report_records_exported_total")
REPORT_RECORDS_REJECTED = Counter("mixer_report_records_rejected_total")


def observe_stage(stage: str, seconds: float) -> None:
    CHECK_STAGE_SECONDS.observe(seconds, stage=stage)


def observe_check_e2e(seconds: float) -> None:
    CHECK_E2E_SECONDS.observe(seconds)


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


def note_adapter_export(exporter: str, n_records: int,
                        error: bool = False) -> None:
    """One adapter handle_report outcome (dispatcher.report)."""
    if error:
        REPORT_EXPORTER_DROPS.inc(1, exporter=exporter)
    else:
        REPORT_EXPORTER_RECORDS.inc(n_records, exporter=exporter)


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
