"""Adapter executor: host actions off the batch thread, bulkheaded and
deadline-bounded.

Port of istio_tpu/runtime/executor.py. The Mixer never runs adapter work
inline: every aspect dispatch goes through a bounded goroutine pool
(mixer/pkg/pool) so one slow backend cannot stall the request path.
This module is that pool:

  * BULKHEADS: every handler (qualified name) owns a bounded work queue
    and its own workers. A wedged handler exhausts its own lane; the
    other lanes never notice. Overflow sheds typed, never silently.
  * A DEADLINE-BOUNDED FOLD: a host action inherits the batch's
    deadline (batcher → ResilientChecker → Dispatcher.check →
    resolve()). An action still running at the deadline resolves to the
    host fail policy's verdict ("open" → OK with a 1 s / 1-use TTL,
    "closed" → UNAVAILABLE) and counts `overrun`: the batch folds when
    the device results and the resolved or defaulted host results are
    in, never held by a wedged backend.
  * A CIRCUIT BREAKER PER LANE (resilience.CircuitBreaker with
    publish=False: a lane breaker moves neither the device breaker's
    state gauge nor its transitions counter). Lanes persist across
    config swaps. An open breaker short-circuits to the fail policy; the
    half-open probe closes it again.
  * THE MAINTENANCE LANE: periodic host work (the list providers'
    refresh, list.go:115-247) runs on its own lane, driven by the
    executor's scheduler thread.

Accounting is exact at resolve(): every submitted action resolves with
exactly one outcome of monitor.HOST_ACTION_OUTCOMES. A worker that
completes an action the fold already gave up on counts only as
`late_ok` / `late_error`.

An adapter exception keeps safeDispatch's semantics (dispatcher.go:399):
one jittered retry, then the action's own INTERNAL result, not the fail
policy, so the executor path answers as the inline path does whenever no
breaker is open and no deadline struck.

The reference also writes the fold's claim wait per lane into the
flight recorder's tape (`RECORDER.host_wait`) and each provider refresh
into the mesh event ring (`record_event`); runtime/forensics.py is not
ported, so neither is written here.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import random
import threading
import time
from typing import Any, Callable, Mapping

from istio_tpu_torch.runtime import monitor
from istio_tpu_torch.runtime.resilience import (CHAOS, UNAVAILABLE,
                                                CircuitBreaker)

log = logging.getLogger("istio_tpu_torch.runtime.executor")

# the lane every periodic job runs on (provider refresh); never used for
# request-path actions
MAINTENANCE_LANE = "__maintenance__"

OUTCOMES = monitor.HOST_ACTION_OUTCOMES

# a failed adapter call is retried once after this backoff plus up to
# this jitter (safeDispatch's one retry)
RETRY_BACKOFF_S = 0.002
RETRY_JITTER_S = 0.004


@dataclasses.dataclass
class ExecutorConfig:
    """Knobs of the AdapterExecutor (ServerArgs' executor_workers,
    executor_queue_cap, host_fail_policy, host_action_timeout_ms,
    host_breaker_failures and host_breaker_reset_s)."""
    # worker threads per handler lane
    workers: int = 2
    # pending host actions per lane; submits past it shed typed
    queue_cap: int = 256
    # what an unresolvable host action answers: "open" → OK with a
    # 1 s / 1-use TTL, "closed" → UNAVAILABLE
    fail_policy: str = "closed"
    # a bound on every action even when the request carries no deadline
    # (0 = the request's deadline only)
    action_timeout_s: float = 0.0
    # per-lane breaker: consecutive failed or overrun actions that trip
    # it, and how long it stays open before a half-open probe
    breaker_failures: int = 3
    breaker_reset_s: float = 5.0
    # the maintenance scheduler's poll interval
    maintenance_tick_s: float = 0.25


class HostAction:
    """One submitted adapter call. The worker completes it; the fold
    claims it exactly once through AdapterExecutor.resolve(). Whichever
    side is late, the claim carries the conservation outcome, and a
    completion after the claim only moves the late_* counters."""

    __slots__ = ("handler", "fallback", "fn", "_done", "_lock",
                 "_result", "_worker_outcome", "_claimed", "_wall",
                 "immediate")

    def __init__(self, handler: str,
                 fallback: Callable[[str, str], Any],
                 immediate: str | None = None,
                 fn: Callable[[], Any] | None = None):
        self.handler = handler
        self.fallback = fallback
        self.fn = fn
        # set for an action refused at submit (breaker_open / shed):
        # resolve() never waits on it
        self.immediate = immediate
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._result: Any = None
        self._worker_outcome: str | None = None
        self._claimed = False
        self._wall = 0.0

    def _complete(self, result: Any, outcome: str, wall: float) -> bool:
        """Worker side. True when the fold still owns the action; False
        when it was already abandoned (the late_* path)."""
        with self._lock:
            self._result = result
            self._worker_outcome = outcome
            self._wall = wall
            fresh = not self._claimed
        self._done.set()
        return fresh

    def _claim(self, timeout: float | None
               ) -> tuple[Any, str, float] | None:
        """Fold side: wait up to `timeout` and claim the result. None →
        the action is still running (the caller applies the fail
        policy)."""
        self._done.wait(timeout)
        with self._lock:
            self._claimed = True
            if self._worker_outcome is None:
                return None
            return self._result, self._worker_outcome, self._wall


class HandlerLane:
    """One handler's bulkhead: a bounded queue, its workers and its
    circuit breaker. Lanes are keyed by qualified handler name and
    outlive config swaps, so breaker state survives a republish."""

    def __init__(self, name: str, config: ExecutorConfig):
        self.name = name
        self.config = config
        self.breaker = CircuitBreaker(config.breaker_failures,
                                      config.breaker_reset_s,
                                      publish=False,
                                      name=f"handler:{name}")
        self._queue: "queue.Queue[HostAction | None]" = \
            queue.Queue(maxsize=max(int(config.queue_cap), 1))
        self._lock = threading.Lock()
        self._closed = False
        self.outcomes: dict[str, int] = {o: 0 for o in OUTCOMES}
        self.late = {"ok": 0, "error": 0}
        self.submitted = 0
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"adapter-{name}-{i}")
            for i in range(max(int(config.workers), 1))]
        for t in self._workers:
            t.start()

    def submit(self, fn: Callable[[], Any],
               fallback: Callable[[str, str], Any]) -> HostAction:
        """Queue one adapter call. Never blocks and never raises: a full
        queue, a closed lane or an open breaker returns an action
        resolved at once to its typed outcome."""
        with self._lock:
            self.submitted += 1
        if self._closed:
            return HostAction(self.name, fallback, immediate="shed")
        if not self.breaker.allow_device():
            return HostAction(self.name, fallback,
                              immediate="breaker_open")
        act = HostAction(self.name, fallback, fn=fn)
        try:
            self._queue.put_nowait(act)
        except queue.Full:
            # the probe slot allow_device may have granted never ran
            self.breaker.release_probe()
            return HostAction(self.name, fallback, immediate="shed")
        return act

    def _worker(self) -> None:
        while True:
            act = self._queue.get()
            if act is None:
                return
            self._run_one(act, act.fn)

    def _run_one(self, act: HostAction, fn: Callable[[], Any]) -> None:
        t0 = time.perf_counter()
        outcome = "ok"
        result: Any = None
        try:
            CHAOS.adapter_call(self.name)
            result = fn()
        except Exception:
            # one jittered retry absorbs a transient backend fault
            # without involving the breaker
            time.sleep(RETRY_BACKOFF_S + random.random() * RETRY_JITTER_S)
            monitor.note_host_action_retry(self.name)
            try:
                CHAOS.adapter_call(self.name)
                result = fn()
            except Exception as exc:
                outcome, result = "error", exc
                self.breaker.record_failure()
            else:
                self.breaker.record_success()
        else:
            self.breaker.record_success()
        wall = time.perf_counter() - t0
        if not act._complete(result, outcome, wall):
            # the fold already answered this action by the fail policy:
            # the late completion is accounting only
            key = "ok" if outcome == "ok" else "error"
            with self._lock:
                self.late[key] += 1
            monitor.note_host_action_late(self.name, key)

    def note_outcome(self, outcome: str) -> None:
        with self._lock:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1

    def stats(self) -> dict:
        with self._lock:
            outcomes = dict(self.outcomes)
            late = dict(self.late)
            submitted = self.submitted
        return {
            "queue_depth": self._queue.qsize(),
            "queue_cap": self._queue.maxsize,
            "workers": len(self._workers),
            "submitted": submitted,
            "outcomes": outcomes,
            "late": late,
            "breaker": self.breaker.snapshot(),
        }

    def close(self, grace_s: float = 1.0) -> None:
        """Stop the workers. A wedged worker is left running as a daemon
        thread, never joined for longer than `grace_s` in all."""
        self._closed = True
        for _ in self._workers:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                break
        end = time.perf_counter() + grace_s
        for t in self._workers:
            t.join(timeout=max(end - time.perf_counter(), 0.0))


class AdapterExecutor:
    """The adapter-executor plane: per-handler lanes, the deadline-bounded
    resolve, and the maintenance scheduler. One per RuntimeServer, shared
    by every dispatcher generation."""

    def __init__(self, config: ExecutorConfig | None = None):
        self.config = config or ExecutorConfig()
        if self.config.fail_policy not in ("open", "closed"):
            raise ValueError(
                f"host fail_policy must be 'open' or 'closed', got "
                f"{self.config.fail_policy!r}")
        self._lanes: dict[str, HandlerLane] = {}
        self._lanes_lock = threading.Lock()
        self._closed = False
        # maintenance registry: name → {fn, interval_s, next_due, ...}
        self._refresh: dict[str, dict] = {}
        # refreshables registered by name (not rebuilt from a published
        # handler map): a republish keeps them
        self._persistent_refresh: dict[str, Any] = {}
        self._refresh_lock = threading.Lock()
        self._maint_stop = threading.Event()
        self._maint_thread: threading.Thread | None = None

    # -- lanes ---------------------------------------------------------

    def lane(self, handler: str) -> HandlerLane:
        ln = self._lanes.get(handler)
        if ln is None:
            with self._lanes_lock:
                ln = self._lanes.get(handler)
                if ln is None:
                    ln = HandlerLane(handler, self.config)
                    self._lanes[handler] = ln
        return ln

    def submit(self, handler: str, fn: Callable[[], Any],
               fallback: Callable[[str, str], Any]) -> HostAction:
        """Queue one adapter call on the handler's lane. `fn` is the
        zero-argument adapter call (its instance already built);
        `fallback(policy, reason)` builds the fail-policy result for
        this action's variety (check_fallback / quota_fallback). Returns
        at once; the fold pairs every submit with exactly one resolve()
        or abandon()."""
        monitor.note_host_action_submitted(handler)
        if self._closed:
            # lane() on a closed executor would start workers again
            return HostAction(handler, fallback, immediate="shed")
        return self.lane(handler).submit(fn, fallback)

    def resolve(self, act: HostAction, deadline: float | None = None
                ) -> Any:
        """Claim one action's result, bounded by the request's deadline
        (an absolute time.perf_counter() instant) and the configured
        per-action timeout. The single accounting home: every submitted
        action lands here (or in abandon) exactly once."""
        lane = self._lanes.get(act.handler)
        policy = self.config.fail_policy
        if act.immediate is not None:
            outcome = act.immediate
            if lane is not None:
                lane.note_outcome(outcome)
            monitor.note_host_action(act.handler, outcome)
            return act.fallback(policy, outcome)
        timeout: float | None = None
        if deadline is not None:
            timeout = deadline - time.perf_counter()
            if timeout > 86_400.0:
                # a deadline days out is no deadline (and would overflow
                # Event.wait's C time type)
                timeout = None
        if self.config.action_timeout_s > 0:
            timeout = self.config.action_timeout_s if timeout is None \
                else min(timeout, self.config.action_timeout_s)
        if timeout is not None and timeout <= 0:
            # the deadline is gone: claim whatever finished, else expire
            timeout = 0.0
        got = act._claim(timeout)
        if got is None:
            # still running at the bound: the batch folds with the
            # policy's verdict and the worker's completion counts late.
            # An overrun is a breaker failure, so a backend whose calls
            # never return still trips the lane open
            outcome = "overrun" if timeout is None or timeout > 0 \
                else "expired"
            if lane is not None:
                lane.breaker.record_failure()
                lane.note_outcome(outcome)
            monitor.note_host_action(act.handler, outcome)
            return act.fallback(policy, outcome)
        result, outcome, wall = got
        if lane is not None:
            lane.note_outcome(outcome)
        monitor.note_host_action(act.handler, outcome, wall)
        if outcome == "error":
            # safeDispatch parity: the inline path's INTERNAL result
            return act.fallback("error",
                                f"{type(result).__name__}: {result}")
        return result

    def abandon(self, act: HostAction) -> None:
        """Account an action its fold unwinds past (an exception between
        submit and claim), unless the fold already claimed it. No wait,
        the result is dropped, and the breaker is not charged: the
        fold's failure is not the adapter's."""
        with act._lock:
            if act._claimed:
                return
        if act.immediate is not None:
            outcome = act.immediate
        else:
            got = act._claim(0.0)
            outcome = got[1] if got is not None else "expired"
        lane = self._lanes.get(act.handler)
        if lane is not None:
            lane.note_outcome(outcome)
        monitor.note_host_action(act.handler, outcome)

    # -- maintenance lane ----------------------------------------------

    def register_refreshables(self, handlers: Mapping[str, Any]) -> None:
        """(Re)build the maintenance registry from a published handler
        map: every handler with a callable `refresh`, a positive
        `refresh_interval_s` and a provider gets a periodic slot on the
        maintenance lane. Called on every publish; a name's counts
        survive republishes."""
        fresh: dict[str, dict] = {}
        now = time.monotonic()
        with self._refresh_lock:
            for name, h in handlers.items():
                refresh = getattr(h, "refresh", None)
                interval = float(getattr(h, "refresh_interval_s", 0.0)
                                 or 0.0)
                if not callable(refresh) or interval <= 0:
                    continue
                if getattr(h, "_provider", None) is None:
                    continue   # nothing to pull again
                fresh[name] = self._refresh_entry(
                    refresh, interval, now, self._refresh.get(name))
            for name, obj in self._persistent_refresh.items():
                prev = self._refresh.get(name)
                fresh[name] = prev if prev is not None else \
                    self._refresh_entry(obj.refresh,
                                        float(obj.refresh_interval_s),
                                        now, None)
            self._refresh = fresh
        if fresh:
            self._start_maintenance()

    @staticmethod
    def _refresh_entry(fn, interval: float, now: float,
                       prev: dict | None) -> dict:
        return {
            "fn": fn,
            "interval_s": interval,
            "next_due": now + interval,
            "total": prev["total"] if prev else 0,
            "failures": prev["failures"] if prev else 0,
            "last_success_wall": prev["last_success_wall"] if prev else None,
            "last_error": prev["last_error"] if prev else None,
            "in_flight": False,
        }

    def register_refreshable(self, name: str, obj: Any) -> None:
        """Register a refreshable by name (a `refresh()` and a
        `refresh_interval_s`); a republish does not drop it."""
        refresh = getattr(obj, "refresh", None)
        interval = float(getattr(obj, "refresh_interval_s", 0.0) or 0.0)
        if not callable(refresh) or interval <= 0:
            raise ValueError(
                f"refreshable {name!r} needs a callable refresh and a "
                f"positive refresh_interval_s")
        with self._refresh_lock:
            self._persistent_refresh[name] = obj
            self._refresh[name] = self._refresh_entry(
                refresh, interval, time.monotonic(),
                self._refresh.get(name))
        self._start_maintenance()

    def _start_maintenance(self) -> None:
        with self._refresh_lock:
            if self._maint_thread is not None or self._closed:
                return
            self._maint_thread = threading.Thread(
                target=self._maintenance_loop, daemon=True,
                name="adapter-maintenance")
            self._maint_thread.start()

    def _maintenance_loop(self) -> None:
        tick = max(self.config.maintenance_tick_s, 0.01)
        while not self._maint_stop.wait(tick):
            now = time.monotonic()
            due: list[tuple[str, dict]] = []
            with self._refresh_lock:
                for name, st in self._refresh.items():
                    if st["next_due"] <= now and not st["in_flight"]:
                        st["in_flight"] = True
                        due.append((name, st))
            for name, st in due:
                # the refresh runs on the maintenance lane: a slow
                # provider holds that worker, never a request lane or
                # the scheduler
                act = self.lane(MAINTENANCE_LANE).submit(
                    lambda n=name, s=st: self._run_refresh(n, s),
                    lambda _p, _r: None)
                if act.immediate is not None:
                    # shed at the lane: try again next tick
                    with self._refresh_lock:
                        st["in_flight"] = False

    def _run_refresh(self, name: str, st: dict) -> None:
        monitor.LIST_REFRESH_TOTAL.inc()
        err: str | None = None
        try:
            st["fn"]()
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
            monitor.LIST_REFRESH_FAILURES.inc()
            log.warning("provider refresh %s failed: %s", name, err)
        with self._refresh_lock:
            st["total"] += 1
            if err is None:
                st["last_success_wall"] = time.time()
                st["last_error"] = None
            else:
                st["failures"] += 1
                st["last_error"] = err
            st["next_due"] = time.monotonic() + st["interval_s"]
            st["in_flight"] = False

    def refresh_now(self, name: str) -> bool:
        """One synchronous refresh; False when `name` is not
        registered."""
        with self._refresh_lock:
            st = self._refresh.get(name)
        if st is None:
            return False
        self._run_refresh(name, st)
        return True

    # -- introspection / lifecycle ---------------------------------------

    def snapshot(self) -> dict:
        """Per-lane queue and breaker state, the conservation counters,
        the policy knobs and the maintenance registry."""
        with self._lanes_lock:
            lanes = dict(self._lanes)
        now = time.time()
        with self._refresh_lock:
            maint = {}
            for name, st in self._refresh.items():
                last = st["last_success_wall"]
                maint[name] = {
                    "interval_s": st["interval_s"],
                    "refresh_total": st["total"],
                    "refresh_failures": st["failures"],
                    "last_refresh_age_s":
                        round(now - last, 3) if last else None,
                    "last_error": st["last_error"],
                }
        return {
            "policy": {
                "fail_policy": self.config.fail_policy,
                "workers_per_handler": self.config.workers,
                "queue_cap": self.config.queue_cap,
                "action_timeout_s": self.config.action_timeout_s,
                "breaker_failures": self.config.breaker_failures,
                "breaker_reset_s": self.config.breaker_reset_s,
            },
            "lanes": {name: ln.stats() for name, ln in sorted(lanes.items())},
            "counters": monitor.host_action_counters(),
            "maintenance": maint,
            "closed": self._closed,
        }

    def close(self, grace_s: float = 1.0) -> None:
        """The scheduler first (no new maintenance work), then every
        lane. Idempotent; wedged workers are left as daemon threads."""
        with self._refresh_lock:
            if self._closed:
                return
            self._closed = True
        self._maint_stop.set()
        t = self._maint_thread
        if t is not None and t.is_alive():
            t.join(timeout=grace_s)
        with self._lanes_lock:
            lanes = list(self._lanes.values())
        for ln in lanes:
            ln.close(grace_s)


# -- fail-policy results (the dispatcher's fallbacks) ----------------------

def check_fallback(policy: str, reason: str):
    """CheckResult of a CHECK action that did not resolve. `policy` is
    "open" / "closed" for the deadline, bulkhead and breaker outcomes,
    or "error" for an adapter exception (safeDispatch's INTERNAL, which
    is no policy decision: the inline path answers the same)."""
    from istio_tpu_torch.adapters.sdk import CheckResult
    from istio_tpu_torch.models.policy_engine import INTERNAL, OK

    if policy == "error":
        # one dispatch error per failed action, counted here
        monitor.DISPATCH_ERRORS.inc()
        log.warning("adapter check failed: %s", reason)
        return CheckResult(status_code=INTERNAL,
                           status_message=f"adapter panic: {reason}")
    if policy == "open":
        # fail-open answers OK with a 1 s / 1-use TTL, so sidecars check
        # again soon instead of caching the blanket allow
        return CheckResult(status_code=OK, valid_duration_s=1.0,
                           valid_use_count=1)
    return CheckResult(status_code=UNAVAILABLE,
                       status_message=f"host adapter unavailable ({reason})")


def quota_fallback(policy: str, reason: str, amount: int):
    """QuotaResult of a QUOTA action that did not resolve: fail-open
    grants the requested amount, fail-closed grants nothing with
    UNAVAILABLE, and an adapter exception keeps Dispatcher.quota's
    INTERNAL shape."""
    from istio_tpu_torch.adapters.sdk import QuotaResult
    from istio_tpu_torch.models.policy_engine import INTERNAL

    if policy == "error":
        monitor.DISPATCH_ERRORS.inc()
        log.warning("adapter quota failed: %s", reason)
        return QuotaResult(granted_amount=0, status_code=INTERNAL,
                           status_message=reason)
    if policy == "open":
        return QuotaResult(granted_amount=amount, valid_duration_s=1.0)
    return QuotaResult(
        granted_amount=0, status_code=UNAVAILABLE,
        status_message=f"quota adapter unavailable ({reason})")
