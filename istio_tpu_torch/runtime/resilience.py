"""Overload resilience for the Check() serving path.

Port of istio_tpu/runtime/resilience.py's check plane:

  * typed rejections (CheckRejected) carrying the gRPC status code the
    fronts surface — DEADLINE_EXCEEDED / RESOURCE_EXHAUSTED /
    UNAVAILABLE instead of INTERNAL for every failure shape;
  * a device CIRCUIT BREAKER (closed → open → half-open) in front of
    the fused device trip: a failed trip retries once with jittered
    backoff, consecutive failures trip the breaker and whole batches
    route to the host SnapshotOracle path (Dispatcher.check_host_oracle,
    which runs no kernel), then a half-open probe tries the card again;
  * a fail policy for when the oracle path fails too: "open" answers
    OK with a 1 s / 1-use TTL (Mixer client `policyCheckFailOpen`),
    "closed" answers UNAVAILABLE;
  * ChaosHooks — the process-wide `CHAOS` fault-injection seams at the
    device step (FusedPlan.packed_check, Dispatcher._resolve: both fire
    before the trip's first launch), the oracle fallback, the host
    adapter calls of the executor's lanes (latency, wedge, injected
    errors; runtime/executor.py), the quota backend (memquota) and the
    discovery publish.

Every degraded answer is counted (monitor: retries, fallbacks by
reason, breaker transitions) and logged at WARNING / ERROR.

On the card the chain is narrower than the reference's
(`ResilientChecker(strict_device=True)`, which RuntimeServer sets for a
CUDA device): only a fault injected through CHAOS's device seam is
retried, counted against the breaker and answered by the oracle or the
fail policy. Any other exception out of the device trip (a kernel that
fails to load or launch, a CUDA error, a fault in tensorize or the
fold) is logged at ERROR and raised to the caller, so no answer of a
card server is ever host work standing in for a failed kernel, and the
breaker never opens on a real fault. Every
breaker transition records a `breaker` event (name, from, to) on the
forensics event timeline (runtime/forensics.py), under the breaker lock
(the ring lock is a leaf), and CHAOS's adapter wedges record
`chaos_wedge` / `chaos_unwedge`. `CHAOS.on_inject`, when set (the mesh
audit plane's injection ledger, runtime/audit.py), is called outside the
chaos lock at each injection's commit point — a wedge, an adapter, quota,
device or oracle failure, a delayed discovery publish — and survives
reset(); an observer that raises changes nothing. Admission
control (queue cap, brownout, deadlines) lives in runtime/batcher.py.
"""
from __future__ import annotations

import dataclasses
import inspect
import logging
import random
import threading
import time
from typing import Any, Callable, Sequence

log = logging.getLogger("istio_tpu_torch.runtime.resilience")

# google.rpc codes the typed rejections surface
DEADLINE_EXCEEDED = 4
RESOURCE_EXHAUSTED = 8
UNAVAILABLE = 14


class CheckRejected(RuntimeError):
    """A request the serving path refused to answer — carries the gRPC
    status code the API fronts must surface."""
    grpc_code = 2   # UNKNOWN; subclasses override


class DeadlineExceededError(CheckRejected):
    grpc_code = DEADLINE_EXCEEDED


class ResourceExhaustedError(CheckRejected):
    grpc_code = RESOURCE_EXHAUSTED


class UnavailableError(CheckRejected):
    grpc_code = UNAVAILABLE


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs of the ResilientChecker (ServerArgs' check_fail_policy,
    breaker_failures, breaker_reset_s and device_retry)."""
    # "open": when device AND oracle paths are down, answer OK;
    # "closed": answer UNAVAILABLE
    fail_policy: str = "closed"
    # consecutive failed batches (after the in-batch retry) that trip
    # the breaker
    breaker_failures: int = 3
    # how long the breaker stays open before a half-open probe
    breaker_reset_s: float = 5.0
    # retry a failed device trip once, with jittered backoff, before
    # counting it as a breaker failure
    retry: bool = True
    retry_backoff_s: float = 0.005
    retry_jitter_s: float = 0.010


class CircuitBreaker:
    """closed → open (N consecutive failures) → half-open (one probe
    after reset_s) → closed on probe success / open on probe failure.

    Thread-safe: batches run concurrently on the batcher's worker pool,
    and transitions are decided under one lock (two probes in flight
    would double-count a flapping device)."""

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"

    def __init__(self, failures: int = 3, reset_s: float = 5.0,
                 publish: bool = True, name: str = "device"):
        self.failure_threshold = max(int(failures), 1)
        self.reset_s = reset_s
        # which breaker this is in the log ("device", "handler:<name>")
        self.name = name
        # False for the adapter executor's lane breakers: they move
        # neither the device breaker's state gauge nor its transitions
        # counter (their state shows in the executor's snapshot)
        self._publish_gauge = publish
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._publish()

    def _publish(self) -> None:
        if not self._publish_gauge:
            return
        from istio_tpu_torch.runtime import monitor
        monitor.BREAKER_STATE.set(
            {self.CLOSED: 0, self.HALF_OPEN: 1, self.OPEN: 2}[self._state])

    def _transition(self, to: str) -> None:
        if to == self._state:
            return
        log.warning("circuit breaker %s: %s -> %s", self.name, self._state,
                    to)
        # the mesh event timeline: a breaker flip is the control-plane
        # event a slow-request exemplar needs beside it. record_event
        # never raises and the ring lock is a leaf, so holding self._lock
        # here is safe
        from istio_tpu_torch.runtime import forensics
        forensics.record_event("breaker", name=self.name,
                               frm=self._state, to=to)
        self._state = to
        if self._publish_gauge:
            from istio_tpu_torch.runtime import monitor
            monitor.BREAKER_TRANSITIONS.inc(to=to)
        self._publish()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow_device(self) -> bool:
        """May this batch try the device? OPEN past the reset window
        admits exactly ONE half-open probe; everyone else falls back
        until the probe's verdict lands."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN and \
                    time.monotonic() - self._opened_at >= self.reset_s:
                self._transition(self.HALF_OPEN)
            if self._state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == self.HALF_OPEN:
                # the probe failed: back to open, restart the window
                self._probe_inflight = False
                self._opened_at = time.monotonic()
                self._transition(self.OPEN)
            elif self._state == self.CLOSED and \
                    self._consecutive >= self.failure_threshold:
                self._opened_at = time.monotonic()
                self._transition(self.OPEN)

    def release_probe(self) -> None:
        """A batch that got a device slot ended with NO verdict (a typed
        rejection or a non-Exception unwind rode out of the device
        call). The probe slot must be returned, or a half-open breaker
        wedges with probe_inflight set and never tries the device
        again."""
        with self._lock:
            self._probe_inflight = False

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "failure_threshold": self.failure_threshold,
                "reset_s": self.reset_s,
                "probe_inflight": self._probe_inflight,
            }
            if self._state == self.OPEN:
                out["open_for_s"] = round(
                    time.monotonic() - self._opened_at, 3)
            return out


class ChaosHooks:
    """Fault-injection seams: tests arm them, serving code probes them.
    Inert fields cost one attribute read per probe. The device seam
    fires at the real device boundary, before the trip's first kernel
    launch, so an injected failure runs the production unwind and
    launches nothing."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()
        # the injection observer (the audit plane's explainability
        # scorer registers expected-signature records through it). Set
        # after reset() and never touched by it: the registration must
        # survive the per-scenario resets. Called outside self._lock at
        # each injection's commit point; never raises out of a seam
        self.on_inject: Callable[..., None] | None = None

    def _notify(self, kind: str, **detail) -> None:
        cb = self.on_inject
        if cb is None:
            return
        try:
            cb(kind, **detail)
        except Exception:
            pass

    def reset(self) -> None:
        with self._lock:
            # fail the next N device steps (a huge N = hard outage)
            self.device_failures = 0
            self.device_exception: type | None = None
            self.device_latency_s = 0.0
            # fail the next N oracle-fallback batches (drives the
            # fail-open / fail-closed policy paths)
            self.oracle_failures = 0
            self.injected_device = 0
            self.injected_oracle = 0
            # the adapter seams of the executor's lanes, keyed by
            # qualified handler name: a sleep before every call, and
            # failing the next N calls
            self.adapter_latency_s: dict[str, float] = {}
            self.adapter_failures: dict[str, int] = {}
            # wedged handlers: their calls block until the event sets
            # (unwedge_adapter, or this reset, which releases every one)
            wedged = getattr(self, "_adapter_wedged", None)
            if wedged:
                for ev in wedged.values():
                    ev.set()
            self._adapter_wedged: dict[str, threading.Event] = {}
            self.injected_adapter = 0
            self.quota_latency_s: dict[str, float] = {}
            self.quota_failures: dict[str, int] = {}
            self.injected_quota = 0
            # a delay slept at the top of every discovery publish
            self.discovery_push_delay_s = 0.0
            self.injected_discovery = 0

    def device_step(self) -> None:
        """Called immediately before a real check device step."""
        lat = self.device_latency_s
        if lat:
            time.sleep(lat)
        if self.device_failures <= 0:
            return
        with self._lock:
            if self.device_failures <= 0:
                return
            self.device_failures -= 1
            self.injected_device += 1
        self._notify("device")
        exc = self.device_exception
        err = exc() if exc is not None else \
            RuntimeError("chaos: injected device-step failure")
        err.chaos_injected = True
        raise err

    def oracle_step(self) -> None:
        """Called before an oracle-fallback batch executes."""
        if self.oracle_failures <= 0:
            return
        with self._lock:
            if self.oracle_failures <= 0:
                return
            self.oracle_failures -= 1
            self.injected_oracle += 1
        self._notify("oracle")
        raise RuntimeError("chaos: injected oracle failure")

    def wedge_adapter(self, handler: str) -> None:
        """Every later call on `handler`'s lane blocks until
        unwedge_adapter(handler) or reset()."""
        with self._lock:
            self._adapter_wedged.setdefault(handler, threading.Event())
        # chaos arms are control-plane events too: an exemplar is
        # attributed to the wedge that caused it
        from istio_tpu_torch.runtime import forensics
        forensics.record_event("chaos_wedge", handler=handler)
        self._notify("wedge", handler=handler)

    def unwedge_adapter(self, handler: str) -> None:
        with self._lock:
            ev = self._adapter_wedged.pop(handler, None)
        if ev is not None:
            ev.set()
            from istio_tpu_torch.runtime import forensics
            forensics.record_event("chaos_unwedge", handler=handler)

    def adapter_call(self, handler: str) -> None:
        """Called by an executor lane's worker immediately before the
        adapter call: the wedge, the latency and the injected errors of
        `handler`."""
        ev = self._adapter_wedged.get(handler)
        if ev is not None:
            ev.wait()
        lat = self.adapter_latency_s.get(handler, 0.0)
        if lat:
            time.sleep(lat)
        if self.adapter_failures.get(handler, 0) <= 0:
            return
        with self._lock:
            n = self.adapter_failures.get(handler, 0)
            if n <= 0:
                return
            self.adapter_failures[handler] = n - 1
            self.injected_adapter += 1
        self._notify("adapter", handler=handler)
        raise RuntimeError(f"chaos: injected adapter failure ({handler})")

    def quota_call(self, name: str) -> None:
        """Called by MemQuotaHandler.handle_quota before the real cell
        allocation."""
        lat = self.quota_latency_s.get(name, 0.0)
        if lat:
            time.sleep(lat)
        if self.quota_failures.get(name, 0) <= 0:
            return
        with self._lock:
            n = self.quota_failures.get(name, 0)
            if n <= 0:
                return
            self.quota_failures[name] = n - 1
            self.injected_quota += 1
        self._notify("quota", handler=name)
        raise RuntimeError(
            f"chaos: injected quota-backend failure ({name})")

    def discovery_publish(self) -> None:
        """Called inside DiscoveryService.publish's lock, before the
        snapshot build: watchers stay parked on the old generation for
        the armed delay."""
        lat = self.discovery_push_delay_s
        if lat:
            time.sleep(lat)
            with self._lock:
                self.injected_discovery += 1
            self._notify("discovery")

    def armed(self) -> list[str]:
        """The names of the levers that would inject a fault or a delay
        now (empty when the seams are inert)."""
        levers = {"device_failures": self.device_failures,
                  "device_latency_s": self.device_latency_s,
                  "oracle_failures": self.oracle_failures,
                  "adapter_latency_s": any(self.adapter_latency_s.values()),
                  "adapter_failures": any(self.adapter_failures.values()),
                  "adapter_wedged": bool(self._adapter_wedged),
                  "quota_latency_s": any(self.quota_latency_s.values()),
                  "quota_failures": any(self.quota_failures.values()),
                  "discovery_push_delay_s": self.discovery_push_delay_s}
        return [k for k, v in levers.items() if v]

    def snapshot(self) -> dict:
        """The armed levers and the injections made since reset()."""
        return {
            "device_failures_pending": self.device_failures,
            "oracle_failures_pending": self.oracle_failures,
            "device_latency_s": self.device_latency_s,
            "injected_device": self.injected_device,
            "injected_oracle": self.injected_oracle,
            "adapter_wedged": sorted(self._adapter_wedged),
            "adapter_latency_s": dict(self.adapter_latency_s),
            "adapter_failures_pending": dict(self.adapter_failures),
            "injected_adapter": self.injected_adapter,
            "quota_latency_s": dict(self.quota_latency_s),
            "quota_failures_pending": dict(self.quota_failures),
            "injected_quota": self.injected_quota,
            "discovery_push_delay_s": self.discovery_push_delay_s,
            "injected_discovery": self.injected_discovery,
        }


# process-wide chaos seam: tests and chip_smoke arm it, serving code
# probes it
CHAOS = ChaosHooks()


def _takes_deadline(fn: Callable) -> bool:
    """Does `fn` accept a `deadline` keyword? Decided once at wiring
    time; unintrospectable callables answer False."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    if "deadline" in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def chaos_injected(exc: BaseException) -> bool:
    """Was `exc` raised by CHAOS's device seam?"""
    return getattr(exc, "chaos_injected", False)


class ResilientChecker:
    """Wraps the dispatcher's device check with retry, the circuit
    breaker, the CPU-oracle fallback and the fail policy. This is
    RuntimeServer._run_check_batch's implementation: every served
    Check() entry (the batcher, check_many) rides it.

    `strict_device`: only faults injected through CHAOS take that
    chain; any other device exception is raised to the caller with no
    retry, no breaker failure and no fallback (see the module
    docstring)."""

    def __init__(self, device: Callable[[Sequence[Any]], Sequence[Any]],
                 oracle: Callable[[Sequence[Any]], Sequence[Any]],
                 config: ResilienceConfig | None = None,
                 strict_device: bool = False,
                 name: str = "device"):
        self.device = device
        self.oracle = oracle
        self.strict_device = strict_device
        # a device callable that accepts it gets the batch's min row
        # deadline; plain (bags)-shaped callables keep working
        self._device_takes_deadline = _takes_deadline(device)
        self.config = config or ResilienceConfig()
        # the breaker's name in the log: "device" for the server's
        # checker, "bank:<k>" for a shard bank's (sharding/)
        self.breaker = CircuitBreaker(self.config.breaker_failures,
                                      self.config.breaker_reset_s,
                                      name=name)

    @staticmethod
    def _n_real(bags: Sequence[Any]) -> int:
        from istio_tpu_torch.runtime.batcher import trim_pads
        return len(trim_pads(list(bags)))

    def _device_call(self, bags: Sequence[Any],
                     deadline: float | None) -> Sequence[Any]:
        if self._device_takes_deadline:
            return self.device(bags, deadline=deadline)
        return self.device(bags)

    def _real_fault(self, exc: Exception) -> bool:
        """Is `exc` a strict checker's device fault that CHAOS did not
        inject? Logged here; run_batch re-raises it, never absorbs it."""
        if not self.strict_device or chaos_injected(exc):
            return False
        log.error("device check batch failed (%s: %s); a strict device "
                  "raises it: no retry, no oracle fallback",
                  type(exc).__name__, exc)
        return True

    def run_batch(self, bags: Sequence[Any],
                  deadline: float | None = None) -> Sequence[Any]:
        from istio_tpu_torch.runtime import monitor

        if not self.breaker.allow_device():
            return self._fallback(bags, "breaker_open")
        # every exit below leaves the breaker a verdict (success /
        # failure) or releases the probe slot: an unwound half-open
        # probe with no verdict would wedge the breaker in half_open
        recorded = False
        try:
            try:
                out = self._device_call(bags, deadline)
            except CheckRejected:
                raise           # typed rejections are answers, not faults
            except Exception as exc:
                if self._real_fault(exc):
                    raise
                first = exc
                if self.config.retry:
                    # one jittered retry absorbs a transient fault
                    # without involving the breaker
                    time.sleep(self.config.retry_backoff_s +
                               random.random() *
                               self.config.retry_jitter_s)
                    monitor.CHECK_DEVICE_RETRIES.inc()
                    try:
                        out = self._device_call(bags, deadline)
                    except CheckRejected:
                        raise
                    except Exception as exc2:
                        if self._real_fault(exc2):
                            raise
                        first = exc2
                    else:
                        self.breaker.record_success()
                        recorded = True
                        return out
                self.breaker.record_failure()
                recorded = True
                log.warning("device check batch failed (%s: %s); "
                            "serving via the CPU oracle path",
                            type(first).__name__, first)
                return self._fallback(bags, "device_error")
            self.breaker.record_success()
            recorded = True
            return out
        finally:
            if not recorded:
                self.breaker.release_probe()

    def _fallback(self, bags: Sequence[Any], reason: str) -> Sequence[Any]:
        from istio_tpu_torch.runtime import monitor

        n = self._n_real(bags)
        try:
            CHAOS.oracle_step()
            out = self.oracle(bags)
        except Exception as exc:
            if self.config.fail_policy == "open":
                # fail-open: a policy outage must not take the data
                # plane down — answer OK, with a 1 s / 1-use TTL so
                # sidecars re-check promptly instead of caching the
                # blanket allow
                from istio_tpu_torch.runtime.dispatcher import CheckResponse
                monitor.CHECK_FALLBACK.inc(n, reason="fail_open")
                log.error("oracle fallback failed (%s: %s); policy is "
                          "fail-open, answering OK",
                          type(exc).__name__, exc)
                return [CheckResponse(valid_duration_s=1.0,
                                      valid_use_count=1)
                        for _ in range(n)]
            raise UnavailableError(
                f"device and oracle check paths both failed "
                f"({type(exc).__name__}: {exc})") from exc
        monitor.CHECK_FALLBACK.inc(n, reason=reason)
        return out
