"""Typed check rejections, the chaos seams and deadline plumbing.

Port of the part of istio_tpu/runtime/resilience.py that the served
check path calls: the typed `CheckRejected` errors the batcher
resolves futures with, the process-wide `CHAOS` fault-injection seams
at the device step (FusedPlan.packed_check) and the quota backend
(memquota), the discovery publish seam (`discovery_publish`), and
`_takes_deadline`. The circuit breaker with its CPU-oracle fallback
(`ResilientChecker`) is not carried: the port's RuntimeServer calls the
dispatcher directly (ROADMAP.md).
"""
from __future__ import annotations

import inspect
import threading
import time
from typing import Callable

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


class ChaosHooks:
    """Fault-injection seams: tests arm them, serving code probes them.
    Inert fields cost one attribute read per probe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # fail the next N device steps (a huge N = hard outage)
            self.device_failures = 0
            self.device_exception: type | None = None
            self.device_latency_s = 0.0
            self.injected_device = 0
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
        exc = self.device_exception
        raise exc() if exc is not None else \
            RuntimeError("chaos: injected device-step failure")

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
