"""Server-issued check-cache grants: TTL and use count from config
volatility.

Port of istio_tpu/runtime/grants.py. The Mixer client's check cache
reuses a verdict until the response's `valid_duration` /
`valid_use_count` budget is spent, so the server decides how much repeat
traffic never crosses the wire. The grant follows the age of the
namespace's config generation: a namespace whose rules just changed gets
the TTL floor (outstanding client caches go stale within one generation:
the revocation leg), and the grant ramps back toward the cap as the
namespace proves stable. Deny rules' own TTLs still apply (the
dispatcher folds with min()), so a grant only ever shortens a verdict's
cache budget.

Applied at the dispatcher's respond stage to every response, allow and
deny alike. Opt-in through ServerArgs.check_grants: the emitted TTL then
depends on the wall time since a publish.

The clock is `time.monotonic()`, read on the module-level `time`. The
reference also writes every revocation into the mesh event ring
(`record_event("grant_revoke")`); runtime/forensics.py is not ported, so
that is left out. Its identity axis (`on_identity_rotate`,
`identity_grant`) serves the mTLS fronts, which are not ported either.
"""
from __future__ import annotations

import threading
import time

__all__ = ["GrantPolicy"]

# the use-count grant: floor, cap and ramp per second of age
USE_FLOOR = 64
USE_CAP = 10_000
USE_RAMP_PER_S = 1024.0


class GrantPolicy:
    """(ttl_s, use_count) per namespace from generation age:

    ttl(ns)  = min(cap,  floor  + age_s * ttl_ramp_per_s)
    uses(ns) = min(USE_CAP, USE_FLOOR + age_s * USE_RAMP_PER_S)

    age_s is the seconds since the last publish that changed `ns` (or
    any publish, when the changed set is unknown). The defaults keep a
    long-stable config at the pre-grant values (5 s / 10,000)."""

    def __init__(self, ttl_floor_s: float = 1.0,
                 ttl_cap_s: float = 5.0,
                 ttl_ramp_per_s: float = 0.5,
                 quantum_s: float = 0.5):
        if ttl_floor_s <= 0 or ttl_cap_s < ttl_floor_s:
            raise ValueError(
                f"need 0 < ttl_floor_s <= ttl_cap_s, got "
                f"{ttl_floor_s}/{ttl_cap_s}")
        self.ttl_floor_s = float(ttl_floor_s)
        self.ttl_cap_s = float(ttl_cap_s)
        self.ttl_ramp_per_s = float(ttl_ramp_per_s)
        # ages are quantized, so grants step at most once a quantum
        # (a continuously varying TTL would make every parity
        # comparison depend on the clock)
        self.quantum_s = max(float(quantum_s), 0.0)
        self._lock = threading.Lock()
        now = time.monotonic()
        # the last change instant: per namespace when a publish names
        # its changed set, and the global one every namespace inherits
        self._global_change = now
        self._ns_change: dict[str, float] = {}
        self.generation = 0
        self._grants_issued = 0
        self._revocations = 0
        # the generation current when the latest grant was issued
        self._issued_at_generation = 0

    # -- publish side ----------------------------------------------------

    def on_publish(self, changed_namespaces=None) -> None:
        """A config generation published. `changed_namespaces`: the
        namespaces the publish changed (only those drop to the floor);
        None = unknown, every namespace revokes."""
        now = time.monotonic()
        with self._lock:
            self.generation += 1
            self._revocations += 1
            if changed_namespaces is None:
                self._global_change = now
                self._ns_change.clear()
            else:
                for ns in list(changed_namespaces):
                    self._ns_change[ns] = now

    # -- serve side ------------------------------------------------------

    def _quantize(self, age: float) -> float:
        if self.quantum_s <= 0:
            return age
        return (age // self.quantum_s) * self.quantum_s

    def _pair(self, age: float) -> tuple[float, int]:
        age = self._quantize(age)
        return (min(self.ttl_cap_s,
                    self.ttl_floor_s + age * self.ttl_ramp_per_s),
                min(USE_CAP, USE_FLOOR + int(age * USE_RAMP_PER_S)))

    def grant(self, ns: str) -> tuple[float, int]:
        """(ttl_s, use_count) for one namespace, now."""
        now = time.monotonic()
        with self._lock:
            changed = self._ns_change.get(ns, self._global_change)
            age = max(now - max(changed, self._global_change), 0.0)
            self._grants_issued += 1
            self._issued_at_generation = self.generation
        return self._pair(age)

    def grants_for(self, ns_names) -> list[tuple[float, int]]:
        """grant() for a batch's distinct namespaces: one clock read and
        one lock round."""
        now = time.monotonic()
        out = []
        with self._lock:
            for ns in ns_names:
                changed = self._ns_change.get(ns, self._global_change)
                age = max(now - max(changed, self._global_change), 0.0)
                out.append(self._pair(age))
            self._grants_issued += len(out)
            if out:
                self._issued_at_generation = self.generation
        return out

    def watermark(self) -> dict:
        """Grant / generation coherence: one lock round, no TTL math."""
        with self._lock:
            return {
                "generation": self.generation,
                "revocations": self._revocations,
                "grants_issued": self._grants_issued,
                "issued_at_generation": self._issued_at_generation,
            }

    def stats(self) -> dict:
        """The parameters and the live per-namespace ages."""
        now = time.monotonic()
        with self._lock:
            ages = {ns: round(now - t, 3)
                    for ns, t in sorted(self._ns_change.items())[:32]}
            return {
                "generation": self.generation,
                "ttl_floor_s": self.ttl_floor_s,
                "ttl_cap_s": self.ttl_cap_s,
                "ttl_ramp_per_s": self.ttl_ramp_per_s,
                "use_floor": USE_FLOOR,
                "use_cap": USE_CAP,
                "global_age_s": round(now - self._global_change, 3),
                "ns_ages_s": ages,
                "grants_issued": self._grants_issued,
                "revocations": self._revocations,
            }
