"""Live-traffic recorder: the canary's record stage.

Port of istio_tpu/canary/recorder.py. A lock-light sampling ring buffer
tapped at the dispatcher boundary (`Dispatcher._check_fused`, after the
response loop, on the padding-trimmed rows) — the batch whose verdict
the caller receives. Per batch the tap costs one stride-counter check,
and for SAMPLED rows only, a bounded tuple append under a short-held
lock. No device work, no bag decode, no encoding — compression to
`CompressedAttributes` (attribute/compressed.py) happens at corpus-build
time, which runs at config-swap time, never on the batch critical path.

Recorded per sample: the attribute bag (compressed at corpus build),
the device's decision (status, valid_duration/use_count, winning device
deny rule), the active quota rules, the namespace and the batch's trace
id, so a canary exemplar names the trace it was served in.
"""
from __future__ import annotations

import base64
import dataclasses
import datetime
import json
import threading
import time
from typing import Any, Sequence

from istio_tpu_torch.attribute.compressed import (CompressedAttributes,
                                                  decode, encode)


@dataclasses.dataclass
class CanaryEntry:
    """One replayable recorded request: compressed attribute bag +
    the decision the live plan served for it."""
    ca: CompressedAttributes
    status: int = 0
    valid_duration_s: float = 5.0
    valid_use_count: int = 10_000
    deny_rule: str = ""            # qualified rule name; "" = no deny
    namespace: str = ""
    quota_rules: tuple = ()        # qualified QUOTA-rule names active
    trace_id: str | None = None
    t: float = 0.0

    def bag(self):
        """Decode the compressed bag for replay / oracle runs."""
        return decode(self.ca)


class TrafficRecorder:
    """Bounded sampling ring over live Check() traffic.

    `sample_every=k` keeps every k-th request (stride over a global
    counter, so sampling is uniform across batches); `capacity` bounds
    memory — the ring overwrites oldest. The raw ring holds bag REFS
    plus already-decoded decision scalars; `corpus()` materializes
    immutable `CanaryEntry` records (bags compressed) off the hot
    path. Rows keep a reference to the snapshot that served them so
    rule indices resolve to names even across config swaps."""

    def __init__(self, capacity: int = 2048, sample_every: int = 1):
        self.capacity = max(int(capacity), 1)
        self.sample_every = max(int(sample_every), 1)
        self._lock = threading.Lock()
        self._ring: list[tuple] = []
        self._w = 0                     # oldest slot once the ring fills
        self._counter = 0               # global request stride counter
        self._sampled = 0
        self._evicted = 0
        self._encode_errors = 0
        self._identity_attr = "destination.service"
        # CheckResponse's TTL/use-count field defaults — the caps the
        # dispatcher min-folds device planes under; resolved lazily
        # (import cost off __init__) so recorded rows clamp EXACTLY
        # like replayed responses even if the defaults are retuned
        self._resp_caps: tuple | None = None

    # ------------------------------------------------------------------
    # hot path
    # ------------------------------------------------------------------

    def tap(self, bags: Sequence, responses: Sequence, snapshot: Any,
            identity_attr: str, span: Any = None,
            device: tuple | None = None) -> None:
        """Record one served batch's sampled rows. `bags`/`responses`
        are the dispatcher's real (padding-trimmed) rows; `span` is the
        batch's active trace span dict (or None). `device` is the
        fused path's (status, valid_duration_s, valid_use_count,
        deny_rule) decoded packed rows: when present, the DEVICE
        surface is recorded instead of the final merged response —
        host-overlay adapter statuses are invisible to the shadow
        replay (it runs with empty handlers, side effects must not
        fire), so recording them would make an UNCHANGED config with a
        host-overlay deny look permanently divergent. Dispatch-side
        cost: a stride check per batch plus a tuple append per SAMPLED
        row — the counter increment races benignly under concurrent
        batch workers (sampling is a sample, not an exact stride)."""
        n = len(bags)
        if not n:
            return
        self._identity_attr = identity_attr
        stride = self.sample_every
        base = self._counter
        self._counter = base + n
        first = (-base) % stride
        if first >= n:
            return
        # only the index→name list is kept per row (memoized on the
        # snapshot) — holding the snapshot itself would pin superseded
        # config generations in memory for the life of the ring
        names = snapshot.qualified_rule_names() \
            if snapshot is not None else []
        tid = span.get("traceId") if span else None
        now = time.time()
        rows = []
        if device is not None:
            if self._resp_caps is None:
                from istio_tpu_torch.runtime.dispatcher import CheckResponse
                blank = CheckResponse()
                self._resp_caps = (blank.valid_duration_s,
                                   blank.valid_use_count)
            dur_cap, uses_cap = self._resp_caps
            dstat, ddur, duses, ddeny = device
            for i in range(first, n, stride):
                st = int(dstat[i])
                rows.append((bags[i], st,
                             min(dur_cap, float(ddur[i])),
                             min(uses_cap, int(duses[i])),
                             int(ddeny[i]) if st else -1,
                             responses[i].active_quota_rules,
                             names, tid, now))
        else:
            for i in range(first, n, stride):
                resp = responses[i]
                rows.append((bags[i], resp.status_code,
                             resp.valid_duration_s,
                             resp.valid_use_count,
                             getattr(resp, "deny_rule", -1),
                             resp.active_quota_rules, names, tid, now))
        with self._lock:
            for row in rows:
                if len(self._ring) < self.capacity:
                    self._ring.append(row)
                else:
                    self._ring[self._w] = row
                    self._w = (self._w + 1) % self.capacity
                    self._evicted += 1
            self._sampled += len(rows)

    # ------------------------------------------------------------------
    # corpus build (config-swap time — NOT hot)
    # ------------------------------------------------------------------

    def _snapshot_rows(self) -> list[tuple]:
        with self._lock:
            if len(self._ring) < self.capacity:
                return list(self._ring)
            return self._ring[self._w:] + self._ring[:self._w]

    def corpus(self, limit: int | None = None) -> list[CanaryEntry]:
        """Materialize the ring (oldest→newest, newest kept under
        `limit`) as immutable replayable entries: bags compressed via
        the rulestats exemplar codec, rule indices resolved to
        qualified names against the snapshot that served each row."""
        from istio_tpu_torch.runtime.dispatcher import _namespace_of

        rows = self._snapshot_rows()
        if limit is not None and len(rows) > limit:
            rows = rows[-limit:]
        out: list[CanaryEntry] = []
        for (bag, status, dur, uses, deny_rule, quota_rules, names,
             tid, t) in rows:
            try:
                ca = encode(bag)
            except Exception:
                self._encode_errors += 1
                continue
            deny_name = names[deny_rule] \
                if 0 <= deny_rule < len(names) else ""
            qnames = tuple(names[r] for r in (quota_rules or ())
                           if 0 <= r < len(names))
            out.append(CanaryEntry(
                ca=ca, status=int(status),
                valid_duration_s=float(dur),
                valid_use_count=int(uses), deny_rule=deny_name,
                namespace=_namespace_of(bag, self._identity_attr),
                quota_rules=qnames, trace_id=tid, t=t))
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._w = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "sample_every": self.sample_every,
                "entries": len(self._ring),
                "seen": self._counter,
                "sampled": self._sampled,
                "evicted": self._evicted,
                "encode_errors": self._encode_errors,
            }


# ---------------------------------------------------------------------------
# corpus file codec — offline replay; a file saved by either package loads
# in the other
# ---------------------------------------------------------------------------

def _ca_to_json(ca: CompressedAttributes) -> dict:
    return {
        "words": list(ca.words),
        "strings": {str(k): v for k, v in ca.strings.items()},
        "int64s": {str(k): v for k, v in ca.int64s.items()},
        "doubles": {str(k): v for k, v in ca.doubles.items()},
        "bools": {str(k): v for k, v in ca.bools.items()},
        "timestamps": {str(k): v.isoformat()
                       for k, v in ca.timestamps.items()},
        "durations": {str(k): v.total_seconds()
                      for k, v in ca.durations.items()},
        "bytes": {str(k): base64.b64encode(v).decode("ascii")
                  for k, v in ca.bytes_.items()},
        "string_maps": {str(k): {str(mk): mv for mk, mv in m.items()}
                        for k, m in ca.string_maps.items()},
    }


def _ca_from_json(d: dict) -> CompressedAttributes:
    return CompressedAttributes(
        words=list(d.get("words") or ()),
        strings={int(k): int(v)
                 for k, v in (d.get("strings") or {}).items()},
        int64s={int(k): int(v)
                for k, v in (d.get("int64s") or {}).items()},
        doubles={int(k): float(v)
                 for k, v in (d.get("doubles") or {}).items()},
        bools={int(k): bool(v)
               for k, v in (d.get("bools") or {}).items()},
        timestamps={int(k): datetime.datetime.fromisoformat(v)
                    for k, v in (d.get("timestamps") or {}).items()},
        durations={int(k): datetime.timedelta(seconds=float(v))
                   for k, v in (d.get("durations") or {}).items()},
        bytes_={int(k): base64.b64decode(v)
                for k, v in (d.get("bytes") or {}).items()},
        string_maps={int(k): {int(mk): int(mv)
                              for mk, mv in m.items()}
                     for k, m in (d.get("string_maps") or {}).items()})


def entry_to_json(e: CanaryEntry) -> dict:
    return {
        "ca": _ca_to_json(e.ca),
        "status": e.status,
        "valid_duration_s": e.valid_duration_s,
        "valid_use_count": e.valid_use_count,
        "deny_rule": e.deny_rule,
        "namespace": e.namespace,
        "quota_rules": list(e.quota_rules),
        "trace_id": e.trace_id,
        "t": e.t,
    }


def entry_from_json(d: dict) -> CanaryEntry:
    return CanaryEntry(
        ca=_ca_from_json(d.get("ca") or {}),
        status=int(d.get("status", 0)),
        valid_duration_s=float(d.get("valid_duration_s", 5.0)),
        valid_use_count=int(d.get("valid_use_count", 10_000)),
        deny_rule=str(d.get("deny_rule", "")),
        namespace=str(d.get("namespace", "")),
        quota_rules=tuple(d.get("quota_rules") or ()),
        trace_id=d.get("trace_id"),
        t=float(d.get("t", 0.0)))


def save_corpus(path: str, entries: Sequence[CanaryEntry]) -> int:
    """Write a replayable corpus file (JSON; versioned)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1,
                   "entries": [entry_to_json(e) for e in entries]}, f)
    return len(entries)


def load_corpus(path: str) -> list[CanaryEntry]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if int(doc.get("version", 0)) != 1:
        raise ValueError(f"unsupported corpus version "
                         f"{doc.get('version')!r}")
    return [entry_from_json(d) for d in doc.get("entries") or ()]
