"""Device-backed quota pools for the serving path.

Port of istio_tpu/runtime/device_quota.py (reference flow:
mixer/pkg/api/grpcServer.go:188-230 — after a successful precondition
Check, the server dispatches each of the request's quotas to its one
matching quota action):

  host dedup-replay cache  (memquota.go:259 buildWithDedup semantics)
        │ miss
  exact dims→bucket keymap (each distinct instance key gets its own
        │                   counter row — no hash collisions)
  batched device alloc     (models/quota_alloc.py: the quota_alloc kernel,
                            one launch per batch window)

Rule matching reuses the CHECK step's activity bits
(CheckResponse.active_quota_rules). Counters are per-(bucket, tick-slot)
planes int32 [n_buckets, K] resident on the card; each flush rolls the
touched buckets before allocating, exactly like adapters/memquota._Window
(the reference's rollingWindow quantized to _TICKS_PER_WINDOW slots per
window). Exact counters (duration 0) live in slot 0 of the same plane.
Pools are reused across config generations while the handler signature
is unchanged.

Counter ownership. Every trip allocates OUT OF PLACE: the alloc clones
the plane (5.24 MB at 131,072 × 10) and the kernel updates the clone, so
the pool keeps the reference's functional handles — `counts` is the
newest plane, `_counts_good` the one the last committed in-step trip
produced, and an in-step trip whose pull fails restores it
(InlineQuotaSession.abort) unless a later trip already chained past it.
As in the reference, a classic flush does not move `_counts_good`. The pool worker's flushes
and the check path's in-step trips launch from different threads, on
ONE stream: neither sets a stream, so both launch on the device's
default stream, in the order `_counts_lock` admits them — a trip that
chains on a predecessor's plane runs after it on the card.

Every flush records a `quota_flush` event (items, coalesced over
0.25 s) on the forensics event timeline (runtime/forensics.py).

`audit_view` is the mesh audit plane's read of the newest plane
(runtime/audit.py, from its own thread). A plane's producer may still
run on the card when the auditor reads it, and since the sharded plane's
lanes an in-step trip may run on a lane's own stream: so each plane
keeps the stream that produced it (`_counts_stream`), and the pull runs
on a private stream of the auditor's that first waits for the work
enqueued on that stream so far. No serving stream ever waits on the
audit read.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from istio_tpu_torch.adapters.memquota import _TICKS_PER_WINDOW
from istio_tpu_torch.adapters.memquota import _key as dims_key
from istio_tpu_torch.adapters.sdk import QuotaArgs, QuotaResult
from istio_tpu_torch.device import resolve_device
from istio_tpu_torch.models.policy_engine import RESOURCE_EXHAUSTED
from istio_tpu_torch.models.quota_alloc import make_rolling_alloc_step
from istio_tpu_torch.runtime import forensics
from istio_tpu_torch.utils.log import scope

log = scope("runtime.device_quota")

DEFAULT_BUCKETS = 131_072    # BASELINE config 4: 100k-key counter eval

# the per-row alloc inputs, in the order of one staged int32 block (one
# host→device copy per trip; flags as 0/1)
ROW_FIELDS = ("buckets", "amounts", "be", "mx", "active", "ticks", "lasts",
              "rolling")


class DeviceQuotaPool:
    """Counters for every quota name of ONE memquota handler config.

    Bucket space is shared: each distinct (name, dimensions) instance
    key gets the next free row, so 100k live keys need ~100k rows
    regardless of how many quota names the handler defines."""

    def __init__(self, quotas: Mapping[str, Mapping[str, Any]],
                 n_buckets: int = DEFAULT_BUCKETS,
                 min_dedup_s: float = 1.0,
                 # a wide window: every flush is a device trip, and a
                 # +10ms on a quota grant is noise next to it
                 batch_window_s: float = 0.010,
                 max_batch: int = 512,
                 clock: Callable[[], float] = time.monotonic,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.limits = {str(n): {"max": int(q.get("max_amount", 0)),
                                "duration": float(
                                    q.get("valid_duration_s", 0.0))}
                       for n, q in quotas.items()}
        self.n_buckets = n_buckets
        self.min_dedup_s = min_dedup_s
        self._clock = clock
        self._lock = threading.Lock()
        self._bucket_of: dict[str, int] = {}
        self._dedup: dict[str, tuple[int, float]] = {}
        # rolling-window bookkeeping (host side): tick length per bucket
        # (0 = exact cell), the last tick each bucket rolled to
        # (absolute), and a per-bucket tick base so device ticks stay
        # small rebased int32s while HOST tick boundaries (floor of
        # absolute now / tick_len) match adapters/memquota._Window
        self.k_ticks = _TICKS_PER_WINDOW
        self._tick_len: np.ndarray = np.zeros(n_buckets, np.float64)
        self._last_tick: np.ndarray = np.zeros(n_buckets, np.int64)
        self._tick_base: np.ndarray = np.zeros(n_buckets, np.int64)
        self.counts = torch.zeros((n_buckets, self.k_ticks),
                                  dtype=torch.int32, device=self.device)
        # scan is the sequential parity oracle; the serving path only
        # ever selects fast / unit / seg
        (self._alloc_scan, self._alloc_fast, self._alloc_unit,
         self._alloc_seg) = make_rolling_alloc_step(n_buckets, self.k_ticks)
        # pending batched allocations: [(bucket, amount, best_effort,
        # max, duration, dedup id, future)]
        self._pending: list = []
        self._window_s = batch_window_s
        self._max_batch = max_batch
        self._small_batch = min(64, max_batch)
        self._wake = threading.Condition(self._lock)
        self._closed = False
        # counter-plane ownership token: `counts` is advanced by the
        # worker's flush AND by in-step sessions, which hold it from
        # stage to DISPATCH only. Lock order: ALWAYS _counts_lock then
        # self._lock (inline_begin and _flush both) — taking self._lock
        # first would deadlock against them.
        self._counts_lock = threading.Lock()
        # in-step commit ordering: bookkeeping applies in DISPATCH order
        # even though pulls race — sessions take numbered turns
        self._seq_next = 0
        self._commit_cv = threading.Condition(threading.Lock())
        self._commit_turn = 0
        # dedup ids consumed by a dispatched-but-uncommitted session: a
        # same-id row staged meanwhile must not re-consume
        self._dedup_pending: dict[str, int] = {}
        # dedup ids whose consuming session committed GATE-OFF (granted
        # freely, nothing consumed): id → expiry
        self._dedup_free: dict[str, float] = {}
        # last known-good counter plane (restore target when a
        # dispatched trip's pull fails)
        self._counts_good = self.counts
        # build the kernel and run every serving variant at both pad
        # shapes once before the worker starts: the first flush must not
        # pay nvcc behind its futures
        self._prewarm()
        # the stream that produced `counts`, and the audit pull's own
        self._counts_stream = self._producer_stream()
        self._audit_stream = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="device-quota")
        self._thread.start()

    # -- public ---------------------------------------------------------

    def knows(self, name: str) -> bool:
        return name in self.limits

    def alloc(self, name: str, instance: Mapping[str, Any],
              args: QuotaArgs) -> "QuotaFuture":
        """Non-blocking; returns a future resolving to QuotaResult."""
        fut = QuotaFuture()
        lim = self.limits.get(name)
        if lim is None:
            fut.set(QuotaResult(granted_amount=0,
                                status_code=RESOURCE_EXHAUSTED,
                                status_message=f"unknown quota {name}"))
            return fut
        now = self._clock()
        with self._lock:
            self._gc_dedup(now)
            if args.dedup_id:
                hit = self._dedup.get(args.dedup_id)
                if hit is not None and hit[1] > now:
                    status = 0 if hit[0] > 0 or args.quota_amount == 0 \
                        else RESOURCE_EXHAUSTED
                    fut.set(QuotaResult(granted_amount=hit[0],
                                        valid_duration_s=lim["duration"],
                                        status_code=status))
                    return fut
                free_exp = self._dedup_free.get(args.dedup_id)
                if free_exp is not None and free_exp > now:
                    # first transmission committed gate-off: replay it
                    fut.set(QuotaResult(
                        granted_amount=args.quota_amount))
                    return fut
            if self._closed:   # post-swap drain raced the caller
                fut.set(QuotaResult(
                    granted_amount=0, status_code=14,  # UNAVAILABLE
                    status_message="quota pool closed by config swap"))
                return fut
            bucket = self._bucket_for(dims_key(instance), lim, now)
            if bucket < 0:   # keyspace exhausted: fail closed
                fut.set(QuotaResult(
                    granted_amount=0, status_code=RESOURCE_EXHAUSTED,
                    status_message="quota keyspace exhausted"))
                return fut
            self._pending.append((bucket, int(args.quota_amount),
                                  bool(args.best_effort), lim["max"],
                                  lim["duration"], args.dedup_id, fut))
            # wake on the empty→non-empty edge and on a full batch
            if len(self._pending) == 1 \
                    or len(self._pending) >= self._max_batch:
                self._wake.notify()
        return fut

    def inline_begin(self, n: int, rows: list, now: float
                     ) -> "InlineQuotaSession | None":
        """Stage in-step quota rows for ONE check trip (the alloc rides
        the check trip — FusedPlan.packed_check_instep).

        `rows`: [(slot, name, instance, args)], slot < n indexing the
        check batch row (at most one quota per row). Returns a session
        HOLDING the pool's counter token until dispatch/abort, or None
        when the pool is closed. Rows resolved without the trip — dedup
        replays, unknown quota names, keyspace exhaustion — land in
        session.early and stay inactive; in-batch duplicate dedup ids
        replay the first row's outcome at commit."""
        self._counts_lock.acquire()
        sess = InlineQuotaSession(self, n)
        try:
            with self._lock:
                if self._closed:
                    self._counts_lock.release()
                    return None
                sess.seq = self._seq_next
                self._seq_next += 1
                sess.prev_counts = self.counts
                self._gc_dedup(now)
                first_of: dict[str, int] = {}
                for slot, name, instance, args in rows:
                    lim = self.limits.get(name)
                    if lim is None:
                        sess.early[slot] = QuotaResult(
                            granted_amount=0,
                            status_code=RESOURCE_EXHAUSTED,
                            status_message=f"unknown quota {name}")
                        continue
                    did = args.dedup_id
                    if did:
                        hit = self._dedup.get(did)
                        if hit is not None and hit[1] > now:
                            status = 0 if hit[0] > 0 or \
                                args.quota_amount == 0 \
                                else RESOURCE_EXHAUSTED
                            sess.early[slot] = QuotaResult(
                                granted_amount=hit[0],
                                valid_duration_s=lim["duration"],
                                status_code=status)
                            continue
                        free_exp = self._dedup_free.get(did)
                        if free_exp is not None and free_exp > now:
                            sess.early[slot] = QuotaResult(
                                granted_amount=int(args.quota_amount))
                            continue
                        if did in first_of:
                            sess.replay_of[slot] = (first_of[did],
                                                    lim["duration"])
                            continue
                        if did in self._dedup_pending:
                            # consumed by a dispatched-but-uncommitted
                            # session: resolve from the cache at OUR
                            # (later) commit turn — never re-consume
                            sess.pending_replay[slot] = \
                                (did, lim["duration"],
                                 int(args.quota_amount))
                            continue
                    bucket = self._bucket_for(dims_key(instance), lim, now)
                    if bucket < 0:
                        sess.early[slot] = QuotaResult(
                            granted_amount=0,
                            status_code=RESOURCE_EXHAUSTED,
                            status_message="quota keyspace exhausted")
                        continue
                    if did:
                        first_of[did] = slot
                        self._dedup_pending[did] = sess.seq
                    sess.stage(slot, bucket, args, lim, did, now)
            sess.now = now
            return sess
        except BaseException:
            self._counts_lock.release()
            if sess.seq >= 0:   # consume the turn or later sessions wedge
                sess._take_turn()
                sess._end_turn()
            raise

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._wake.notify()
        self._thread.join(timeout=5)
        # the worker flushes pending work before exiting; anything still
        # queued (worker died) must not hang callers
        with self._lock:
            leftovers, self._pending = self._pending, []
        for *_x, fut in leftovers:
            fut.set(QuotaResult(granted_amount=0, status_code=14,
                                status_message="quota pool closed"))

    def audit_view(self) -> dict:
        """Counter-plane read-out for the mesh audit plane. Takes the
        current plane and its producing stream under the locks, in the
        _counts_lock → _lock order, and pulls outside both: planes are
        never mutated once published (each trip allocates into a clone),
        so a slow pull only delays this reader. On the card the pull is
        a copy on the auditor's own stream, ordered after the work
        enqueued on the producing stream."""
        with self._counts_lock:
            with self._lock:
                handle, stream = self.counts, self._counts_stream
                n_used = len(self._bucket_of)
        if handle.is_cuda:
            if self._audit_stream is None:
                self._audit_stream = torch.cuda.Stream(device=handle.device)
            with torch.cuda.stream(self._audit_stream):
                self._audit_stream.wait_stream(stream)
                arr = handle.cpu().numpy()
        else:
            arr = handle.cpu().numpy()
        max_limit = max((lim["max"] for lim in self.limits.values()),
                        default=0)
        used = arr[:n_used]
        beyond = arr[n_used:]
        return {
            "n_buckets": self.n_buckets,
            "n_used": n_used,
            "max_limit": int(max_limit),
            "negative_cells": int((arr < 0).sum()),
            "max_cell": int(used.max()) if used.size else 0,
            "over_cap_cells": int((used > max_limit).sum())
            if used.size else 0,
            "nonzero_beyond_keymap": int((beyond != 0).sum()),
        }

    # -- internals ------------------------------------------------------

    def _producer_stream(self):
        """The current stream, which the launch that just produced the
        newest plane ran on (None off the card). Called where the plane
        is published, with _counts_lock held."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.current_stream(self.device)

    def _stage(self, rows: np.ndarray) -> list[torch.Tensor]:
        """One host→device copy of the staged int32 block [8, n] → the
        per-field row tensors on the pool's device."""
        block = torch.from_numpy(rows).to(self.device)
        return [block[i] for i in range(len(ROW_FIELDS))]

    def _prewarm(self) -> None:
        # every variant the serving path can hit; the scan oracle never
        # serves. An all-inactive batch grants nothing.
        for pn in sorted({self._small_batch, self._max_batch}):
            rows = self._stage(np.zeros((len(ROW_FIELDS), pn), np.int32))
            for fn in (self._alloc_seg, self._alloc_fast, self._alloc_unit):
                _, self.counts = fn(self.counts, *rows)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket_for(self, key: str, lim: Mapping[str, Any],
                    now: float) -> int:
        b = self._bucket_of.get(key)
        if b is None:
            if len(self._bucket_of) >= self.n_buckets:
                return -1
            b = len(self._bucket_of)
            self._bucket_of[key] = b
            dur = lim["duration"]
            if dur > 0:
                tl = dur / self.k_ticks    # _Window.tick_len parity
                tick0 = int(now / tl)
                self._tick_len[b] = tl
                self._tick_base[b] = tick0
                self._last_tick[b] = tick0
        return b

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._wake.wait(timeout=0.1)
                if self._closed and not self._pending:
                    return
                # the batch window is a transport concern — wall clock;
                # the injectable self._clock is quota semantics (ticks,
                # dedup expiry)
                deadline = time.monotonic() + self._window_s
                while (len(self._pending) < self._max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(timeout=remaining)
                batch = self._pending[:self._max_batch]
                del self._pending[:len(batch)]
            if batch:
                try:
                    self._flush(batch)
                except Exception as exc:   # pragma: no cover
                    log.exception("quota flush failed")
                    for *_x, fut in batch:
                        fut.set(QuotaResult(
                            granted_amount=0, status_code=13,
                            status_message=f"quota alloc failed: {exc}"))

    def _flush(self, batch: list) -> None:
        now = self._clock()
        # the mesh event timeline: a flush trip is a control-plane event
        # a concurrent request's tail can ride behind; coalesced, so a
        # quota-heavy window is one ring entry
        forensics.record_event("quota_flush", coalesce_s=0.25,
                               items=len(batch))
        # dedup WITHIN the window too: a retransmission can land in the
        # same batch as its original, before the cache is written —
        # memquota's mutex serializes those, replaying the first outcome
        # without consuming (buildWithDedup :259)
        first_of: dict[str, int] = {}
        replay_items: list[tuple[Any, int]] = []   # (item, kept index)
        cache_replays: list = []   # (item, cached granted)
        free_replays: list = []    # gate-off outcome: grant freely
        deferred: list = []   # dedup id held by an uncommitted session
        kept: list = []
        with self._lock:
            for item in batch:
                dedup_id = item[5]
                if dedup_id:
                    # re-check under the lock: a retransmission that
                    # raced the original's flush must replay
                    hit = self._dedup.get(dedup_id)
                    if hit is not None and hit[1] > now:
                        cache_replays.append((item, hit[0]))
                        continue
                    free_exp = self._dedup_free.get(dedup_id)
                    if free_exp is not None and free_exp > now:
                        free_replays.append(item)
                        continue
                    if dedup_id in self._dedup_pending:
                        # held by a dispatched-but-uncommitted in-step
                        # session: defer past its commit
                        deferred.append(item)
                        continue
                    if dedup_id in first_of:
                        replay_items.append((item, first_of[dedup_id]))
                        continue
                    first_of[dedup_id] = len(kept)
                kept.append(item)
        for (_, amount, _, _, duration, _, fut), g in cache_replays:
            status = 0 if g > 0 or amount == 0 else RESOURCE_EXHAUSTED
            fut.set(QuotaResult(granted_amount=g,
                                valid_duration_s=duration,
                                status_code=status))
        for (_, amount, *_rest, fut) in free_replays:
            fut.set(QuotaResult(granted_amount=amount))
        batch = kept
        if not batch:
            self._requeue_deferred(deferred)
            return
        n = len(batch)
        # two pad shapes, as the reference (there to bound XLA compiles;
        # here it keeps the flush's launch shapes the prewarmed ones)
        pn = self._small_batch if n <= self._small_batch \
            else self._max_batch
        rows = np.zeros((len(ROW_FIELDS), pn), np.int32)
        buckets, amounts, be, mx, active, ticks, lasts, rolling = rows
        # The tick/last staging and the roll MUST happen under _lock
        # INSIDE the _counts_lock section, ordered exactly like
        # InlineQuotaSession.stage: _last_tick is shared with in-step
        # sessions. The update is OPTIMISTIC: the dispatched launch rolls
        # every active row's bucket unconditionally, so host _last_tick
        # and the device slots agree for whatever trip chains next.
        with self._counts_lock:
            with self._lock:
                for i, (b_, a_, e_, m_, *_rest) in enumerate(batch):
                    buckets[i], amounts[i], be[i], mx[i] = b_, a_, e_, m_
                    active[i] = 1
                    tl = self._tick_len[b_]
                    if tl > 0:
                        # absolute tick boundary = host adapter's
                        # _Window; the device gets REBASED int32s
                        abs_tick = int(now / tl)
                        base = int(self._tick_base[b_])
                        ticks[i] = abs_tick - base
                        lasts[i] = int(self._last_tick[b_]) - base
                        rolling[i] = 1
                        self._last_tick[b_] = abs_tick
            # sequential-within-batch semantics only matter when a
            # bucket repeats: all-ones amounts take the rank kernel,
            # other contended batches the segmented one (ao before be,
            # amount ascending). The scan never serves.
            if len(np.unique(buckets[:n])) < n:
                alloc = self._alloc_unit if bool((amounts[:n] == 1).all()) \
                    else self._alloc_seg
            else:
                alloc = self._alloc_fast
            granted, self.counts = alloc(self.counts, *self._stage(rows))
            self._counts_stream = self._producer_stream()
            granted = granted.cpu().numpy()   # the worker's one pull
        with self._lock:
            for i, (_, amount, _, _, duration, dedup_id, fut) \
                    in enumerate(batch):
                g = int(granted[i])
                if dedup_id:
                    expiry = now + max(duration, self.min_dedup_s)
                    self._dedup[dedup_id] = (g, expiry)
                status = 0 if g > 0 or amount == 0 \
                    else RESOURCE_EXHAUSTED
                fut.set(QuotaResult(granted_amount=g,
                                    valid_duration_s=duration,
                                    status_code=status))
        for (_, amount, _, _, duration, _, fut), k in replay_items:
            g = int(granted[k])
            status = 0 if g > 0 or amount == 0 else RESOURCE_EXHAUSTED
            fut.set(QuotaResult(granted_amount=g,
                                valid_duration_s=duration,
                                status_code=status))
        self._requeue_deferred(deferred)

    def _requeue_deferred(self, deferred: list) -> None:
        """Items whose dedup id was held by a dispatched-but-uncommitted
        in-step session: re-queue for the next flush (the cache then
        replays the outcome, or a fresh consume runs if the session
        aborted). A closing pool resolves them immediately."""
        if not deferred:
            return
        with self._lock:
            if not self._closed:
                self._pending.extend(deferred)
                self._wake.notify()
                return
        for *_x, fut in deferred:
            fut.set(QuotaResult(granted_amount=0, status_code=14,
                                status_message="quota pool closed"))

    def _gc_dedup(self, now: float) -> None:
        if len(self._dedup) > 10_000:
            for k in [k for k, (_, exp) in self._dedup.items()
                      if exp <= now]:
                del self._dedup[k]
        if len(self._dedup_free) > 10_000:
            for k in [k for k, exp in self._dedup_free.items()
                      if exp <= now]:
                del self._dedup_free[k]


class QuotaFuture:
    """Tiny thread-safe future: result() blocks; add_done_callback fires
    immediately if resolved, else from the pool worker on set()."""

    def __init__(self) -> None:
        self._ev = threading.Event()
        self._value: QuotaResult | None = None
        self._cbs: list = []
        self._lock = threading.Lock()

    def set(self, value: QuotaResult) -> None:
        with self._lock:
            self._value = value
            self._ev.set()
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            try:
                cb(value)
            except Exception:   # callbacks must not kill the worker
                log.exception("quota future callback failed")

    def add_done_callback(self, cb) -> None:
        with self._lock:
            if not self._ev.is_set():
                self._cbs.append(cb)
                return
            value = self._value
        cb(value)

    def result(self, timeout: float | None = 30.0) -> QuotaResult:
        if not self._ev.wait(timeout):
            raise TimeoutError("quota allocation timed out")
        assert self._value is not None
        return self._value

    def done(self) -> bool:
        return self._ev.is_set()


class InlineQuotaSession:
    """One check trip's staged in-step quota work.

    Lifecycle: inline_begin (stage, token held) → dispatched(new) (the
    pool moves onto the trip's output plane and the token releases — the
    next trip chains on it, after this one on the stream) → commit(granted,
    gate) in dispatch order. Tick bookkeeping is optimistic at stage
    time: the launch rolls every staged row's bucket unconditionally
    (only the ALLOC is gated, by zeroed amounts), so host _last_tick and
    device slots agree for chained trips. A trip that fails AFTER
    dispatch restores the last known-good plane unless a later trip
    already chained past it; its optimistic tick advances then
    under-grant (never over-grant) for at most one window.

    Result parity: gate-off rows grant the requested amount freely
    WITHOUT consuming (dispatcher.quota's no-matching-rule tail); dedup
    ids cache only consumed outcomes."""

    def __init__(self, pool: DeviceQuotaPool, n: int) -> None:
        self.pool = pool
        self.n = n
        self.now = 0.0
        self.seq = -1
        self.prev_counts: Any = None
        self.new_counts: Any = None
        self.early: dict[int, QuotaResult] = {}
        self.replay_of: dict[int, tuple[int, float]] = {}
        # slot → (dedup id, duration, requested amount): same-id rows
        # racing a dispatched-but-uncommitted session
        self.pending_replay: dict[int, tuple[str, float, int]] = {}
        self._staged: dict[int, tuple] = {}   # slot → (amount, dur, did)
        # the staged rows, int32 [8, n] in ROW_FIELDS order; the named
        # arrays are views of its rows
        self.rows = np.zeros((len(ROW_FIELDS), n), np.int32)
        (self.buckets, self.amounts, self.be, self.mx, self.active,
         self.ticks, self.lasts, self.rolling) = self.rows
        self._token_held = True
        self._done = False

    def stage(self, slot: int, bucket: int, args: QuotaArgs,
              lim: Mapping[str, Any], dedup_id: str,
              now: float) -> None:
        """Called under pool._lock (inline_begin)."""
        p = self.pool
        self.buckets[slot] = bucket
        self.amounts[slot] = int(args.quota_amount)
        self.be[slot] = bool(args.best_effort)
        self.mx[slot] = lim["max"]
        self.active[slot] = 1
        tl = p._tick_len[bucket]
        if tl > 0:
            abs_tick = int(now / tl)
            base = int(p._tick_base[bucket])
            self.ticks[slot] = abs_tick - base
            self.lasts[slot] = int(p._last_tick[bucket]) - base
            self.rolling[slot] = 1
            # OPTIMISTIC: the launch rolls this bucket to abs_tick
            # whatever the gate says
            p._last_tick[bucket] = abs_tick
        self._staged[slot] = (int(args.quota_amount), lim["duration"],
                              dedup_id)

    def dispatched(self, new_counts) -> None:
        """The trip is enqueued: move the pool onto its output plane and
        release the token — the next trip chains on it."""
        self.new_counts = new_counts
        self.pool.counts = new_counts
        self.pool._counts_stream = self.pool._producer_stream()
        self._token_held = False
        self.pool._counts_lock.release()

    def _take_turn(self) -> None:
        cv = self.pool._commit_cv
        with cv:
            while self.pool._commit_turn != self.seq:
                cv.wait(timeout=1.0)

    def _end_turn(self) -> None:
        cv = self.pool._commit_cv
        with cv:
            self.pool._commit_turn = self.seq + 1
            cv.notify_all()

    def commit(self, granted: np.ndarray, gate: np.ndarray
               ) -> dict[int, QuotaResult]:
        """granted/gate: the pulled per-row outputs. Returns {slot →
        QuotaResult} for staged / replay / pending rows (merge with
        .early for the full picture)."""
        p = self.pool
        out: dict[int, QuotaResult] = {}
        self._take_turn()
        try:
            with p._lock:
                p._counts_good = self.new_counts
                for slot, (amount, duration, did) in self._staged.items():
                    if did:
                        p._dedup_pending.pop(did, None)
                    if not gate[slot]:
                        # no active quota rule for this request: grant
                        # the requested amount freely, consuming nothing;
                        # the outcome goes to _dedup_free so a same-id
                        # pending replay resolves grant-freely too
                        if did:
                            p._dedup_free[did] = self.now + max(
                                duration, p.min_dedup_s)
                        out[slot] = QuotaResult(granted_amount=amount)
                        continue
                    g = int(granted[slot])
                    if did:
                        expiry = self.now + max(duration, p.min_dedup_s)
                        p._dedup[did] = (g, expiry)
                    status = 0 if g > 0 or amount == 0 \
                        else RESOURCE_EXHAUSTED
                    out[slot] = QuotaResult(granted_amount=g,
                                            valid_duration_s=duration,
                                            status_code=status)
                for slot, (did, duration, amount) in \
                        self.pending_replay.items():
                    hit = p._dedup.get(did)
                    free_exp = p._dedup_free.get(did)
                    if hit is not None and hit[1] > self.now:
                        status = 0 if hit[0] > 0 or amount == 0 \
                            else RESOURCE_EXHAUSTED
                        out[slot] = QuotaResult(
                            granted_amount=hit[0],
                            valid_duration_s=duration,
                            status_code=status)
                    elif free_exp is not None and free_exp > self.now:
                        out[slot] = QuotaResult(granted_amount=amount)
                    else:
                        # the consuming session aborted: nothing to
                        # replay
                        out[slot] = QuotaResult(
                            granted_amount=0, status_code=14,
                            status_message="quota trip failed")
            for slot, (first, duration) in self.replay_of.items():
                prior = out.get(first, self.early.get(first))
                if prior is None:
                    prior = QuotaResult(granted_amount=0,
                                        status_code=RESOURCE_EXHAUSTED)
                out[slot] = prior
            return out
        finally:
            self._done = True
            self._end_turn()

    def abort(self) -> None:
        """Trip failed. Pre-dispatch: release the token, nothing changed.
        Post-dispatch: take the commit turn, drop pending markers, and
        restore the last known-good plane unless a later trip already
        chained past this one."""
        if self._done:
            return
        self._done = True
        p = self.pool
        if self._token_held:
            self._token_held = False
            p._counts_lock.release()
            # the turn MUST still be consumed or every later session
            # wedges behind this seq
            self._take_turn()
            self._end_turn()
            return
        self._take_turn()
        try:
            with p._lock:
                for _slot, (_a, _d, did) in self._staged.items():
                    if did:
                        p._dedup_pending.pop(did, None)
            with p._counts_lock:
                if p.counts is self.new_counts:
                    # committed after its pull (or prewarmed): complete,
                    # so the audit pull may wait on any stream
                    p.counts = p._counts_good
        finally:
            self._end_turn()


class DeviceQuotaTable:
    """Pool lifecycle with signature reuse across config generations
    (handlerTable.go pattern): an unchanged handler signature keeps its
    pool — counters, keymap and dedup cache — across snapshot swaps."""

    def __init__(self, n_buckets: int = DEFAULT_BUCKETS,
                 device: str | torch.device = "cuda"):
        self.n_buckets = n_buckets
        self.device = device
        self._by_sig: dict[str, DeviceQuotaPool] = {}

    def rebuild(self, snapshot) -> tuple[dict[str, DeviceQuotaPool],
                                         list[DeviceQuotaPool]]:
        """→ (handler qname → pool, orphaned pools to close)."""
        out: dict[str, DeviceQuotaPool] = {}
        new_sigs: dict[str, DeviceQuotaPool] = {}
        for qname, hc in snapshot.handlers.items():
            if hc.adapter != "memquota":
                continue
            quotas = {str(q.get("name", "")): q
                      for q in hc.params.get("quotas", ())}
            if not quotas:
                continue
            sig = hc.signature
            pool = self._by_sig.get(sig) or new_sigs.get(sig)
            if pool is None:
                pool = DeviceQuotaPool(
                    quotas, n_buckets=self.n_buckets,
                    min_dedup_s=float(hc.params.get(
                        "min_deduplication_duration_s", 1.0)),
                    device=self.device)
            new_sigs[sig] = pool
            out[qname] = pool
        orphans = [p for sig, p in self._by_sig.items()
                   if sig not in new_sigs]
        self._by_sig = new_sigs
        return out, orphans

    def close(self) -> None:
        for p in self._by_sig.values():
            p.close()
        self._by_sig = {}
