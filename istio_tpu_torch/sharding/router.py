"""Shard-routed dispatch + replica-parallel serving lanes.

ShardRouter is a lane's run_batch hook: trim padding, bucket each row
to its namespace's bank (planner.ShardPlan.shard_of — the SAME routing
decision the front's lane selector makes, so a row can never arrive at
a router that does not own its bank), run each bank's full fused check
on its sub-batch, then FOLD: scatter responses back into row order and
remap device deny attribution from bank-local to global rule indices.
Zero rows are ever dropped by construction — the fold raises (and the
batcher's belt resolves every future) if any bank returns short.

ReplicaRouter is the front: N CheckBatcher serving lanes behind the
one RuntimeServer.batcher attribute. Lane selection is sticky by
namespace (shard_of(ns) % n_replicas), so one namespace's traffic
coalesces into one lane's batches — batches arrive at the router
already shard-pure under real traffic, and a namespace's requests keep
FIFO order within their lane. Admission control (queue caps,
deadlines, brownout, drain/quiesce lifecycle) is per lane via the
existing CheckBatcher.

Stage attribution (runtime/monitor.py SHARD_STAGES):
  shard_dispatch  — namespace extraction + row bucketing, per batch
  bank_check      — one observation per (batch, bank) device trip
  fold            — response scatter + deny-index remap, per batch

Port of istio_tpu/sharding/router.py. The reference's lanes are device
leases that run concurrently; on one card each ShardRouter (one per
lane) owns a CUDA stream (a platform.VirtualDevice over the banks'
device) and makes it current around its bank trips, in whichever
thread runs the trip. The trip's stream first waits on the caller's
stream (platform.fork), and each bank trip ends in its one pull to the
host, so nothing a lane makes is read on another stream unordered. On
the CPU the stream is None and the scope is a no-op.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Mapping, Sequence

import torch

from istio_tpu_torch.platform import VirtualDevice, fork
from istio_tpu_torch.runtime import monitor
from istio_tpu_torch.runtime.batcher import (CheckBatcher, pad_to_bucket,
                                             trim_pads)
from istio_tpu_torch.runtime.dispatcher import _namespace_of
from istio_tpu_torch.sharding.banks import ShardBank
from istio_tpu_torch.sharding.planner import ShardPlan


class ShardRouter:
    """Route a batch's rows to their banks, fold the verdicts."""

    def __init__(self, banks: Mapping[int, ShardBank], plan: ShardPlan,
                 identity_attr: str, replica: int = 0):
        self.banks = dict(banks)
        self.plan = plan
        self.identity_attr = identity_attr
        self.replica = replica
        # the lane's virtual device over its banks' card: every bank
        # trip of this router runs on its stream (None on the CPU)
        dev = next(iter(self.banks.values())).snapshot.ruleset.device \
            if self.banks else torch.device("cpu")
        self.lane = VirtualDevice(
            id=replica, device=dev,
            stream=torch.cuda.Stream(dev) if dev.type == "cuda" else None)
        # rows served per bank — under ONE lock: a router serves a
        # lane's pipelined workers AND pre-batched callers
        # (check_many) concurrently, and the row-conservation gates are
        # exact, so lost increments would read as phantom drops (one
        # lock acquisition per batch/bank, never per row)
        self._stats_lock = threading.Lock()
        self.rows_routed: dict[int, int] = {s: 0 for s in self.banks}
        self.batches = 0
        self.misrouted = 0

    def check(self, bags: Sequence,
              deadline: float | None = None) -> list:
        """The lane's run_batch hook — returns exactly one
        CheckResponse per (non-padding) input row, in input order.
        `deadline`: the batch's min remaining absolute instant,
        threaded to each bank's host-action fold (executor plane)."""
        bags = trim_pads(list(bags))
        if not bags:
            return []
        t0 = time.perf_counter()
        groups: dict[int, list[int]] = {}
        for i, bag in enumerate(bags):
            ns = _namespace_of(bag, self.identity_attr)
            shard = self.plan.shard_of(ns)
            bank = self.banks.get(shard)
            if bank is None:
                # a row this router's bank set cannot serve: a routing
                # contract violation, never a silent drop — counted,
                # then raised so the batch resolves with a typed error
                with self._stats_lock:
                    self.misrouted += 1
                raise RuntimeError(
                    f"row routed to shard {shard} but this replica "
                    f"owns banks {sorted(self.banks)}")
            groups.setdefault(shard, []).append(i)
        monitor.observe_shard_stage("shard_dispatch",
                                    time.perf_counter() - t0)
        with self._stats_lock:
            self.batches += 1
        out: list = [None] * len(bags)
        fold_s = 0.0
        _caller, ready = fork(self.lane.device)
        for shard in sorted(groups):
            idxs = groups[shard]
            bank = self.banks[shard]
            buckets = bank.dispatcher.buckets
            # chunk to the bank's largest warmed bucket: a lane can
            # form batches past it (explicit small buckets under a big
            # max_batch), and an over-bucket sub-batch would serve a
            # shape the warm never ran
            cap = buckets[-1] if buckets else len(idxs) or 1
            resp: list = []
            t1 = time.perf_counter()
            with self.lane.scope():
                self.lane.wait(ready)
                for lo in range(0, len(idxs), cap):
                    chunk = [bags[i] for i in idxs[lo:lo + cap]]
                    padded = pad_to_bucket(chunk, buckets) \
                        if buckets else chunk
                    # bank.check rides the bank's OWN ResilientChecker
                    # when wired: retry → per-bank breaker → the bank's
                    # CPU-oracle fallback (strict on the card: only a
                    # CHAOS-injected fault takes that chain)
                    resp.extend(bank.check(padded, deadline=deadline))
            t2 = time.perf_counter()
            monitor.observe_shard_stage("bank_check", t2 - t1)
            if len(resp) < len(idxs):
                raise RuntimeError(
                    f"bank {shard} returned {len(resp)} responses "
                    f"for {len(idxs)} rows")
            l2g = bank.local_to_global
            for i, r in zip(idxs, resp):
                dr = r.deny_rule
                if dr >= 0 and dr < len(l2g):
                    r.deny_rule = int(l2g[dr])
                out[i] = r
            with self._stats_lock:
                self.rows_routed[shard] = \
                    self.rows_routed.get(shard, 0) + len(idxs)
            fold_s += time.perf_counter() - t2
        monitor.observe_shard_stage("fold", fold_s)
        monitor.observe_replica_batch(self.replica,
                                      time.perf_counter() - t0,
                                      len(bags))
        return out

    def stats(self) -> dict:
        with self._stats_lock:
            rows = dict(self.rows_routed)
            batches = self.batches
            misrouted = self.misrouted
        total = sum(rows.values())
        return {
            "replica": self.replica,
            "batches": batches,
            "rows": total,
            "misrouted": misrouted,
            "rows_per_shard": {str(s): n for s, n
                               in sorted(rows.items())},
            "occupancy": {str(s): round(n / total, 4) if total else 0.0
                          for s, n in sorted(rows.items())},
        }


class ReplicaRouter:
    """N serving lanes behind the one front — a drop-in for the
    RuntimeServer.batcher attribute (submit/check/stats/healthy/
    quiesce/drain/close), routing each submit to its namespace's
    sticky lane. Lanes persist across config swaps: a swap builds
    fresh banks/routers off-path and publishes them with one atomic
    list assignment (set_routers), so queued requests drain onto the
    NEW snapshot's banks and nothing is dropped mid-swap."""

    def __init__(self, n_replicas: int, identity_attr: str,
                 batcher_kwargs: dict):
        self.n_replicas = max(n_replicas, 1)
        self.identity_attr = identity_attr
        self._plan: ShardPlan | None = None
        self._routers: list[ShardRouter] = []
        kw = dict(batcher_kwargs)
        # the router re-pads per bank — lane-level padding would only
        # be trimmed again
        kw["pad_batches"] = False
        # cumulative routing counters folded from RETIRED router
        # generations (set_routers): conservation and misroute numbers
        # must survive config swaps, not reset with each generation's
        # fresh routers
        self._retired_rows: dict[str, int] = {}
        self._retired_misrouted = 0
        self.lanes = [
            CheckBatcher(self._make_run(i), **kw)
            for i in range(self.n_replicas)]

    def _make_run(self, lane: int):
        def run(bags, deadline=None):
            routers = self._routers
            if not routers:
                raise RuntimeError("replica router has no published "
                                   "shard routers yet")
            return routers[lane % len(routers)].check(
                bags, deadline=deadline)
        return run

    # -- publication (config swaps fan here) --------------------------

    def set_routers(self, routers: list[ShardRouter],
                    plan: ShardPlan) -> None:
        """Atomic publish: one reference assignment (GIL) swaps every
        lane onto the new banks — a batch in flight finishes on the
        routers it started with, the next batch serves the new
        snapshot. The outgoing generation's routing counters fold
        into the cumulative retired totals first (counts from a batch
        still finishing on an old router after this fold are the only
        loss — bounded by the in-flight window, never a reset)."""
        for r in self._routers:
            st = r.stats()
            self._retired_misrouted += st["misrouted"]
            for s, n in st["rows_per_shard"].items():
                self._retired_rows[s] = \
                    self._retired_rows.get(s, 0) + n
        self._plan = plan
        self._routers = list(routers)

    @property
    def routers(self) -> list[ShardRouter]:
        return self._routers

    # -- the CheckBatcher-compatible front surface --------------------

    @property
    def buckets(self):
        return self.lanes[0].buckets

    @property
    def max_batch(self):
        return self.lanes[0].max_batch

    @property
    def window_s(self):
        return self.lanes[0].window_s

    @property
    def max_queue(self):
        return self.lanes[0].max_queue

    @property
    def _closed(self) -> bool:
        return all(lane._closed for lane in self.lanes)

    def lane_of(self, bag) -> int:
        """Sticky-by-namespace lane selection — the same shard_of
        decision the router makes, folded onto the lane count, so a
        namespace's shard and its lane never disagree."""
        plan = self._plan
        ns = _namespace_of(bag, self.identity_attr)
        if plan is None:
            return 0
        return plan.shard_of(ns) % self.n_replicas

    def submit(self, bag, trace: Any = None, deadline=None):
        return self.lanes[self.lane_of(bag)].submit(
            bag, trace=trace, deadline=deadline)

    def check(self, bag, deadline=None):
        return self.submit(bag, deadline=deadline).result()

    def healthy(self) -> tuple[bool, str]:
        for i, lane in enumerate(self.lanes):
            ok, err = lane.healthy()
            if not ok:
                return False, f"replica {i}: {err}"
        return True, ""

    def routing_stats(self) -> dict:
        """Cross-lane routing aggregate — THE single home of the
        rows-per-shard / occupancy / misroute fold every consumer
        reads (the conservation gates of the tests and chip_smoke)."""
        rows: dict[str, int] = dict(self._retired_rows)
        misrouted = self._retired_misrouted
        for r in self._routers:
            st = r.stats()
            misrouted += st["misrouted"]
            for s, n in st["rows_per_shard"].items():
                rows[s] = rows.get(s, 0) + n
        total = sum(rows.values())
        return {
            "rows_per_shard": dict(sorted(rows.items())),
            "occupancy": {s: round(n / total, 4) if total else 0.0
                          for s, n in sorted(rows.items())},
            "rows_total": total,
            "misrouted": misrouted,
        }

    def stats(self) -> dict:
        per = [lane.stats() for lane in self.lanes]
        ok, err = self.healthy()
        return {
            "depth": sum(p["depth"] for p in per),
            "oldest_wait_ms": max(p["oldest_wait_ms"] for p in per),
            "in_flight": sum(p["in_flight"] for p in per),
            "pipeline": per[0]["pipeline"],
            "hold_at": per[0]["hold_at"],
            "window_s": per[0]["window_s"],
            "max_batch": per[0]["max_batch"],
            "buckets": per[0]["buckets"],
            "closed": self._closed,
            "draining": all(p["draining"] for p in per),
            "max_queue": per[0]["max_queue"],
            "brownout": per[0]["brownout"],
            "healthy": ok,
            "health_error": err,
            "replicas": per,
            "n_replicas": self.n_replicas,
        }

    # -- lifecycle (admission → drain → close) -------------------------

    def quiesce(self) -> None:
        for lane in self.lanes:
            lane.quiesce()

    def drain(self, deadline: float | None = 5.0) -> bool:
        end = None if deadline is None \
            else time.perf_counter() + deadline
        ok = True
        for lane in self.lanes:
            left = None if end is None \
                else max(end - time.perf_counter(), 0.0)
            ok = lane.drain(left) and ok
        return ok

    def close(self) -> None:
        for lane in self.lanes:
            lane.close()
