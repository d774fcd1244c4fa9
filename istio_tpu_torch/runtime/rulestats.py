"""Rule-level check telemetry: resident accumulators and their drain.

Port of `RuleTelemetry` from istio_tpu/runtime/rulestats.py: per
snapshot, int32 accumulators that live on the device across steps —

  hit  [S, n_rows] — requests the rule matched, per namespace slot
  deny [S, n_rows] — requests the rule won the deny for, per slot
  err  [n_rows]    — ns-visible predicate errors

with S = len(ns_ids) + 1 (the extra slot collects requests whose
namespace the snapshot does not know). `observe()` folds one check
batch into them with the rule_stats kernel (csrc/rule_stats.cu, K6:
the reference's delta program and fold in one in-place launch);
host-fallback rules arrive through `add_host()`; `drain()` swaps fresh
zero buffers in under the lock and pulls the old ones outside it.

Two things differ from the reference on purpose. The reference aliases
one zero buffer into both hit and deny (harmless for immutable JAX
arrays); the fold here adds in place, so every buffer is its own. And a
pull must follow the last fold launched on a buffer, whichever stream
launched it: every fold records a CUDA event, and drain()/wait() wait
on them.

`RuleStatsAggregator` folds drained deltas into cumulative counts keyed
by qualified rule name (surviving config swaps), and `RuleStatsDrainer`
drains it on an interval, so the int32 accumulators never run long
enough to wrap; `attach_lanes` adds the sharded serving plane's bank
plans as drain sources (sharding/). `preview_attributes` is the
exemplar rendering the config canary's reports use (canary/differ.py).
Not carried: the aggregator's metric families, exporters, its own
exemplars and the top-k `snapshot()` view.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.utils.log import scope

log = scope("runtime.rulestats")

OK = 0


# ---------------------------------------------------------------------------
# K6: rule_stats (csrc/rule_stats.cu)
# ---------------------------------------------------------------------------

def rule_stats_plain(matched: torch.Tensor, err: torch.Tensor,
                     status: torch.Tensor, deny_rule: torch.Tensor,
                     req_ns: torch.Tensor, real: torch.Tensor,
                     rule_ns: torch.Tensor, default_ns: int, n_slots: int,
                     err_rows: torch.Tensor, hit: torch.Tensor,
                     deny: torch.Tensor, err_acc: torch.Tensor) -> None:
    """Plain version of the rule_stats kernel: the reference's
    `RuleTelemetry._make_delta.<locals>.delta` (istio_tpu/runtime/
    rulestats.py:165-201) added into hit / deny / err_acc in place."""
    n_rows = matched.shape[1]
    ns_ok = (rule_ns[None, :] == default_ns) | \
        (rule_ns[None, :] == req_ns[:, None])
    counted = ns_ok & real[:, None]
    slot = torch.where(req_ns < 0, n_slots - 1,
                       req_ns.clamp(0, n_slots - 1)).long()
    hit.index_add_(0, slot, (matched & counted).to(torch.int32))
    won = (status != OK) & real & (deny_rule >= 0) & (deny_rule < n_rows)
    flat = (slot * n_rows + deny_rule.long())[won]
    deny.view(-1).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    err_acc += (err & counted & err_rows[None, :]).sum(dim=0,
                                                       dtype=torch.int32)


_K = kernels
_STATS_ARGS = ([_K.VP] * 6 + [_K.I32, _K.I32]     # planes, verdict, B, R
               + [_K.VP, _K.I32, _K.I32, _K.VP]     # rule_ns .. err_rows
               + [_K.VP] * 3 + [_K.VP])             # accumulators, stream


def rule_stats(matched: torch.Tensor, err: torch.Tensor,
               status: torch.Tensor, deny_rule: torch.Tensor,
               req_ns: torch.Tensor, real: torch.Tensor,
               rule_ns: torch.Tensor, default_ns: int, n_slots: int,
               err_rows: torch.Tensor, hit: torch.Tensor,
               deny: torch.Tensor, err_acc: torch.Tensor) -> None:
    """Fold one batch's per-rule hit / deny / err counts into the int32
    accumulators in place. CPU tensors run rule_stats_plain."""
    if matched.device.type == "cpu":
        return rule_stats_plain(matched, err, status, deny_rule, req_ns,
                                real, rule_ns, default_ns, n_slots,
                                err_rows, hit, deny, err_acc)
    if matched.device.type != "cuda":
        raise ValueError(f"rule_stats: unsupported device {matched.device}")
    dev = matched.device
    b, n_rows = matched.shape
    want = {"matched": (matched, torch.bool, (b, n_rows)),
            "err": (err, torch.bool, (b, n_rows)),
            "status": (status, torch.int32, (b,)),
            "deny_rule": (deny_rule, torch.int32, (b,)),
            "req_ns": (req_ns, torch.int32, (b,)),
            "real": (real, torch.bool, (b,)),
            "rule_ns": (rule_ns, torch.int32, (n_rows,)),
            "err_rows": (err_rows, torch.bool, (n_rows,)),
            "hit": (hit, torch.int32, (n_slots, n_rows)),
            "deny": (deny, torch.int32, (n_slots, n_rows)),
            "err_acc": (err_acc, torch.int32, (n_rows,))}
    for k, (x, dt, shape) in want.items():
        if x.device != dev or x.dtype != dt or not x.is_contiguous() or \
                tuple(x.shape) != shape:
            raise ValueError(f"rule_stats: {k} must be a contiguous {dt} "
                             f"{shape} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if b == 0:
        return None
    p = kernels.ptr
    fn = kernels.function("rule_stats", "rule_stats", _STATS_ARGS)
    rc = fn(p(matched), p(err), p(status), p(deny_rule), p(req_ns), p(real),
            b, n_rows, p(rule_ns), default_ns, n_slots, p(err_rows),
            p(hit), p(deny), p(err_acc), kernels.VP(kernels.stream_ptr()))
    kernels.launched("rule_stats", kernels.check(rc, "rule_stats"),
                     matched, err, status, deny_rule, req_ns, real, rule_ns,
                     default_ns, n_slots, err_rows)
    return None


def preview_attributes(bag, limit: int = 16,
                       value_len: int = 128) -> dict:
    """Bounded attribute preview of one sampled request: the exemplar
    rendering contract the config canary's reports share with the
    reference's /debug/rulestats (first `limit` attributes, reprs
    truncated to `value_len`, decode failures sentineled)."""
    attrs: dict = {}
    try:
        for name in list(bag.names())[:limit]:
            v, ok = bag.get(name)
            if ok:
                attrs[str(name)] = repr(v)[:value_len]
    except Exception:
        attrs = {"<decode-failed>": "1"}
    return attrs


class RuleTelemetry:
    """Per-snapshot on-device rule accumulators (see the module doc)."""

    def __init__(self, ruleset, n_cfg: int, exemplars_per_rule: int = 4,
                 seed: int = 0):
        self.device = ruleset.device
        self.n_rows = int(ruleset.rule_ns.shape[0])
        self.n_cfg = int(n_cfg)
        self.n_slots = len(ruleset.ns_ids) + 1
        self._default_ns = ruleset.ns_ids[""]
        # host-fallback rows read err=True on device by construction —
        # mask them out of the device err fold; their real errors
        # arrive via add_host()
        err_rows = np.ones(self.n_rows, bool)
        for ridx in ruleset.host_fallback:
            if ridx < self.n_rows:
                err_rows[ridx] = False
        self._rule_ns = torch.from_numpy(
            np.ascontiguousarray(ruleset.rule_ns, np.int32)).to(self.device)
        self._err_rows = torch.from_numpy(err_rows).to(self.device)
        self._lock = threading.Lock()
        self.generation = 0
        self._acc_hit, self._acc_deny, self._acc_err = self._zeros()
        # the last fold's event per launching stream (CUDA only)
        self._events: dict[int, Any] = {}
        # host-side planes for host-fallback rules (overlay patch)
        self._host_hit = np.zeros((self.n_slots, self.n_rows), np.int64)
        self._host_err = np.zeros(self.n_rows, np.int64)
        # decision exemplars: per-rule reservoirs, sampled host-side
        self._ex_cap = exemplars_per_rule
        self._ex: dict[int, list] = {}
        self._ex_seen: dict[int, int] = {}
        self._rng = random.Random(seed)

    def _zeros(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Three separately allocated zero buffers (hit, deny, err). On
        the card the zero fill runs on the caller's stream, which is
        synchronised before the buffers are handed to folds that may
        launch on another stream."""
        z = (torch.zeros((self.n_slots, self.n_rows), dtype=torch.int32,
                         device=self.device),
             torch.zeros((self.n_slots, self.n_rows), dtype=torch.int32,
                         device=self.device),
             torch.zeros(self.n_rows, dtype=torch.int32,
                         device=self.device))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return z

    # ------------------------------------------------------------------
    # hot path
    # ------------------------------------------------------------------

    def observe(self, verdict, req_ns, real_mask) -> None:
        """Fold one check batch's per-rule counts into the device
        accumulators. `req_ns` int32 [B] and `real_mask` bool [B] may be
        host numpy or tensors; dispatch only, no host↔device sync."""
        req = torch.as_tensor(req_ns).to(self.device, torch.int32)
        real = torch.as_tensor(np.asarray(real_mask, bool)
                               if not isinstance(real_mask, torch.Tensor)
                               else real_mask).to(self.device, torch.bool)
        # the lock orders each launch against drain()'s buffer swap
        with self._lock:
            rule_stats(verdict.matched, verdict.err, verdict.status,
                       verdict.deny_rule, req.contiguous(),
                       real.contiguous(), self._rule_ns, self._default_ns,
                       self.n_slots, self._err_rows, self._acc_hit,
                       self._acc_deny, self._acc_err)
            if self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                ev = torch.cuda.Event()
                ev.record(stream)
                self._events[stream.cuda_stream] = ev

    def add_host(self, cols, active_cols: np.ndarray,
                 err_counts: Mapping[int, int],
                 ns_slots: np.ndarray) -> None:
        """Host-side counts for host-fallback rules, from the overlay
        patch point (Dispatcher._overlay_active): `cols` rule indices,
        `active_cols` bool [B, len(cols)] (already ns-masked, padding
        trimmed), `ns_slots` int [B], `err_counts` rule idx → predicate
        errors this batch. Pure numpy."""
        with self._lock:
            for j, ridx in enumerate(cols):
                col = active_cols[:, j]
                if col.any():
                    np.add.at(self._host_hit[:, ridx], ns_slots[col], 1)
            for ridx, n in err_counts.items():
                self._host_err[ridx] += n

    def sample(self, ridx: int, status: int, bag, span) -> None:
        """Reservoir-sample one denied/errored request for rule `ridx`."""
        entry = {
            "status": status,
            "bag": bag,
            "trace_id": span.get("traceId") if span else None,
            "span_id": span.get("id") if span else None,
            "t": time.time(),
        }
        with self._lock:
            seen = self._ex_seen.get(ridx, 0) + 1
            self._ex_seen[ridx] = seen
            bucket = self._ex.setdefault(ridx, [])
            if len(bucket) < self._ex_cap:
                bucket.append(entry)
            else:
                j = self._rng.randrange(seen)
                if j < self._ex_cap:
                    bucket[j] = entry

    def ns_slots(self, ns_ids: np.ndarray) -> np.ndarray:
        """Request ns ids → accumulator slots (unknown/-1 → last)."""
        return np.where(ns_ids < 0, self.n_slots - 1, ns_ids)

    # ------------------------------------------------------------------
    # drain boundary (the one deliberate device→host sync)
    # ------------------------------------------------------------------

    def drain(self) -> dict:
        """Swap fresh zero accumulators in and pull the old buffers —
        generation-tagged deltas since the previous drain. The pull
        waits for every fold launched on the old buffers first."""
        t0 = time.perf_counter()
        fresh = self._zeros()
        with self._lock:
            hit, deny, err = self._acc_hit, self._acc_deny, self._acc_err
            self._acc_hit, self._acc_deny, self._acc_err = fresh
            events, self._events = list(self._events.values()), {}
            host_hit, self._host_hit = self._host_hit, np.zeros(
                (self.n_slots, self.n_rows), np.int64)
            host_err, self._host_err = self._host_err, np.zeros(
                self.n_rows, np.int64)
            self.generation += 1
            gen = self.generation
            exemplars = {r: list(v) for r, v in self._ex.items()}
            ex_seen = dict(self._ex_seen)
        for ev in events:
            ev.synchronize()
        hit_np = hit.cpu().numpy().astype(np.int64)
        deny_np = deny.cpu().numpy().astype(np.int64)
        err_np = err.cpu().numpy().astype(np.int64)
        hit_np += host_hit
        err_np += host_err
        wall = time.perf_counter() - t0
        return {"generation": gen, "hit": hit_np, "deny": deny_np,
                "err": err_np, "exemplars": exemplars,
                "exemplars_seen": ex_seen, "wall_s": wall}

    def wait(self) -> None:
        """Block until every launched fold has executed (a timing
        helper, not for the serving path)."""
        with self._lock:
            events = list(self._events.values())
        for ev in events:
            ev.synchronize()

    def state(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The live (hit, deny, err) accumulators, for carrying state
        across (interop.telemetry_state_from_reference) and for checks."""
        with self._lock:
            return self._acc_hit, self._acc_deny, self._acc_err


class RuleStatsAggregator:
    """Name-keyed cumulative counts over drained deltas.

    One aggregator per RuntimeServer. `attach(dispatcher)` follows
    config swaps: the outgoing plan is drained first and then swept for
    RETIRE_SWEEP_S more (batches in flight on the old dispatcher may
    still fold into it), so a swap never drops counts. Drains are
    serialised: when drain() returns, every count folded on the device
    before the call is in counts()."""

    # how long a swapped-out plan's telemetry keeps being swept
    RETIRE_SWEEP_S = 3.0

    def __init__(self):
        self._lock = threading.Lock()
        self._drain_serial = threading.Lock()
        self._plan = None
        self._names: list[str] = []
        self._slot_names: list[str] = []
        # rule name → {"hits", "denies", "errors", "ns": {ns: {...}}}
        self._cum: dict[str, dict] = {}
        # swapped-out plans still being swept: (plan, names, slot
        # names, drop-after timestamp)
        self._retired: list[tuple] = []
        # sharded serving lanes (istio_tpu_torch/sharding): bank
        # dispatchers' plans swept on every drain alongside the main
        # plan — their per-rule counts merge into the same name-keyed
        # cumulative stats (bank rule names ARE the global qualified
        # names). See attach_lanes(). Entries: (plan, names, slot_names).
        self._lanes: list[tuple] = []

    def attach(self, dispatcher) -> None:
        """Bind to a freshly published dispatcher (drains the old plan
        first and retires it for continued sweeping)."""
        self.drain()
        snap = dispatcher.snapshot
        rs = snap.ruleset
        plan = dispatcher.fused
        with self._lock:
            old = self._plan
            if old is not None and old is not plan:
                self._retired.append(
                    (old, self._names, self._slot_names,
                     time.time() + self.RETIRE_SWEEP_S))
            has_tele = plan is not None and plan.telemetry is not None
            self._plan = plan if has_tele else None
            self._names = list(snap.qualified_rule_names())
            self._slot_names = self._slot_names_of(rs)
            for name in self._names:
                self._cum.setdefault(
                    name, {"hits": 0, "denies": 0, "errors": 0, "ns": {}})

    @staticmethod
    def _slot_names_of(rs) -> list[str]:
        by_id = {v: k for k, v in rs.ns_ids.items()}
        n_slots = len(rs.ns_ids) + 1
        return [by_id.get(i, f"ns#{i}") or "(default)"
                for i in range(n_slots - 1)] + ["(unknown)"]

    def attach_lanes(self, dispatchers) -> None:
        """Bind the sharded plane's bank dispatchers as additional
        drain sources (config swaps call this right after the lane
        publish). The PREVIOUS lane set is retired for continued
        sweeping exactly like attach()'s old plan — a batch in flight
        on an old bank can fold after the rebind, and a swap must
        never drop counts. The main attached plan is skipped if it
        also appears as a lane (replica-only mode's lane 0 rides the
        published dispatcher). A bank plan run by two lanes folds from
        both lanes' streams; its telemetry keeps an event per stream,
        so a drain waits for every lane's folds."""
        lanes: list[tuple] = []
        seen: set[int] = set()
        with self._lock:
            main = self._plan
        for d in dispatchers:
            plan = getattr(d, "fused", None)
            if plan is None or plan is main or id(plan) in seen:
                continue
            if getattr(plan, "telemetry", None) is None:
                continue
            seen.add(id(plan))
            snap = d.snapshot
            lanes.append((plan, list(snap.qualified_rule_names()),
                          self._slot_names_of(snap.ruleset)))
        with self._lock:
            for _plan, names, _slots in lanes:
                for name in names:
                    self._cum.setdefault(
                        name, {"hits": 0, "denies": 0, "errors": 0,
                               "ns": {}})
            old = self._lanes
            self._lanes = lanes
            deadline = time.time() + self.RETIRE_SWEEP_S
            live = {id(p) for p, _, _ in lanes}
            for plan, names, slots in old:
                if id(plan) not in live:
                    self._retired.append((plan, names, slots, deadline))

    def drain(self) -> dict | None:
        """Pull the retired plans', the attached plan's and the sharded
        lanes' deltas and fold them into the cumulative counts. Returns
        the live plan's raw drain dict (None when no telemetry is
        attached). Called by the RuntimeServer's drainer thread and on
        demand, never by the serving path."""
        with self._drain_serial:
            with self._lock:
                plan = self._plan
                names = self._names
                slot_names = self._slot_names
                now = time.time()
                retired = list(self._retired)
                self._retired = [r for r in self._retired if r[3] > now]
                lanes = list(self._lanes)
            for rplan, rnames, rslots, _deadline in retired:
                try:
                    self._fold(rplan.telemetry.drain(), rnames, rslots)
                except Exception:
                    log.exception("retired-plan drain failed")
            d = None
            if plan is not None:
                d = plan.telemetry.drain()
                self._fold(d, names, slot_names)
            # sharded serving lanes: every bank's accumulators drain
            # into the same name-keyed stats (each rule lives in exactly
            # one bank per generation, global rules in every bank but
            # each request served by exactly one)
            for lplan, lnames, lslots in lanes:
                try:
                    self._fold(lplan.telemetry.drain(), lnames, lslots)
                except Exception:
                    log.exception("lane-plan drain failed")
            return d

    def _fold(self, d: dict, names: list[str],
              slot_names: list[str]) -> None:
        hit, deny, err = d["hit"], d["deny"], d["err"]
        n_cfg = min(len(names), hit.shape[1])
        hit_r = hit[:, :n_cfg].sum(axis=0)
        deny_r = deny[:, :n_cfg].sum(axis=0)
        with self._lock:
            for r in range(n_cfg):
                h, dn, e = int(hit_r[r]), int(deny_r[r]), int(err[r])
                if not (h or dn or e):
                    continue
                cum = self._cum.setdefault(
                    names[r], {"hits": 0, "denies": 0, "errors": 0,
                               "ns": {}})
                cum["hits"] += h
                cum["denies"] += dn
                cum["errors"] += e
                for s in np.nonzero(hit[:, r] | deny[:, r])[0]:
                    ns = slot_names[s] if s < len(slot_names) \
                        else f"slot#{s}"
                    per = cum["ns"].setdefault(ns, {"hits": 0, "denies": 0})
                    per["hits"] += int(hit[s, r])
                    per["denies"] += int(deny[s, r])

    def counts(self) -> dict:
        """{rule name: {hits, denies, errors, ns}} copy."""
        with self._lock:
            return {n: dict(v, ns={ns: dict(p)
                                   for ns, p in v["ns"].items()})
                    for n, v in self._cum.items()}


class RuleStatsDrainer:
    """Background drain loop at the configured interval. Owned by the
    RuntimeServer; close() stops it."""

    def __init__(self, aggregator: RuleStatsAggregator,
                 interval_s: float = 0.5):
        self.aggregator = aggregator
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rulestats-drain")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.aggregator.drain()
            except Exception:
                log.exception("rulestats drain failed")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
