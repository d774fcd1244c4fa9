"""Batched quota allocation — exact memquota alloc semantics.

Port of istio_tpu/models/quota_alloc.py (reference:
mixer/adapter/memquota/memquota.go:118 alloc — sequential per request:
avail = max - used; best-effort grants min(amount, avail), all-or-nothing
grants amount iff avail >= amount; the grant adds to used).

Every allocation mode runs on one hand-written kernel, quota_alloc
(csrc/quota_alloc.cu, K9), which updates the counter plane IN PLACE.
`quota_alloc(mode, slots, ...)` is its wrapper; on CPU tensors it runs
`quota_alloc_plain`, the reference's formulas in plain PyTorch (argsort,
segmented scans written with cumsum and cummax, a Python loop for the
sequential scan). The factories keep the reference's functional
convention: each returned fn clones the plane, allocates into the clone
and returns (granted, new_slots), so a caller can keep the old plane as
its restore target.

`make_alloc_step` (fixed counters) is the rolling kernel with K = 1 and
no row rolling. All arithmetic is int32 with wrap-around, as in the
reference (jax runs without x64).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from istio_tpu_torch import kernels

# Device-path bound on a SINGLE request's quota amount (step_seg): at
# B ≤ 512 rows per flush, cumsums of clamped amounts stay int32-exact
# (512 × 2^21 = 2^30). Over-domain all-or-nothing rows are denied;
# best-effort rows cap here.
DOMAIN_MAX = 1 << 21
MODES = {"scan": 0, "fast": 1, "unit": 2, "seg": 3}
# the kernel's one-launch limits (csrc/quota_alloc.cu kClusterRows = 16
# blocks x 4,096 rows, kMaxRows): above them a contended batch runs on
# the multi-launch path over a scratch buffer
CLUSTER_ROWS = 16 * 4096
SCAN_BLOCK_ROWS = 8192
_INT32_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class QuotaGate:
    """The in-step gate inputs (runtime/fused.py packq): a row allocates
    only when active & rule_idx >= 0 & its rule is visible to its
    namespace & the check status is OK & the rule matched the row."""
    status: torch.Tensor     # int32 [B]
    matched: torch.Tensor    # bool [B, R]
    rule_idx: torch.Tensor   # int32 [B], -1 = no quota rule
    rule_ns: torch.Tensor    # int32 [R]
    req_ns: torch.Tensor     # int32 [B]
    default_ns: int


def batch_rank(key: torch.Tensor) -> torch.Tensor:
    """rank[i] = #{j < i in stable sort order : key[j] == key[i]} — the
    occurrence index of each element within its key group (sentinel
    keys get unused ranks). int32 [N] → int32 [N]."""
    n = key.shape[0]
    order = torch.argsort(key, stable=True)
    sk = key[order]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    newseg = torch.ones(n, dtype=torch.bool, device=key.device)
    newseg[1:] = sk[1:] != sk[:-1]
    seg_first = torch.cummax(torch.where(newseg, idx, 0), dim=0).values
    rank_sorted = (idx - seg_first).to(torch.int32)
    out = torch.zeros(n, dtype=torch.int32, device=key.device)
    out[order] = rank_sorted
    return out


def seg_scan(op: str, v: torch.Tensor, newseg: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan of int32 `v` over runs delimited by
    `newseg` (True at each run's first element), op "add" (wrapping) or
    "max". The sum is the global cumsum less its value before the run;
    the max is a cummax over keys offset by run number, so no run sees
    an earlier one."""
    n = v.shape[0]
    if n == 0:
        return v.clone()
    if op == "add":
        idx = torch.arange(n, device=v.device)
        start = torch.cummax(torch.where(newseg, idx, 0), dim=0).values
        c = torch.cumsum(v, 0, dtype=torch.int32)
        base = torch.where(start > 0, c[(start - 1).clamp(min=0)], 0)
        return (c - base).to(torch.int32)
    if op == "max":
        run = torch.cumsum(newseg.to(torch.int64), 0) - 1
        key = run * (1 << 33) + v.to(torch.int64) + (1 << 31)
        top = torch.cummax(key, dim=0).values
        return (top - run * (1 << 33) - (1 << 31)).to(torch.int32)
    raise ValueError(f"seg_scan: unknown op {op!r}")


# ---------------------------------------------------------------------------
# plain versions (the reference's formulas)
# ---------------------------------------------------------------------------

def instep_gate_plain(active: torch.Tensor, gate: QuotaGate) -> torch.Tensor:
    """bool [B]: the in-step alloc gate (runtime/fused.py:471-488)."""
    n_rules = gate.rule_ns.shape[0]
    if n_rules == 0:
        return torch.zeros_like(active)
    safe = torch.clamp(gate.rule_idx, 0, n_rules - 1).long()
    rn = gate.rule_ns[safe]
    ns_ok = (rn == gate.default_ns) | (rn == gate.req_ns)
    rows = torch.arange(active.shape[0], device=active.device)
    return active & (gate.rule_idx >= 0) & ns_ok & (gate.status == 0) & \
        gate.matched[rows, safe]


def _roll_and_used(slots, buckets, ticks, last, rolling, active):
    """Roll every active rolling row's bucket in place (slots whose tick
    left the window go to 0; rows sharing a bucket zero the union of
    their slots, as the reference's multiply-scatter does) → used [B],
    the post-roll row sums."""
    k = slots.shape[1]
    p = torch.arange(k, dtype=torch.int32, device=slots.device)
    delta = torch.clamp(ticks - last, 0, k)
    delta = torch.where(rolling & active, delta, 0)
    zmask = ((p[None, :] - last[:, None] - 1) % k) < delta[:, None]
    b = buckets.long()
    uniq, inv = torch.unique(b, return_inverse=True)
    hits = torch.zeros((uniq.shape[0], k), dtype=torch.int32,
                       device=slots.device)
    hits.index_add_(0, inv, zmask.to(torch.int32))
    slots[uniq] = torch.where(hits > 0, 0, slots[uniq])
    return slots[b].sum(dim=1, dtype=torch.int32)


def _commit(slots, buckets, ticks, rolling, granted) -> None:
    col = torch.where(rolling, ticks % slots.shape[1], 0)
    slots.index_put_((buckets.long(), col.long()), granted.to(torch.int32),
                     accumulate=True)


def _grant(avail, amounts, best_effort, active):
    g_be = torch.clamp(torch.minimum(amounts, avail), min=0)
    # grants never go negative: without the amounts > 0 guard a negative
    # all-or-nothing amount would drain the counter
    g_ao = torch.where((avail >= amounts) & (amounts > 0), amounts, 0)
    return torch.where(active, torch.where(best_effort, g_be, g_ao),
                       0).to(torch.int32)


def _w32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _scan_grants(buckets, amounts, best_effort, max_amounts, active, used):
    """The sequential oracle: rows in stable bucket order, a consumed
    carry per bucket run (a Python loop over host copies)."""
    dev = buckets.device
    b, a, e, m, act, u = (x.cpu().numpy() for x in (
        buckets, amounts, best_effort, max_amounts, active, used))
    order = np.argsort(b, kind="stable")
    granted = np.zeros(b.shape[0], np.int32)
    consumed, prev = 0, None
    for i in order:
        if prev is None or b[i] != prev:
            consumed, prev = 0, b[i]
        if not act[i]:
            continue
        amt = int(a[i])
        avail = _w32(int(m[i]) - int(u[i]) - consumed)
        if e[i]:
            g = max(min(amt, avail), 0)
        else:
            g = amt if avail >= amt and amt > 0 else 0
        consumed = _w32(consumed + g)
        granted[i] = g
    return torch.from_numpy(granted).to(dev)


def _seg_grants(buckets, amounts, best_effort, max_amounts, active, used):
    """step_seg's closed form (istio_tpu/models/quota_alloc.py:230-311)."""
    b = buckets.shape[0]
    over = amounts > DOMAIN_MAX
    a_pos = torch.clamp(amounts, 0, DOMAIN_MAX)
    key_bucket = torch.where(active, buckets, _INT32_MAX)
    # lexsort((a_pos, best_effort, key_bucket)): stable sorts from the
    # least significant key
    order = torch.argsort(a_pos, stable=True)
    order = order[torch.argsort(best_effort[order].to(torch.int32),
                                stable=True)]
    order = order[torch.argsort(key_bucket[order], stable=True)]
    sb = key_bucket[order]
    sa = a_pos[order]
    sbe = best_effort[order]
    sact = active[order]
    sover = over[order]
    savail = (max_amounts - used)[order]
    newseg = torch.ones(b, dtype=torch.bool, device=buckets.device)
    newseg[1:] = sb[1:] != sb[:-1]
    ao = sact & ~sbe & ~sover
    cum_ao = seg_scan("add", torch.where(ao, sa, 0), newseg)
    grant_ao = ao & (sa > 0) & (cum_ao <= savail)
    consumed_ao = seg_scan("max", torch.where(grant_ao, cum_ao, 0), newseg)
    v_be = torch.where(sact & sbe, sa, 0)
    cum_be_before = seg_scan("add", v_be, newseg) - v_be
    rem_after_ao = torch.clamp(torch.clamp(savail, min=0) - consumed_ao,
                               min=0)
    g_be = torch.clamp(torch.minimum(sa, rem_after_ao - cum_be_before), min=0)
    sg = torch.where(grant_ao, sa,
                     torch.where(sact & sbe, g_be, 0)).to(torch.int32)
    granted = torch.zeros(b, dtype=torch.int32, device=buckets.device)
    granted[order] = sg
    return granted


def quota_alloc_plain(mode: str, slots: torch.Tensor, buckets, amounts,
                      best_effort, max_amounts, active, ticks, lasts, rolling,
                      gate: QuotaGate | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of the quota_alloc kernel: the same allocation, in
    place on `slots` int32 [n_buckets, K] → (granted int32 [B], the
    gate bool [B] or None). Flags may be bool or int."""
    if mode not in MODES:
        raise ValueError(f"quota_alloc: unknown mode {mode!r}")
    buckets, amounts, max_amounts, ticks, lasts = (
        x.to(torch.int32) for x in (buckets, amounts, max_amounts, ticks,
                                    lasts))
    best_effort, active, rolling = (x.to(torch.bool) for x in (
        best_effort, active, rolling))
    gated = None
    if gate is not None:
        gated = instep_gate_plain(active, gate)
        amounts = torch.where(gated, amounts, 0)
    used = _roll_and_used(slots, buckets, ticks, lasts, rolling, active)
    if mode == "fast":
        g = _grant(max_amounts - used, amounts, best_effort, active)
    elif mode == "unit":
        rank = batch_rank(torch.where(active, buckets, _INT32_MAX))
        g = (active & (rank < max_amounts - used)).to(torch.int32)
    elif mode == "seg":
        g = _seg_grants(buckets, amounts, best_effort, max_amounts, active,
                        used)
    else:
        g = _scan_grants(buckets, amounts, best_effort, max_amounts, active,
                         used)
    _commit(slots, buckets, ticks, rolling, torch.where(active, g, 0))
    return g, gated


# ---------------------------------------------------------------------------
# K9: quota_alloc (csrc/quota_alloc.cu)
# ---------------------------------------------------------------------------

def quota_alloc(mode: str, slots: torch.Tensor, buckets, amounts, best_effort,
                max_amounts, active, ticks, lasts, rolling,
                gate: QuotaGate | None = None,
                granted: torch.Tensor | None = None,
                gate_out: torch.Tensor | None = None) -> torch.Tensor:
    """Allocate one batch of B rows against `slots` int32 [n_buckets, K]
    IN PLACE → granted int32 [B] (written into `granted` when given).
    With `gate`, the in-step gate is applied and written as int32 0/1
    into `gate_out` (required then). Modes: "fast" (unique active
    buckets), "unit" (every active amount 1), "seg" (contended mixed
    amounts), "scan" (the sequential oracle). A unit or seg batch of up
    to CLUSTER_ROWS rows runs in one launch of a thread-block cluster and
    a scan batch of up to SCAN_BLOCK_ROWS in one block, with no scratch;
    a larger one runs on many blocks over a scratch buffer allocated
    here. CPU tensors run quota_alloc_plain."""
    if mode not in MODES:
        raise ValueError(f"quota_alloc: unknown mode {mode!r}")
    dev = slots.device
    b = int(buckets.shape[0])
    if gate is not None and gate_out is None:
        raise ValueError("quota_alloc: a gate needs gate_out")
    for name, out in (("granted", granted), ("gate_out", gate_out)):
        if out is not None and (out.dtype != torch.int32 or out.device != dev
                                or tuple(out.shape) != (b,)
                                or not out.is_contiguous()):
            raise ValueError(f"quota_alloc: {name} must be a contiguous "
                             f"int32 [{b}] tensor on {dev}")
    if dev.type == "cpu":
        g, gated = quota_alloc_plain(mode, slots, buckets, amounts,
                                     best_effort, max_amounts, active, ticks,
                                     lasts, rolling, gate)
        if gate_out is not None:
            gate_out.copy_(gated)
        return g if granted is None else granted.copy_(g)
    if dev.type != "cuda":
        raise ValueError(f"quota_alloc: unsupported device {dev}")
    if slots.dtype != torch.int32 or slots.dim() != 2 or \
            not slots.is_contiguous():
        raise ValueError("quota_alloc: slots must be a contiguous int32 "
                         "[n_buckets, K] tensor")
    rows = []
    for name, x in (("buckets", buckets), ("amounts", amounts),
                    ("best_effort", best_effort),
                    ("max_amounts", max_amounts), ("active", active),
                    ("ticks", ticks), ("lasts", lasts),
                    ("rolling", rolling)):
        if x.device != dev or tuple(x.shape) != (b,):
            raise ValueError(f"quota_alloc: {name} must be a [{b}] tensor "
                             f"on {dev}")
        rows.append(x.to(torch.int32).contiguous())
    n_rules, gate_args = 0, [None] * 5 + [0]
    if gate is not None:
        n_rules = int(gate.rule_ns.shape[0])
        want = {"status": (gate.status, torch.int32, (b,)),
                "matched": (gate.matched, torch.bool, (b, n_rules)),
                "rule_idx": (gate.rule_idx, torch.int32, (b,)),
                "rule_ns": (gate.rule_ns, torch.int32, (n_rules,)),
                "req_ns": (gate.req_ns, torch.int32, (b,))}
        for name, (x, dt, shape) in want.items():
            if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                    or not x.is_contiguous():
                raise ValueError(f"quota_alloc: gate.{name} must be a "
                                 f"contiguous {dt} {shape} tensor on {dev}")
        gate_args = [gate.status, gate.matched, gate.rule_idx, gate.rule_ns,
                     gate.req_ns, gate.default_ns]
    if granted is None:
        granted = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return granted
    # a captured launch keeps the plane it started from, so a check can
    # replay the kernel and its plain version on the same state
    before = slots.clone() if kernels.launches.captured is not None else None
    p = kernels.ptr
    scratch = None
    if b > (SCAN_BLOCK_ROWS if mode == "scan" else CLUSTER_ROWS) and \
            mode != "fast":
        n_scratch = kernels.function(
            "quota_alloc", "quota_alloc_scratch_bytes",
            [_K.I32, _K.I32])(b, MODES[mode])
        scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    fn = kernels.function("quota_alloc", "quota_alloc", _ALLOC_ARGS)
    st, mt, ri, rn, rq, dns = gate_args
    rc = fn(p(slots), int(slots.shape[0]), int(slots.shape[1]),
            *(p(x) for x in rows), b, MODES[mode],
            None if st is None else p(st), None if mt is None else p(mt),
            n_rules, None if ri is None else p(ri),
            None if rn is None else p(rn), None if rq is None else p(rq),
            int(dns), p(granted), None if gate_out is None else p(gate_out),
            None if scratch is None else p(scratch),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("quota_alloc", kernels.check(rc, "quota_alloc"), mode,
                     before, *rows, gate)
    return granted


_K = kernels
_ALLOC_ARGS = ([_K.VP, _K.I32, _K.I32] + [_K.VP] * 8      # slots, rows
               + [_K.I32, _K.I32]                           # B, mode
               + [_K.VP, _K.VP, _K.I32, _K.VP, _K.VP, _K.VP, _K.I32]  # gate
               + [_K.VP, _K.VP, _K.VP, _K.VP])      # outs, scratch, stream


# ---------------------------------------------------------------------------
# the reference's factories
# ---------------------------------------------------------------------------

def _as(x: Any, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device)


def make_alloc_step(n_buckets: int):
    """→ (scan_fn, fast_fn), each fn(counts[i32 n_buckets], buckets[i32 B],
    amounts[i32 B], best_effort[bool B], max_amounts[i32 B],
    active[bool B]) → (granted[i32 B], new_counts). Fixed counters: the
    rolling kernel at K = 1 with no row rolling. fast_fn is exact only
    for batches with no duplicate active bucket."""

    def make(mode: str):
        def fn(counts, buckets, amounts, best_effort, max_amounts, active):
            counts = torch.as_tensor(counts)
            if tuple(counts.shape) != (n_buckets,):
                raise ValueError(f"counts must be [{n_buckets}]")
            new = counts.to(torch.int32).clone()
            zero = torch.zeros(int(np.shape(buckets)[0]), dtype=torch.int32,
                               device=new.device)
            g = quota_alloc(mode, new.view(n_buckets, 1), _as(buckets, new),
                            _as(amounts, new), _as(best_effort, new),
                            _as(max_amounts, new), _as(active, new), zero,
                            zero, zero)
            return g, new
        return fn

    return make("scan"), make("fast")


def make_rolling_alloc_step(n_buckets: int, k_ticks: int):
    """Rolling-window variant: counters are per-(bucket, tick-slot) planes
    [n_buckets, K]; a batch first ROLLS each touched bucket (reclaiming
    slots whose ticks left the window — memquota.go rollingWindow.roll),
    then allocates against avail = max - sum(live slots) and commits
    grants into the current tick's slot (rollingWindow.alloc :118).

    → (scan_fn, fast_fn, unit_fn, seg_fn), each
    fn(slots[i32 n_buckets×K], buckets[i32 B], amounts[i32 B],
       best_effort[bool B], max_amounts[i32 B], active[bool B],
       ticks[i32 B], last_ticks[i32 B], rolling[bool B])
    → (granted[i32 B], new_slots). scan_fn is the sequential parity
    oracle; fast_fn needs unique active buckets, unit_fn all-ones amounts,
    seg_fn handles any contended mixed batch (intra-window order: bucket,
    all-or-nothing before best-effort, amount ascending, then arrival).
    seg_fn's PRECONDITION, as the reference's: max_amounts is uniform
    within each bucket run."""

    def make(mode: str):
        def fn(slots, buckets, amounts, best_effort, max_amounts, active,
               ticks, last_ticks, rolling):
            slots = torch.as_tensor(slots)
            if tuple(slots.shape) != (n_buckets, k_ticks):
                raise ValueError(f"slots must be [{n_buckets}, {k_ticks}]")
            new = slots.to(torch.int32).clone()
            g = quota_alloc(mode, new, _as(buckets, new), _as(amounts, new),
                            _as(best_effort, new), _as(max_amounts, new),
                            _as(active, new), _as(ticks, new),
                            _as(last_ticks, new), _as(rolling, new))
            return g, new
        return fn

    return make("scan"), make("fast"), make("unit"), make("seg")
