#!/usr/bin/env python3
"""Drive the port's served Check(), Report() and Quota() paths, Pilot's route
selection and discovery service, and their kernels on one NVIDIA H100.

    python3 chip_smoke.py            (from the root of a checkout)

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and torch / CUDA versions;
  2. build every kernel of istio_tpu_torch/csrc/ with nvcc (in parallel);
  3. at the headline world (make_engine(10_000, with_quota=True), B=2048)
     record what the main path hands each kernel, on two traffics: the
     headline traffic of bench.py (workloads.make_bags +
     make_request_ns) and make_hit_requests (aimed at deny, list and
     quota rules, so that every branch of the fold runs). Hold each
     kernel against its plain PyTorch version on both (exact equality);
     on the headline traffic also time both (profiler device time and
     CUDA events) and compute each kernel's bound; then (3b) hold every
     kernel against its plain version on edge-case inputs neither
     traffic produces;
  4. end to end at B ∈ {64, 256, 2048}: three consecutive batches of
     each traffic with quota carried, every verdict field and the quota
     counters equal to the plain path (the same engine on the CPU) run
     from the same state; an engine with small quotas must hit
     RESOURCE_EXHAUSTED; the matched / err planes agree with the
     expression oracle on a sample; device step ms and checks/s on the
     headline traffic; the launch counters, zeroed just before this
     phase, must show every kernel ran;
  5. the served Check() path (this slice's main path): the port's
     RuntimeServer over make_store(10_000) on the card answers
     check_many(make_bags(B)) for B ∈ {64, 256, 2048}; its responses
     equal a device="cpu" server's on B=256 samples of the headline and
     the hit traffic, and so do the rule counts its rule-stats drainer
     and aggregator keep; every timed loop's counts equal its repeat
     count times the plain server's for its batch; served walls (p50 /
     p99), checks/s, device busy, idle share, the host stage breakdown
     and kernel calls / grids per served step are printed; the launch
     counters, zeroed just before this phase, must show all six kernels
     ran. Then (5c) a config swap through the store watch: the new plan
     is warmed and published, the next batch runs on the card and
     equals the CPU server, and no rule count is lost across the
     publish (launch counters zeroed before it and read after). Then
     (5b) every kernel
     against its plain version on the served path's own inputs at
     B=2048 (timed, with its bound: the kernels table), and check_pack /
     rule_stats on edge inputs (W > 1, C > 32, bit 31, padding rows,
     unknown namespaces, a served host-overlay world);
  6. the authz world (BASELINE config 2): make_rbac_store(1000) — one
     authorization rule whose rbac policy lowers to ~1,000 pseudo-rule
     rows — served on the card under MESH_MANIFEST against a
     device="cpu" server at B ∈ {64, 256, 2048} of
     make_rbac_request_dicts (responses and rule counts exact, the
     denied fraction printed), timed like phase 5; K1, K3, K4, K5, K6
     and atom_eval (the 306 check atoms as op programs) held against
     their plain versions on its B=2048 inputs (timed); counters zeroed
     before, every kernel of the path must launch, and atom_eval exactly
     once per step; then (6b) atom_eval against its plain versions on
     the atom world (every BOOL expression of the port's copy of the
     conformance corpus that lowers on the device, over the corpus
     inputs tiled to B=2048) and on edge atoms (runtime and constant
     patterns, strings at the cap, NaN and malformed order keys, a
     narrowed byte plane, operand swaps, a 40-deep LAND chain);
  7. the list world (tests/test_fused_serving.py's store, rebuilt here
     with the port's MemStore): REGEX and CIDR lists fused beside STRINGS
     lists and deniers, served on the card against the CPU server on
     bags that hit the regex prefix, a truncated path, IPv4, IPv6,
     v4-mapped IPv6, malformed IP lengths and an absent source.ip; every
     kernel must launch (list_banks among them) and is held against its
     plain version on the B=2048 inputs (timed: the list_banks row);
     then (7b) list_banks on random inputs at B=2048 (64 REGEX lists
     over 256 patterns with truncated rows, 64 CIDR lists x 16 entries);
  8. the report path (this slice's main path): the telemetry world —
     make_store(10_000) plus Istio's default Mixer telemetry config
     (telemetry_world: six metrics into prometheus, the accesslog into a
     noop sink; 10,005 rules, 8 lowered report instances, F = 60 field
     programs) — served through the port's RuntimeServer.report on the
     card against a device="cpu" server, capture sinks in place of both
     report handlers: the delivered instances equal in order and the
     prometheus series equal at B ∈ {64, 256, 2048}; one field_eval
     launch and one device-to-host copy per report trip, no rule-
     telemetry fold and unchanged rule counts; report() timed (p50 /
     p99, records/s, the five report stages, device busy and idle
     share); field_eval (every field an op program, no LEAF rows) held
     against its plain versions on the B=2048 trip's inputs (timed: its
     kernels-table row), then (8b) on edge inputs (every opcode, F = 0 /
     1 / 22 / 33, empty rows, ephemeral ids, full and narrowed byte
     planes);
  9. the Quota() path (this slice's main path): the quota world —
     make_store(10_000) with its memquota limit set to the default quota
     of Istio's Bookinfo rate-limit sample (5,000 per 1 s window) — on
     the card against a device="cpu" server, each pool on an injected
     clock: 100,000 unique users fill the keymap (classic path, fast-mode
     flushes), then zipf(1.3) users at amount 1 through check_many +
     quota_fused (unit-mode flushes) and through
     check_batch_quota_instep, and at amounts 1-5 in-step (the seg kernel
     gated on the verdict), B in {64, 256, 2048}: every CheckResponse and
     QuotaResult equal; mixed-amount classic flushes on the card alone;
     one quota_alloc launch per flush and per in-step trip; the plane
     reads back the grants of each key's window and no key gets more
     than 5,000 in one; quota_alloc against its plain version on a
     captured trip of every mode and the scan on a captured seg batch
     (timed), then (9b) on edge inputs; walls of both paths, busy and
     idle share, quota_alloc per mode at 512 and 2048 rows; then (9c)
     the multi-block quota_alloc above the one-block path's 8,192 rows:
     against its plain version at 8,193 and 32,768 rows in unit, seg,
     scan and gated seg on zipf keys (the hottest key's run spans
     several scan tiles), timed with its grids and bound, and an
     in-step trip of 16,384 rows on a ServerArgs(max_batch=16384)
     server warmed at a 16,384 bucket, equal to a CPU server result by
     result, with conservation on the card's plane;
  10. Pilot's route selection (BASELINE config 3): make_route_world
     (10_000) — 1,000 services, 10,000 route rules — in a RouteTable on
     the card against one on the CPU at B in {64, 256, 2048, 8192} of
     make_route_requests: selects index-equal to the CPU table and to
     select_host on 256 rows per B, the compact select (K10's
     route_densify) equal to the dense one, H2D bytes of both, exactly
     one rule_match, one atom_eval (the cookie-fallback atoms) and one
     route_winner launch per dense select and one more route_densify
     per compact one; p50 / p99, busy and idle share;
     every kernel of the B=2048 selects held against its plain version
     (timed), then (10b) route_winner / route_densify on edge inputs and
     a host-fallback world;
  11. Pilot's discovery service at bench.py's fleet (10,000 sidecars,
     2,500 route rules): a DiscoveryService on the card against one on
     the CPU, every sidecar's RDS byte-equal cold and warm, CDS / LDS /
     SDS for one node per namespace, the same node groups, 8 rounds of
     one-namespace churn with every RDS equal after each and the scope
     program carried while its digest holds; one rule_match launch per
     batched generation; cold / warm poll rates and the route_eval
     stage;
  12. print the kernels JSON line, the card line, and last the device
     line {"ok": true, "device": {...}}.
Exits non-zero, with no result line, when CUDA is absent or the package
is not beside this script.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

HEADLINE_RULES = 10_000
# the kernels of PolicyEngine.step (phases 3-4); the served path adds
# check_pack and rule_stats; the authz world (phase 6) runs no regex, the
# list world (phase 7) adds list_banks, and the report path (phase 8)
# runs the engine, check_pack and field_eval (REPORT_KERNELS)
ENGINE_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold")
SERVED_KERNELS = ENGINE_KERNELS + ("check_pack", "rule_stats")
AUTHZ_KERNELS = ("rule_match", "byte_pred", "verdict_fold", "check_pack",
                 "rule_stats", "atom_eval")
LIST_KERNELS = SERVED_KERNELS + ("list_banks",)
AUTHZ_ROLE_RULES = 1000     # BASELINE config 2: make_rbac_store(1000)
HEADLINE_B = 2048
E2E_BATCHES = (64, 256, 2048)
N_STEPS = 3                 # consecutive batches with quota carried
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT32_LANES_PER_SM = 64     # Hopper: one simple int32 op per lane per clock
OK, RESOURCE_EXHAUSTED = 0, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def int_ops_per_s() -> tuple[float, str]:
    """Peak simple int32 ops/s of card 0: INT32 lanes × SMs × the
    maximum SM clock (an add or compare is one op; the published
    67 TFLOP/s float32 rate counts an FMA as two on twice the lanes)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    rate = INT32_LANES_PER_SM * sms * mhz * 1e6
    return rate, f"{INT32_LANES_PER_SM} lanes x {sms} SMs x {mhz:.0f} MHz"


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of fn over `iters` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float | None:
    """Mean device time per call of fn: the sum of every kernel and copy
    the profiler saw on the card during `iters` calls, over iters. None
    when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


def timed(fn, iters: int) -> tuple[float, float, str]:
    """→ (ms, call_ms, source): call_ms is CUDA-event time per call of a
    back-to-back loop (host launch cost included); ms is the profiler's
    device time per call, or call_ms where the profiler saw none."""
    call = time_ms(fn, iters)
    dev = device_ms(fn, max(iters // 5, 2))
    return (dev, call, "profiler") if dev is not None else \
        (call, call, "cuda_events")


def assert_equal(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, dtype {got.dtype} vs "
                             f"{want.dtype})")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def bound(bytes_moved: float, ops: float, int_rate: float
          ) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_work(matched, req, batch, params, c, quota0, quota1, got,
              lstate=None, list_kind=None) -> tuple[float, float]:
    """(bytes, ops) the verdict fold must move and do on this run's
    data. A request row reads, of the rules its namespace sees, the
    matched cells of the rules that carry a fused action (deny, list,
    rbac, quota) and the err cells of the rules the error count covers;
    the columns its RBAC specs' allow and guard rows name; the per-rule
    tables of the rules any row sees, the batch columns the list and
    quota banks name, the list-state bytes of its byte-level lists, and
    one read per quota counter an active row keys into plus one write
    per counter that changed (quota1 vs quota0); got is the fold's
    output."""
    import torch
    status = got[0]
    rule_ns = params["pe_rule_ns"]
    n_rules = rule_ns.shape[0]
    ns_ok = (rule_ns[None, :] == c.default_ns) | \
        (rule_ns[None, :] == req[:, None])
    active = matched & ns_ok
    acting = params["pe_deny_mask"].clone()
    if c.has_lists:
        acting[params["pe_list_rule"].long()] = True
    if c.has_rbac:
        acting[params["pe_rb_rule"].long()] = True
    if c.has_quota:
        acting[params["pe_q_rule"].long()] = True
    counted = params.get("pe_err_rule_mask")
    counted = torch.ones_like(acting) if counted is None else counted
    cells = int(ns_ok.sum())
    m_cells = int((ns_ok & acting[None, :]).sum())
    e_cells = int((ns_ok & counted[None, :]).sum())
    seen = int(ns_ok.any(0).sum())
    per_rule = [params[k] for k in ("pe_deny_mask", "pe_deny_status",
                                    "pe_deny_dur", "pe_deny_uses",
                                    "pe_err_rule_mask")
                if params.get(k) is not None]
    nb = matched.shape[0]
    b = nbytes(req, rule_ns, params["pe_ref_table"], *got) * 1.0
    b += m_cells + e_cells + seen * sum(t.element_size() for t in per_rule)
    ops = 2.0 * cells + m_cells + e_cells
    if c.has_rbac:
        cols = torch.cat([params["pe_rb_allow"].reshape(-1),
                          params["pe_rb_guard"]])
        n_cols = int(torch.unique(cols[cols < n_rules]).numel())
        b += nb * n_cols + nbytes(*(params[k] for k in (
            "pe_rb_rule", "pe_rb_dur", "pe_rb_guard", "pe_rb_allow")))
        ops += float(nb) * (params["pe_rb_allow"].numel() + 8 *
                            params["pe_rb_rule"].numel())
    if lstate is not None:
        b += nbytes(lstate)
    slots_p: set[int] = set()
    if c.has_lists:
        b += nbytes(*(params[k] for k in (
            "pe_list_ids", "pe_list_rule", "pe_list_slot", "pe_list_black",
            "pe_list_code", "pe_list_dur", "pe_list_uses")))
        l_slot = params["pe_list_slot"].long()
        slots = set(l_slot.tolist())
        slots_p |= slots
        b += nb * len(slots) * batch.ids.element_size()
        l_act = active[:, params["pe_list_rule"].long()] & \
            batch.present[:, l_slot]
        scan = torch.full_like(l_slot, params["pe_list_ids"].shape[1])
        if lstate is not None:      # a state byte, not an id scan
            scan = torch.where(list_kind != 0, 2, scan)
        ops += float((l_act.double() * scan.double()[None, :]).sum())
    if c.has_quota:
        if bool((params["pe_deny_status"] == RESOURCE_EXHAUSTED).any()) or \
                bool((params["pe_list_code"] == RESOURCE_EXHAUSTED).any()):
            raise AssertionError("fold_work: a deny or list status is "
                                 "RESOURCE_EXHAUSTED; quota rows unknown")
        q_slot = params["pe_q_slot"].long()
        b += nbytes(*(params[k] for k in (
            "pe_q_rule", "pe_q_slot", "pe_q_max", "pe_q_nb")))
        slots = set(q_slot.tolist())
        slots_p |= slots
        b += nb * len(slots) * batch.hash_ids.element_size()
        pre_ok = (status == OK) | (status == RESOURCE_EXHAUSTED)
        q_act = active[:, params["pe_q_rule"].long()] & \
            batch.present[:, q_slot] & pre_ok[:, None]
        n_q, n_b = quota0.shape
        key = torch.remainder(batch.hash_ids[:, q_slot],
                              params["pe_q_nb"][None, :]) + \
            torch.arange(n_q, device=quota0.device)[None, :] * n_b
        reads = int(torch.unique(key[q_act]).numel())
        writes = int((quota1 != quota0).sum())
        b += (reads + writes) * quota0.element_size()
        per_q = q_act.sum(0).double()
        ops += float((per_q * (per_q - 1) / 2).sum()) + float(per_q.sum())
    b += nb * len(slots_p) * batch.present.element_size()
    return b, ops


def pack_work(inputs, got) -> tuple[float, float]:
    """(bytes, ops) check_pack must move and do on this run's data: a
    row reads the matched cells of the rules its namespace sees (the
    item ORs) and of the overlay columns, the per-rule namespace and
    mask words once, its verdict head and referenced bytes, and writes
    its packed column."""
    status, dur, uses, deny_rule, err_count, referenced, matched, req, t = \
        inputs
    ns_ok = (t.rule_ns[None, :] == t.default_ns) | \
        (t.rule_ns[None, :] == req[:, None])
    cells = float(ns_ok.sum())
    nb = matched.shape[0]
    n_ov = int(t.cols.numel())
    words = int(t.inst_bits.shape[1] + t.pred_bits.shape[1]) \
        if t.n_items else 0
    b = cells + nb * n_ov + nbytes(t.rule_ns, t.cols, status, dur, uses,
                                   deny_rule, err_count, req, got)
    b += int(t.rule_ns.numel()) * words * 4 + nb * t.n_cols
    ops = cells * (2 + words) + nb * (n_ov + t.n_words * 32)
    return b, ops


def rulestats_zeros(inputs):
    """Fresh (hit, deny, err) accumulators for a captured rule_stats
    launch."""
    import torch
    matched, n_slots = inputs[0], inputs[8]
    dev, r = matched.device, matched.shape[1]
    return (torch.zeros((n_slots, r), dtype=torch.int32, device=dev),
            torch.zeros((n_slots, r), dtype=torch.int32, device=dev),
            torch.zeros(r, dtype=torch.int32, device=dev))


def stats_work(inputs, delta) -> tuple[float, float]:
    """(bytes, ops) rule_stats must move and do on this run's data: the
    matched and err cells of the rules each real row's namespace sees,
    the per-rule tables once, the per-row verdict inputs, and a 4-byte
    read plus a 4-byte write of every accumulator cell the batch
    changes (delta: the batch's counts from zero)."""
    (matched, err, status, deny_rule, req, real, rule_ns, default_ns,
     n_slots, err_rows) = inputs
    ns_ok = (rule_ns[None, :] == default_ns) | \
        (rule_ns[None, :] == req[:, None])
    cells = float((ns_ok & real[:, None]).sum())
    touched = sum(int((d != 0).sum()) for d in delta)
    b = 2 * cells + nbytes(rule_ns, err_rows, status, deny_rule, req,
                           real) + 8 * touched
    ops = 4 * cells + 4 * matched.shape[0]
    return b, ops


def stats_library_ms(inputs) -> tuple[float, str]:
    """Time of one PyTorch call computing the hit fold of rule_stats
    (the [S, B] x [B, R] one-hot product of the reference's delta) on
    this launch's inputs: torch._int_mm on int8, or index_add_ where
    _int_mm refuses the shapes."""
    import torch
    (matched, err, status, deny_rule, req, real, rule_ns, default_ns,
     n_slots, err_rows) = inputs
    ns_ok = (rule_ns[None, :] == default_ns) | \
        (rule_ns[None, :] == req[:, None])
    active = (matched & ns_ok & real[:, None])
    slot = torch.where(req < 0, n_slots - 1, req.clamp(0, n_slots - 1))
    onehot = (slot[None, :] == torch.arange(
        n_slots, device=req.device)[:, None]).to(torch.int8)
    a8 = active.to(torch.int8)
    try:
        torch._int_mm(onehot, a8)
        torch.cuda.synchronize()
        return time_ms(lambda: torch._int_mm(onehot, a8), 50), \
            "torch._int_mm of the hit product"
    except RuntimeError:
        hit = torch.zeros((n_slots, matched.shape[1]), dtype=torch.int32,
                          device=matched.device)
        ai = active.to(torch.int32)
        sl = slot.long()
        return time_ms(lambda: hit.index_add_(0, sl, ai), 50), \
            "index_add_ of the hit plane"


def int_mm_ms(a, b01) -> tuple[float | None, str]:
    """Time of one torch._int_mm of the 0/1 planes a [m, k] and b01
    [k, n] as int8, zero-padded to the shapes it accepts (m > 16, k and
    n multiples of 8); None when it refuses them."""
    import torch
    m, k = a.shape
    n = b01.shape[1]
    up = lambda x, q: max(q, -(-x // q) * q)  # noqa: E731
    a8 = torch.zeros((max(m, 32), up(k, 16)), dtype=torch.int8,
                     device=a.device)
    a8[:m, :k] = a.to(torch.int8)
    b8 = torch.zeros((up(k, 16), up(n, 16)), dtype=torch.int8,
                     device=a.device)
    b8[:k, :n] = b01.to(torch.int8)
    try:
        torch._int_mm(a8, b8)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, f"torch._int_mm refused the shapes ({exc})"
    return time_ms(lambda: torch._int_mm(a8, b8), 50), \
        f"torch._int_mm int8 [{a8.shape[0]}, {a8.shape[1]}] x " \
        f"[{b8.shape[0]}, {b8.shape[1]}]"


def rbac_library_ms(matched, params) -> tuple[float | None, str]:
    """The RBAC allow product of the verdict fold as one library call:
    matched int8 [B, R] x the specs' one-hot allow matrix [R, n_rbac]."""
    import torch
    n_rules = matched.shape[1]
    allow = params["pe_rb_allow"].long()
    onehot = torch.zeros((n_rules + 2, allow.shape[0]), dtype=torch.bool,
                         device=matched.device)
    onehot[allow, torch.arange(allow.shape[0],
                               device=matched.device)[:, None]] = True
    ms, how = int_mm_ms(matched, onehot[:n_rules])
    return ms, how + " (RBAC allow product only)"


def list_work(inputs, lstate, err) -> tuple[float, float]:
    """(bytes, ops) a list_banks call must move and do on this run's
    data. regex_list: each (row, list) reads the acceptance bytes of the
    list's patterns and the value's length, writes its state byte, and
    an err byte where und holds; cidr_list: each (row, list) reads the
    value's 16 bytes and length and writes its state byte, and compares
    (32 byte ops) every valid entry of the value's IP version up to the
    first hit. The tables are read once."""
    import torch
    if inputs[0] == "regex_list":
        _, acc, str_lens, max_len, lists, _, _ = inputs
        pos, rule, bslot, ptr, pat, pdef = lists.on(acc.device)
        nb, nnz, j = acc.shape[0], pat.numel(), lists.n
        und = int(((lstate[:, pos.long()] & 2) != 0).sum())
        b = nb * (nnz + 5 * j) + und + nbytes(pos, rule, bslot, ptr, pat,
                                              pdef)
        return float(b), float(nb) * (nnz + 4 * j)
    _, str_bytes, str_lens, lists, _ = inputs
    pos, bslot, prefix, mask, valid, ent_v4 = lists.on(str_bytes.device)
    nb, k = str_bytes.shape[0], lists.n
    sl = bslot.long()
    vb = str_bytes[:, sl, :16]
    vl = str_lens[:, sl]
    is4 = vl == 4
    v4m = torch.tensor([0] * 10 + [255, 255], dtype=torch.uint8,
                       device=vb.device)
    val_v4 = is4 | ((vl == 16) & (vb[:, :, :12] == v4m).all(dim=2))
    mapped = torch.cat([v4m.expand(nb, k, 12), vb[:, :, :4]], dim=2)
    v = torch.where(is4[:, :, None], mapped, vb)
    cand = valid[None] & (ent_v4[None] == val_v4[:, :, None])  # [B, K, E]
    hit = cand & ((v[:, :, None, :] & mask[None]) == prefix[None]).all(3)
    first = torch.where(hit.any(2), hit.to(torch.int8).argmax(2) + 1,
                        hit.shape[2])
    upto = torch.arange(hit.shape[2], device=hit.device)[None, None, :] \
        < first[:, :, None]
    compared = int((cand & upto).sum())
    b = nb * k * 21 + nbytes(pos, bslot, prefix, mask, valid, ent_v4)
    return float(b), float(nb * k * 16 + 32 * compared)


def check_kernels(captured: list, quota0, int_rate: float | None = None
                  ) -> list[dict]:
    """Phase 3: every captured launch, kernel vs plain (exact equality).
    With int_rate, also time both and compute each kernel's bound →
    the kernels table rows. quota0 is the quota state the captured
    verdict_fold launch started from."""
    import torch
    from istio_tpu_torch.compiler import ruleset
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.ops import bytes_ops, field_ops, route_ops
    from istio_tpu_torch.runtime import fused, rulestats

    rows: dict[str, dict] = {}
    for idx, (name, inputs) in enumerate(captured):
        tag = f"{name}#{idx}"
        lib, lib_call = None, None
        extra: dict = {}
        if name == "dfa_scan":
            data, lens, bank = inputs
            table, class_of, starts, accept = bank.on(data.device)
            got = bytes_ops.dfa_scan(data, lens, bank)
            want = bytes_ops.dfa_scan_plain(data, lens, table, class_of,
                                            starts, accept)
            assert_equal(tag, got, want)
            if int_rate is None:
                continue
            ms, call, how = timed(
                lambda: bytes_ops.dfa_scan(data, lens, bank), 200)
            plain, _, _ = timed(lambda: bytes_ops.dfa_scan_plain(
                data, lens, table, class_of, starts, accept), 20)
            steps = int(torch.clamp(lens, 0, data.shape[1]).sum())
            b = steps + nbytes(lens, table, class_of, starts, accept, got)
            ops = 3.0 * steps * bank.n
            src, rep = "dfa_scan.cu", "istio_tpu/ops/bytes_ops.py:221"
            err = int((got != want).sum())
        elif name == "byte_pred":
            data, lens, pats = inputs
            p, pl, kd = pats.on(data.device)
            got = bytes_ops.byte_pred(data, lens, pats)
            want = bytes_ops.byte_pred_plain(data, lens, p, pl, kd)
            assert_equal(tag, got, want)
            if int_rate is None:
                continue
            ms, call, how = timed(
                lambda: bytes_ops.byte_pred(data, lens, pats), 200)
            plain, _, _ = timed(lambda: bytes_ops.byte_pred_plain(
                data, lens, p, pl, kd), 20)
            row_bytes = int(torch.clamp(lens, 0, data.shape[1]).sum())
            if bool((kd == bytes_ops.EXACT).any()):
                row_bytes = data.shape[0] * data.shape[1]
            b = row_bytes + nbytes(lens, p, pl, kd, got)
            ops = float(data.shape[0]) * float(pl.sum())
            src, rep = "byte_pred.cu", "istio_tpu/ops/bytes_ops.py:26"
            err = int((got != want).sum())
        elif name == "rule_match":
            ids, present, em, en, params, c = inputs
            got = ruleset.rule_match(ids, present, em, en, params, c)
            want = ruleset.rule_match_plain(ids, present, em, en, params, c)
            for part, g, w in zip(("matched", "not_matched", "err"), got,
                                  want):
                assert_equal(f"{tag}.{part}", g, w)
            if int_rate is None:
                continue
            ms, call, how = timed(lambda: ruleset.rule_match(
                ids, present, em, en, params, c), 50)
            plain, _, _ = timed(lambda: ruleset.rule_match_plain(
                ids, present, em, en, params, c), 10)
            tabs = [params[k] for k in ("eqc_col", "eqc_cid", "eqc_xor",
                                        "eqc_pad", "lit_idx", "conj_m_idx",
                                        "conj_n_idx")]
            b = nbytes(ids, present, em, en, *tabs, c.eq_cols, c.eq_cids,
                       c.eq_neg, c.ss_a, c.ss_b, c.ss_neg, *got)
            nb = ids.shape[0]
            ops = float(nb) * (params["eqc_col"].numel() * 3 +
                               params["lit_idx"].numel() +
                               2 * params["conj_m_idx"].numel() +
                               3 * params["conj_m_idx"].shape[0])
            src, rep = "rule_match.cu", "istio_tpu/compiler/ruleset.py:798"
            err = int(sum(int((g != w).sum()) for g, w in zip(got, want)))
        elif name == "verdict_fold":
            matched, errp, req, batch, params, _, c, lstate, kind = inputs
            qk, qp = quota0.clone(), quota0.clone()
            got = pe.verdict_fold(matched, errp, req, batch, params, qk, c,
                                  lstate, kind)
            want = pe.verdict_fold_plain(matched, errp, req, batch, params,
                                         qp, c, lstate, kind)
            for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                                   "referenced", "err_count"), got, want):
                assert_equal(f"{tag}.{part}", g, w)
            assert_equal(f"{tag}.quota_counts", qk, qp)
            if int_rate is None:
                continue
            scratch = quota0.clone()
            ms, call, how = timed(lambda: pe.verdict_fold(
                matched, errp, req, batch, params, scratch, c, lstate,
                kind), 50)
            plain, _, _ = timed(lambda: pe.verdict_fold_plain(
                matched, errp, req, batch, params, scratch, c, lstate,
                kind), 10)
            b, ops = fold_work(matched, req, batch, params, c, quota0, qk,
                               got, lstate, kind)
            if c.has_rbac:
                lib, lib_call = rbac_library_ms(matched, params)
            src, rep = ("verdict_fold.cu",
                        "istio_tpu/models/policy_engine.py:379")
            err = int(sum(int((g.float() != w.float()).sum())
                          for g, w in zip(got, want)))
        elif name == "check_pack":
            got = fused.check_pack(*inputs)
            want = fused.check_pack_plain(*inputs)
            assert_equal(tag, got, want)
            if int_rate is None:
                continue
            ms, call, how = timed(lambda: fused.check_pack(*inputs), 200)
            plain, _, _ = timed(lambda: fused.check_pack_plain(*inputs), 20)
            b, ops = pack_work(inputs, got)
            src, rep = "check_pack.cu", "istio_tpu/runtime/fused.py:315"
            err = int((got != want).sum())
        elif name == "rule_stats":
            accs = [rulestats_zeros(inputs) for _ in range(2)]
            rulestats.rule_stats(*inputs, *accs[0])
            rulestats.rule_stats_plain(*inputs, *accs[1])
            for part, g, w in zip(("hit", "deny", "err"), *accs):
                assert_equal(f"{tag}.{part}", g, w)
            if int_rate is None:
                continue
            scratch = rulestats_zeros(inputs)
            ms, call, how = timed(
                lambda: rulestats.rule_stats(*inputs, *scratch), 200)
            plain, _, _ = timed(
                lambda: rulestats.rule_stats_plain(*inputs, *scratch), 20)
            b, ops = stats_work(inputs, accs[1])
            lib, lib_call = stats_library_ms(inputs)
            src, rep = ("rule_stats.cu",
                        "istio_tpu/runtime/rulestats.py:165")
            err = int(sum(int((g != w).sum()) for g, w in zip(*accs)))
        elif name == "list_banks":
            kind, *args = inputs
            if kind == "regex_list":
                acc, sl, ml, lists, ls0, err0 = args
                run = lambda ls, e: bytes_ops.regex_list(  # noqa: E731
                    acc, sl, ml, lists, ls, e)
                run_plain = lambda ls, e: bytes_ops.regex_list_plain(  # noqa
                    acc, sl, ml, *lists.on(acc.device), ls, e)
            else:
                sb, sl, lists, ls0 = args
                err0 = torch.zeros(0, dtype=torch.bool, device=ls0.device)
                run = lambda ls, e: bytes_ops.cidr_list(  # noqa: E731
                    sb, sl, lists, ls)
                run_plain = lambda ls, e: bytes_ops.cidr_list_plain(  # noqa
                    sb, sl, *lists.on(sb.device), ls)
            # from a zero state plane and the err plane as captured
            outs = [(torch.zeros_like(ls0), err0.clone()) for _ in range(2)]
            run(*outs[0])
            run_plain(*outs[1])
            for part, g, w in zip(("lstate", "err"), *outs):
                assert_equal(f"{tag}.{kind}.{part}", g, w)
            if int_rate is None:
                continue
            scratch = (torch.zeros_like(ls0), err0.clone())
            ms, call, how = timed(lambda: run(*scratch), 200)
            plain, _, _ = timed(lambda: run_plain(*scratch), 20)
            b, ops = list_work(inputs, *outs[0])
            if kind == "regex_list":
                _, _, _, ptr, pat, _ = lists.on(acc.device)
                owner = torch.repeat_interleave(
                    torch.arange(lists.n, device=acc.device),
                    (ptr[1:] - ptr[:-1]).long())
                m01 = torch.zeros((acc.shape[1], lists.n), dtype=torch.bool,
                                  device=acc.device)
                m01[pat.long(), owner] = True
                lib, lib_call = int_mm_ms(acc, m01)
                lib_call += " (REGEX hit product only)"
            src, rep = ("list_banks.cu",
                        "istio_tpu/models/policy_engine.py:439")
            err = int(sum(int((g != w).sum()) for g, w in zip(*outs)))
        elif name == "field_eval":
            batch, prog = inputs
            got = field_ops.field_eval(batch, prog)
            want = field_ops.field_eval_plain(batch, prog)
            assert_equal(tag, got, want)
            assert_equal(f"{tag} (op table)", got,
                         field_ops.field_eval_ops_plain(batch, prog))
            if int_rate is None:
                continue
            ms, call, how = timed(
                lambda: field_ops.field_eval(batch, prog), 200)
            plain, _, _ = timed(
                lambda: field_ops.field_eval_plain(batch, prog), 20)
            b, ops = field_work(batch, prog, got)
            src, rep = ("field_eval.cu",
                        "istio_tpu/runtime/report_lower.py:73")
            err = int((got != want).sum())
        elif name == "atom_eval":
            batch, atoms, em, en = inputs
            got, want, ops_want = (
                (torch.zeros_like(em), torch.zeros_like(en))
                for _ in range(3))
            field_ops.atom_eval(batch, atoms, *got)
            field_ops.atom_eval_plain(batch, atoms, *want)
            field_ops.atom_eval_ops_plain(batch, atoms, *ops_want)
            for part, g, w, o in zip(("m", "n"), got, want, ops_want):
                assert_equal(f"{tag}.{part}", g, w)
                assert_equal(f"{tag}.{part} (op table)", g, o)
            if int_rate is None:
                continue
            scratch = (torch.zeros_like(em), torch.zeros_like(en))
            ms, call, how = timed(
                lambda: field_ops.atom_eval(batch, atoms, *scratch), 200)
            plain, _, _ = timed(lambda: field_ops.atom_eval_plain(
                batch, atoms, *scratch), 10)
            b, ops = atom_work(batch, atoms)
            extra["coalesced_store_ms"] = atom_store_probe(batch, atoms, got)
            log(f"  {tag:<16} the same launch with its m / n stores "
                "coalesced (a transposed [A, B] plane): "
                f"{extra['coalesced_store_ms']:.5f} ms")
            src, rep = "field_eval.cu", "istio_tpu/compiler/tensor_expr.py:291"
            err = int(sum(int((g != w).sum()) for g, w in zip(got, want)))
        elif name == "quota_alloc":
            mode, before, *qrows, gate = inputs
            tag = f"{name}.{mode}" + ("+gate" if gate is not None else "")
            if quota_alloc_check(tag, mode, before, qrows, gate) and \
                    mode == "seg":
                # the sequential oracle on the same captured seg batch
                quota_alloc_check(f"{tag}.scan", "scan", before, qrows, gate)
            if int_rate is None:
                continue
            ms, call, how, plain, b, ops, lib, lib_call = quota_alloc_times(
                mode, before, qrows, gate)
            src, rep = "quota_alloc.cu", QUOTA_REPLACES[
                "instep" if gate is not None else mode]
            err = 0
        elif name == "route_select":
            kind, *args = inputs
            tag = f"{name}.{kind}"
            err = 0
            if kind == "winner":
                matched, weight, default = args
                got = route_ops.route_winner(matched, weight, default)
                want = route_ops.route_winner_plain(matched, weight,
                                                    default)
                assert_equal(tag, got, want)
                if int_rate is None:
                    continue
                ms, call, how = timed(lambda: route_ops.route_winner(
                    matched, weight, default), 200)
                plain, _, _ = timed(lambda: route_ops.route_winner_plain(
                    matched, weight, default), 20)
                b = nbytes(matched, weight, got)
                ops = 2.0 * matched.numel()     # a select and a compare
                lib = time_ms(lambda: torch.max(
                    matched.int() * weight, dim=1), 50)
                lib_call = ("torch.max(matched.int() * weight, dim=1) "
                            "(the max only)")
                rep = "istio_tpu/pilot/route_nfa.py:115"
            else:
                flat, lens16, pres, n_cols, max_len = args
                got = route_ops.route_densify(flat, lens16, pres, n_cols,
                                              max_len)
                want = route_ops.route_densify_plain(flat, lens16, pres,
                                                     n_cols, max_len)
                for part, g, w in zip(("str_bytes", "str_lens", "present"),
                                      got, want):
                    assert_equal(f"{tag}.{part}", g, w)
                if int_rate is None:
                    continue
                ms, call, how = timed(lambda: route_ops.route_densify(
                    flat, lens16, pres, n_cols, max_len), 200)
                plain, _, _ = timed(lambda: route_ops.route_densify_plain(
                    flat, lens16, pres, n_cols, max_len), 20)
                # the flat bytes the lens cover, the lens and presence
                # in; the dense planes out
                b = int(lens16.int().clamp(min=0).sum()) + \
                    nbytes(lens16, pres, *got)
                ops = float(got[0].numel())     # one select per byte out
                flat_lens = lens16.reshape(-1).int()
                lib = time_ms(lambda: torch.cumsum(flat_lens, 0), 200)
                lib_call = "torch.cumsum of the lens (the offsets only)"
                rep = "istio_tpu/pilot/route_nfa.py:270"
            src = "route_select.cu"
        else:
            raise AssertionError(f"unknown kernel {name}")
        bms, by = bound(b, ops, int_rate)
        log(f"  {tag:<16} kernel {ms:9.5f} ms (per call incl. launch "
            f"{call:8.5f})   plain {plain:9.5f} ms   bound {bms:8.5f} ms "
            f"({by}; {b:.0f} B, {ops:.0f} ops)   equal: yes   [{how}]"
            + ("" if lib is None else
               f"   library {lib:9.5f} ms ({lib_call})"))
        row = rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": f"istio_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": 0, "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": by, "library_ms": lib,
            "library_call": lib_call,
            "calls_per_step": 0, "grid_launches": 0, "call_ms": 0.0,
            "ms_source": how, "bytes": 0.0, "ops": 0.0})
        # a kernel called more than once per step (byte_pred: one call
        # per subject) reports the sum over its calls, and the bound of
        # their summed work
        row["ms"] += ms
        row["call_ms"] += call
        row["plain_ms"] += plain
        row["bytes"] += b
        row["ops"] += ops
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"],
                                                 int_rate)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(extra)
        row["calls_per_step"] += 1
        if row["library_ms"] is None and lib is not None:
            row["library_ms"], row["library_call"] = lib, lib_call
    return list(rows.values())


def headline_batch(engine, b: int):
    """bench.py's Check() traffic: make_bags(b) and make_request_ns."""
    from istio_tpu_torch.testing import workloads
    return (workloads.make_bags(b),
            workloads.make_request_ns(engine, b))


def hit_batch(engine, n_rules: int, b: int, seed: int):
    import numpy as np
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.testing import workloads
    dicts, ns = workloads.make_hit_requests(n_rules, b, seed=seed)
    bags = [bag_from_mapping(d) for d in dicts]
    req = np.asarray([engine.ruleset.namespace_id(x) for x in ns], np.int32)
    return bags, req


FIELDS = ("status", "valid_duration_s", "valid_use_count", "referenced",
          "matched", "err", "deny_rule", "err_count")


def compare_step(gpu, cpu, bags, req, label: str):
    """One step of the kernel path (gpu engine) and the plain path (cpu
    engine) from the same quota state; → the gpu verdict."""
    import torch
    cpu.quota_counts.copy_(gpu.quota_counts.cpu())
    batch = gpu.tensorizer.tensorize(bags)
    vg = gpu.check(batch.to("cuda"), req)
    vc = cpu.check(batch, req)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert_equal(f"{label}.{f}", getattr(vg, f).cpu(), getattr(vc, f))
    assert_equal(f"{label}.quota_counts", gpu.quota_counts.cpu(),
                 cpu.quota_counts)
    for f in ("status", "valid_use_count", "deny_rule"):
        t = getattr(vg, f)
        assert t.shape == (len(bags),) and t.dtype == torch.int32, f
    assert bool(torch.isfinite(vg.valid_duration_s).all()), "TTL not finite"
    return vg


def oracle_sample(engine, bags, vg, n_rules: int) -> int:
    """matched / not-matched / err of sampled (rule, request) cells
    against the expression oracle; → cells checked."""
    import numpy as np
    from istio_tpu_torch.expr.oracle import OracleProgram
    from istio_tpu_torch.testing import workloads
    rng = np.random.default_rng(11)
    rules = workloads.make_rules(n_rules)
    matched = vg.matched.cpu().numpy()
    err = vg.err.cpu().numpy()
    n = 0
    for r in rng.integers(0, n_rules, size=40):
        prog = OracleProgram(rules[r].match, workloads.MESH_FINDER)
        for b in rng.integers(0, len(bags), size=8):
            try:
                want_m, want_e = bool(prog.evaluate(bags[b])), False
            except Exception:
                want_m, want_e = False, True
            got = (bool(matched[b, r]), bool(err[b, r]))
            if got != (want_m, want_e):
                raise AssertionError(f"rule {r} request {b}: device {got} "
                                     f"oracle {(want_m, want_e)}")
            n += 1
    return n


EDGE_RULES = [
    ("slot-eq", "source.name == destination.name", ""),
    ("slot-neq", 'source.name != destination.name && request.method == "GET"',
     ""),
    ("bytes-or", 'request.path.endsWith("/x") || '
     'request.host.startsWith("svc1")', "ns1"),
    ("exact-glob", 'match(request.host, "exact.host")', ""),
    ("anchored", '"/(a|b)+$".matches(request.path)', "ns2"),
    ("header", 'request.headers["cookie"] == "c1"', ""),
    ("fallback-chain", '(source.user | "anon") == "anon"', "ns1"),
    ("dyn-prefix", "request.path.startsWith(request.host)", ""),
    ("size", "request.size == 7", ""),
    ("always", "", ""),
    ("mtls", "connection.mtls", "ns2"),
    ("glob-suffix", 'match(request.host, "*.local")', ""),
]


def edge_bags(n: int, seed: int) -> tuple[list[dict], list[str]]:
    import numpy as np
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    out, ns = [], []
    for _ in range(n):
        d = {}
        for attr, vals in (
                ("source.name", ["a", "b", ""]),
                ("destination.name", ["a", "c"]),
                ("request.method", ["GET", "POST"]),
                ("request.path", ["/x", "/ab", "/aba", "svc1/x", "",
                                  "/" + "a" * 200, "/b/x"]),
                ("request.host", ["svc1", "exact.host", "a.local", "svc1.b",
                                  "h" * 130]),
                ("request.headers", [{"cookie": "c1"}, {"x": "y"}, {}]),
                ("source.user", ["anon", "u1", "u2"]),
                ("request.size", [7, 8]),
                ("connection.mtls", [True, False])):
            if rng.random() < 0.8:
                d[attr] = pick(vals)
        out.append(d)
        ns.append(pick(["", "ns1", "ns2", "nowhere"]))
    return out, ns


def edge_checks() -> int:
    """Phase 3b: each kernel against its plain version on inputs the
    headline world does not produce: exact globs, patterns longer than
    the row, a DFA bank too big for shared memory, slot-vs-slot atoms,
    an all-EQ and an empty ruleset, two lists on one rule, negative
    hash keys under the floor modulo, unknown namespaces. → cases."""
    import numpy as np
    import torch
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.compiler.ruleset import Rule
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.ops import bytes_ops, regex_dfa
    from istio_tpu_torch.testing import workloads

    n = 0
    rng = np.random.default_rng(7)
    for width in (4, 16, 128):
        data = torch.from_numpy(rng.integers(0, 4, size=(300, width),
                                             dtype=np.uint8) + 97)
        lens = torch.from_numpy(rng.integers(0, width + 1, size=300)
                                .astype(np.int32))
        pats = bytes_ops.BytePatterns.of(
            [(k, bytes(p)) for k in (bytes_ops.PREFIX, bytes_ops.SUFFIX,
                                     bytes_ops.EXACT)
             for p in (b"", b"a", b"ab", b"abc", b"a" * 17, b"b" * 200)])
        dc, lc = data.cuda(), lens.cuda()
        want = bytes_ops.byte_pred(data, lens, pats)
        assert_equal(f"byte_pred edge L={width}",
                     bytes_ops.byte_pred(dc, lc, pats).cpu(), want)
        # strided rows: a column of a [B, 2, L] plane
        planes = torch.stack([data, data.flip(0)], dim=1).cuda()
        assert_equal(f"byte_pred strided L={width}",
                     bytes_ops.byte_pred(planes[:, 0, :], lc, pats).cpu(),
                     want)
        n += 2
    for pats in ([f"^x{i}[0-9a-f]{{32}}$" for i in range(200)],
                 ["a+b*c", "(ab|ba)+$", "^c", "[^a]b"]):
        bank = bytes_ops.DfaBank.of(regex_dfa.pack_dfas_classes(
            [regex_dfa.compile_regex(p) for p in pats]))
        alphabet = np.frombuffer(b"abcx0123456789f", np.uint8)
        data = torch.from_numpy(rng.choice(alphabet, size=(500, 40)))
        data[::7, :2] = torch.tensor(list(b"x1"), dtype=torch.uint8)
        lens = torch.from_numpy(rng.integers(0, 41, size=500)
                                .astype(np.int32))
        assert_equal(f"dfa_scan edge S={bank.table.shape[0]}",
                     bytes_ops.dfa_scan(data.cuda(), lens.cuda(), bank).cpu(),
                     bytes_ops.dfa_scan(data, lens, bank))
        n += 1

    worlds = [
        ([Rule(*r) for r in EDGE_RULES],
         {"deny": [pe.DenySpec(rule=0, valid_duration_s=3.0),
                   pe.DenySpec(rule=5, status=16, valid_use_count=9)],
          "lists": [pe.ListEntrySpec(rule=9, value_attr="source.user",
                                     entries=["u1"], blacklist=True),
                    pe.ListEntrySpec(rule=9, value_attr="source.name",
                                     entries=["a", "c"]),
                    pe.ListEntrySpec(rule=3, value_attr="request.method",
                                     entries=["GET"])],
          "quotas": [pe.QuotaSpec(rule=9, key_attr="source.user",
                                  max_amount=3, n_buckets=5),
                     pe.QuotaSpec(rule=8, key_attr="source.name",
                                  max_amount=2, n_buckets=3)]}),
        ([Rule("eq", 'source.name == "a"'),
          Rule("neq", 'source.name != "b"', "ns1")],
         {"deny": [pe.DenySpec(rule=1)]}),
        ([], {}),
    ]
    for w, (rules, specs) in enumerate(worlds):
        gpu = pe.PolicyEngine(rules, workloads.MESH_FINDER, device="cuda",
                              count_rules=max(len(rules) - 1, 0), **specs)
        cpu = pe.PolicyEngine(rules, workloads.MESH_FINDER, device="cpu",
                              count_rules=max(len(rules) - 1, 0), **specs)
        for step, b in enumerate((1, 300, 77)):
            dicts, ns = edge_bags(b, seed=100 * w + step)
            bags = [bag_from_mapping(d) for d in dicts]
            req = np.asarray([gpu.ruleset.namespace_id(x) for x in ns],
                             np.int32)
            req[::11] = -7                     # the pad rows' namespace
            batch = gpu.tensorizer.tensorize(bags)
            batch.hash_ids[::3] = -batch.hash_ids[::3] - 1  # floor modulo
            cpu.quota_counts.copy_(gpu.quota_counts.cpu())
            vg = gpu.check(batch.to("cuda"), req)
            vc = cpu.check(batch, req)
            for f in FIELDS:
                assert_equal(f"edge world {w} B={b}.{f}",
                             getattr(vg, f).cpu(), getattr(vc, f))
            assert_equal(f"edge world {w} B={b}.quota_counts",
                         gpu.quota_counts.cpu(), cpu.quota_counts)
            n += 1
    return n


RESPONSE_FIELDS = ("status_code", "status_message", "valid_duration_s",
                   "valid_use_count", "referenced", "referenced_presence",
                   "deny_rule", "active_quota_rules")
SERVED_ITERS = 30            # timed check_many calls per batch size


def compare_responses(label: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} responses, want "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        for f in RESPONSE_FIELDS:
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{label}: request {i} field {f}: "
                                     f"card {getattr(a, f)!r}, plain "
                                     f"{getattr(b, f)!r}")


def compare_drains(label: str, got: dict, want: dict, times: int = 1
                   ) -> None:
    import numpy as np
    for k in ("hit", "deny", "err"):
        if not np.array_equal(got[k], times * want[k]):
            raise AssertionError(f"{label}: drained {k} differs from "
                                 f"{times} x the plain fold")


def rule_counts(srv) -> dict:
    """The server's cumulative rule counts after one more drain,
    flattened to {(rule, namespace or "", field): n}."""
    srv.rulestats.drain()
    out = {}
    for name, v in srv.rulestats.counts().items():
        for f in ("hits", "denies", "errors"):
            out[(name, "", f)] = v[f]
        for ns, per in v["ns"].items():
            for f, n in per.items():
                out[(name, ns, f)] = n
    return out


def counts_since(srv, before: dict) -> dict:
    """Nonzero growth of rule_counts(srv) since `before`."""
    after = rule_counts(srv)
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def compare_counts(label: str, got: dict, want: dict, times: int = 1
                   ) -> None:
    if not want:
        raise AssertionError(f"{label}: the plain server counted nothing")
    if got != {k: times * n for k, n in want.items()}:
        raise AssertionError(f"{label}: rule counts differ from {times} x "
                             "the plain server's")


def served(n_rules: int, device: str, args: dict | None = None,
           **store_kw):
    """The port's RuntimeServer over make_store(n_rules) on `device`
    with ServerArgs(**args), and its store."""
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads
    store = workloads.make_store(n_rules, **store_kw)
    return RuntimeServer(store, ServerArgs(**(args or {})),
                         device=device), store


def served_traffic(traffic: str, n_rules: int, b: int, seed: int):
    """Bags of bench.py's headline traffic (make_bags), or of the
    port-only hit traffic aimed at make_store's deny / list rules, with
    every fifth request from a namespace no rule names."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.testing import workloads
    if traffic == "headline":
        return workloads.make_bags(b, seed=seed)
    dicts, _ = workloads.make_hit_requests(n_rules, b, seed=seed)
    for d in dicts[::5]:
        d["destination.service"] = "svc1.nowhere.svc.cluster.local"
    return [bag_from_mapping(d) for d in dicts]


def stage_sums() -> dict:
    from istio_tpu_torch.runtime import monitor
    h = monitor.CHECK_STAGE_SECONDS
    return {st: h.sum(st) for st in monitor.CHECK_STAGES}


# the plain server: no drainer thread (drains are explicit), and one
# small bucket to warm at a config swap
CPU_SERVER = dict(initial_prewarm=False, rulestats_drain_s=0, buckets=(64,))


def served_phase() -> dict:
    """Phase 5: the served Check() path at the headline world, with the
    launch counters zeroed just before it and read just after. The
    card's server runs at the default ServerArgs (its rule-stats
    drainer thread included) with E2E_BATCHES as its buckets, so its
    constructor warms every timed shape. → the counts, per-B results,
    the captured B=2048 kernel inputs, and both servers for phase 5c."""
    import torch
    from istio_tpu_torch import kernels

    t0 = time.perf_counter()
    srv, store = served(HEADLINE_RULES, "cuda", dict(buckets=E2E_BATCHES))
    build_s = time.perf_counter() - t0
    cpu, cpu_store = served(HEADLINE_RULES, "cpu", CPU_SERVER)
    d = srv.controller.dispatcher
    plan, snap = d.fused, d.snapshot
    rs = snap.ruleset
    log(f"[5] served snapshot + plan + warm of "
        f"{len(plan._warmed_shapes)} (bucket, tier) shapes on the card in "
        f"{build_s:.2f} s (publish {srv.controller.last_publish_wall_s:.2f}"
        f" s): {len(snap.rules)} rules, {rs.rule_ns.shape[0]} rule rows, "
        f"{len(rs.ns_ids) + 1} telemetry slots, {len(plan.item_names)} "
        f"items ({plan.n_ref_words} words), {len(plan.overlay_cols)} "
        f"overlay columns ({plan.n_overlay_words} words), "
        f"{plan.fused_deny} deny / {plan.fused_lists} lists fused, "
        f"{len(plan.host_actions)} host-overlay rules, tiers "
        f"{plan.str_tiers}, errors {len(snap.errors)}")
    if plan._warmed_shapes != set(plan.all_warm_shapes(E2E_BATCHES)):
        raise AssertionError(f"constructor warmed {plan._warmed_shapes}")

    kernels.launches.reset()
    steps = 0
    for traffic in ("headline", "hit"):
        bags = served_traffic(traffic, HEADLINE_RULES, 256, seed=41)
        before, cpu_before = rule_counts(srv), rule_counts(cpu)
        compare_responses(f"served {traffic} B=256", srv.check_many(bags),
                          cpu.check_many(bags))
        compare_counts(f"served {traffic} B=256", counts_since(srv, before),
                       counts_since(cpu, cpu_before))
        steps += 1
    log("[5] B=256 headline and hit traffic: every response field and "
        "the drained rule counts equal to the device='cpu' server")
    big = served_traffic("headline", HEADLINE_RULES, HEADLINE_B, seed=1)
    with kernels.launches.capture() as captured:
        srv.check_many(big)
    steps += 1
    torch.cuda.synchronize()
    results = {}
    for b in E2E_BATCHES:
        bags = served_traffic("headline", HEADLINE_RULES, b, seed=1)
        results[b], n = time_check_many(srv, cpu, bags, "[5] served")
        steps += n
    out = path_counts("[5] served path", SERVED_KERNELS, steps)
    return {**out, "results": results, "captured": captured,
            "quota0": plan.engine.quota_counts.clone(),
            "servers": (srv, store, cpu, cpu_store)}


def time_check_many(srv, cpu, bags, label: str) -> tuple[dict, int]:
    """Time srv.check_many(bags) over SERVED_ITERS calls after two warm
    ones: wall p50 / p99, checks/s, device busy and idle share, and the
    host stage breakdown; the loop's rule counts must equal SERVED_ITERS
    x the plain server's for the batch. → (result, served steps)."""
    import numpy as np
    b = len(bags)
    for _ in range(2):
        srv.check_many(bags)
    cpu_before = rule_counts(cpu)
    cpu.check_many(bags)
    once = counts_since(cpu, cpu_before)
    before = rule_counts(srv)
    t_before = stage_sums()
    walls = []
    for _ in range(SERVED_ITERS):
        t = time.perf_counter()
        srv.check_many(bags)
        walls.append((time.perf_counter() - t) * 1e3)
    t_after = stage_sums()
    compare_counts(f"{label} B={b} timed loop", counts_since(srv, before),
                   once, times=SERVED_ITERS)
    busy = device_ms(lambda: srv.check_many(bags), 5)
    p50, p99 = (float(np.percentile(walls, q)) for q in (50, 99))
    stages = {k: (t_after[k] - t_before[k]) * 1e3 / SERVED_ITERS
              for k in t_after}
    idle = "not measured" if busy is None else \
        f"busy {busy:.4f} ms, idle share {1 - busy / p50:.3f}"
    log(f"{label} B={b:5d}: wall p50 {p50:.4f} ms p99 {p99:.4f} ms "
        f"= {b / p50 * 1e3:,.0f} checks/s ({idle}); stages ms/batch "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
        + f"; rule counts = {SERVED_ITERS} x the plain server's")
    return {"p50_ms": p50, "p99_ms": p99, "checks_per_s": b / p50 * 1e3,
            "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / p50,
            "stages_ms": stages}, 2 + SERVED_ITERS + 6


def path_counts(label: str, required: tuple, steps: int) -> dict:
    """Read the launch counters after a path's run (zeroed just before
    it); every kernel of the path must have launched."""
    from istio_tpu_torch import kernels
    counts = dict(kernels.launches)
    grids = dict(kernels.launches.grids)
    missing = [k for k in required if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {label}: "
                             f"{missing}")
    per_step = {k: counts[k] / steps for k in kernels.KERNELS}
    per_call = {k: grids[k] / counts[k] for k in kernels.KERNELS
                if counts[k]}
    log(f"{label} ({steps} served steps): wrapper calls {counts}; "
        f"__global__ launches {grids}; calls per step "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_step.items())
        + "; grids per call "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_call.items()))
    return {"counts": counts, "grids": grids, "steps": steps,
            "per_step": per_step}


def swap_phase(srv, store, cpu, cpu_store) -> None:
    """Phase 5c: a config swap through the store watch on both servers
    (every denier now answers UNAVAILABLE with a short TTL), with the
    launch counters zeroed just before it and read just after. The new
    plan warms every serving shape on the card before it is published;
    the batches after the swap run on the device and equal the CPU
    server's, and no rule count is lost across the publish."""
    from istio_tpu_torch import kernels

    bags = served_traffic("hit", HEADLINE_RULES, 256, seed=43)
    kernels.launches.reset()
    before, cpu_before = rule_counts(srv), rule_counts(cpu)
    compare_responses("pre-swap B=256", srv.check_many(bags),
                      cpu.check_many(bags))
    old = (srv.controller.dispatcher, cpu.controller.dispatcher)
    spec = {"adapter": "denier",
            "params": {"status_code": 14, "valid_duration_s": 1.5}}
    t0 = time.perf_counter()
    for st in (store, cpu_store):
        st.set(("handler", "istio-system", "denyall"), spec)
    deadline = t0 + 120
    for x, was in zip((srv, cpu), old):
        while x.controller.dispatcher is was:
            if time.perf_counter() > deadline:
                raise AssertionError("config swap never published")
            time.sleep(0.005)
        if x is srv:
            seen_s = time.perf_counter() - t0
    plan = srv.controller.dispatcher.fused
    n_warm = len(plan._warmed_shapes)
    if plan._warmed_shapes != set(plan.all_warm_shapes(E2E_BATCHES)):
        raise AssertionError(f"swap warmed {plan._warmed_shapes}")
    trips = []
    packed_check = plan.packed_check

    def counted(*a, **kw):
        trips.append(1)
        return packed_check(*a, **kw)

    plan.packed_check = counted
    got = srv.check_many(bags)
    compare_responses("post-swap B=256", got, cpu.check_many(bags))
    del plan.packed_check
    if not trips or not any(r.status_code == 14 for r in got):
        raise AssertionError("post-swap batch did not serve the new "
                             "config on the device")
    compare_counts("across the swap", counts_since(srv, before),
                   counts_since(cpu, cpu_before))
    counts = dict(kernels.launches)
    missing = [k for k in SERVED_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched across the swap: "
                             f"{missing}")
    codes = sorted({r.status_code for r in got})
    log(f"[5c] config swap through the store watch: published on the "
        f"card {seen_s:.2f} s after store.set (rebuild + warm of "
        f"{n_warm} shapes "
        f"{srv.controller.last_publish_wall_s:.2f} s); the next B=256 "
        f"batch served on the device (statuses {codes}) equal to the CPU "
        f"server, rule counts across the publish equal; wrapper calls "
        f"{counts}")
    for x in (srv, cpu, store, cpu_store):
        x.close()


def served_edge_checks() -> int:
    """Phase 5b: check_pack and rule_stats against their plain versions
    on inputs the headline world does not produce — more than one item
    word, more than 32 overlay columns, bit 31 of a word set, padding
    rows, unknown and pad-row namespaces, empty item and overlay sets —
    and a served host-overlay world on the card against the same server
    on the CPU, with padded batches. → cases."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops.bytes_ops import pack_bits
    from istio_tpu_torch.runtime import fused, rulestats
    from istio_tpu_torch.runtime.batcher import pad_to_bucket

    rng = np.random.default_rng(9)
    n = 0
    for b, r, n_cols, n_maps, c in ((77, 300, 50, 20, 70),
                                    (33, 64, 31, 2, 40), (5, 40, 0, 0, 0),
                                    (2048, 10008, 26, 3, 2)):
        n_items = n_cols + n_maps
        rule_ns = torch.from_numpy(
            rng.integers(-1, 5, size=r).astype(np.int32))
        rule_ns[-3:] = -7
        inst = rng.random((r, n_items)) < 0.05
        if n_items > 31:
            inst[::3, 31] = True
        pred = rng.random((r, n_maps)) < 0.1
        t = fused.PackTables(
            rule_ns=rule_ns.cuda(),
            inst_bits=torch.from_numpy(
                pack_bits(inst).view(np.int32).copy()).cuda(),
            pred_bits=torch.from_numpy(
                pack_bits(pred).view(np.int32).copy()).cuda(),
            cols=torch.from_numpy(rng.choice(r, size=c, replace=False)
                                  .astype(np.int32)).cuda(),
            default_ns=0, n_cols=n_cols, n_items=n_items, n_maps=n_maps)
        g = torch.Generator(device="cuda").manual_seed(b)
        status = torch.randint(0, 14, (b,), dtype=torch.int32,
                               device="cuda", generator=g)
        dur = torch.rand(b, device="cuda", generator=g)
        uses = torch.randint(0, 1 << 30, (b,), dtype=torch.int32,
                             device="cuda", generator=g)
        deny_rule = torch.randint(-1, r + 1, (b,), dtype=torch.int32,
                                  device="cuda", generator=g)
        err_count = torch.tensor(17, dtype=torch.int32, device="cuda")
        referenced = torch.rand(b, max(n_cols, 1), device="cuda",
                                generator=g) < 0.5
        matched = torch.rand(b, r, device="cuda", generator=g) < 0.3
        req = torch.randint(-1, 5, (b,), dtype=torch.int32, device="cuda",
                            generator=g)
        req[::7] = -7
        ins = (status, dur, uses, deny_rule, err_count, referenced, matched,
               req, t)
        got = fused.check_pack(*ins)
        assert_equal(f"check_pack edge B={b} R={r} items={n_items} C={c}",
                     got, fused.check_pack_plain(*ins))
        if n_items > 31 and not bool((got[5:5 + t.n_words] < 0).any()):
            raise AssertionError("check_pack edge: no word with bit 31 set")
        s = 6
        err = torch.rand(b, r, device="cuda", generator=g) < 0.1
        real = torch.arange(b, device="cuda") < b - 2
        err_rows = torch.rand(r, device="cuda", generator=g) < 0.9
        sin = (matched, err, status, deny_rule, req, real, t.rule_ns, 0, s,
               err_rows)
        accs = [rulestats_zeros(sin) for _ in range(2)]
        for a in accs:
            a[0].fill_(3)          # fold into non-zero state
        rulestats.rule_stats(*sin, *accs[0])
        rulestats.rule_stats_plain(*sin, *accs[1])
        for part, x, y in zip(("hit", "deny", "err"), *accs):
            assert_equal(f"rule_stats edge B={b} R={r}.{part}", x, y)
        n += 2
    # a served world with more than 32 overlay columns and several item
    # words, on padded batches with unknown namespaces
    args = dict(initial_prewarm=False, rulestats_drain_s=0)
    gpu, gs = served(200, "cuda", args, host_overlay_every=5)
    cpu, cs = served(200, "cpu", args, host_overlay_every=5)
    buckets = (16, 64)
    for step, b in enumerate((5, 40, 64)):
        bags = served_traffic("hit", 200, b, seed=300 + step)
        padded = pad_to_bucket(bags, buckets)
        compare_responses(f"served edge B={b}",
                          gpu.controller.dispatcher.check(padded),
                          cpu.controller.dispatcher.check(padded))
        n += 1
    compare_drains("served edge telemetry",
                   gpu.controller.dispatcher.fused.telemetry.drain(),
                   cpu.controller.dispatcher.fused.telemetry.drain())
    for x in (gpu, cpu, gs, cs):
        x.close()
    return n + 1

def authz_phase(int_rate: float) -> dict:
    """Phase 6: the authz world (BASELINE config 2): make_rbac_store(1000)
    served under default_manifest=MESH_MANIFEST on the card against a
    device="cpu" server, with the launch counters zeroed just before its
    drive and read just after. make_rbac_request_dicts(B) at B ∈
    E2E_BATCHES: every response field and the rule counts equal, then
    the timed loop; the B=2048 batch is captured and K1, K3, K4, K5 and
    K6 are held against their plain versions on it (timed, with the
    bounds and the RBAC allow product as a library call)."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads

    man = workloads.MESH_MANIFEST
    t0 = time.perf_counter()
    store = workloads.make_rbac_store(AUTHZ_ROLE_RULES)
    srv = RuntimeServer(store, ServerArgs(default_manifest=man,
                                          buckets=E2E_BATCHES),
                        device="cuda")
    build_s = time.perf_counter() - t0
    cpu_store = workloads.make_rbac_store(AUTHZ_ROLE_RULES)
    cpu = RuntimeServer(cpu_store, ServerArgs(default_manifest=man,
                                              **CPU_SERVER), device="cpu")
    d = srv.controller.dispatcher
    plan, snap = d.fused, d.snapshot
    ((key, g),) = snap.rbac_groups.items()
    if not g.lowered or plan.host_actions or plan.rbac_rules != {0}:
        raise AssertionError(f"authz policy did not fuse: {g.reason}")
    log(f"[6] authz world make_rbac_store({AUTHZ_ROLE_RULES}): snapshot + "
        f"plan + warm on the card {build_s:.2f} s; {len(snap.rules)} config "
        f"rule, rbac group {key}: {len(g.allow_rows)} allow rows "
        f"({g.n_triples} (binding, subject, role-rule) triples) + guard "
        f"row {g.guard_row}; {snap.ruleset.n_rules} ruleset rows, "
        f"{snap.ruleset.rule_ns.shape[0]} after the pad to 8; "
        f"{len(plan.item_names)} items, {len(plan.overlay_cols)} overlay "
        f"columns")
    kernels.launches.reset()
    steps, results, denied = 0, {}, {}
    for b in E2E_BATCHES:
        bags = [bag_from_mapping(x) for x in
                workloads.make_rbac_request_dicts(b, seed=b)]
        before, cpu_before = rule_counts(srv), rule_counts(cpu)
        got = srv.check_many(bags)
        compare_responses(f"authz B={b}", got, cpu.check_many(bags))
        compare_counts(f"authz B={b}", counts_since(srv, before),
                       counts_since(cpu, cpu_before))
        steps += 1
        codes = [r.status_code for r in got]
        denied[b] = sum(c != OK for c in codes) / b
        if not {0, 7} <= set(codes):
            raise AssertionError(f"authz B={b}: statuses {set(codes)}")
        log(f"[6] authz B={b}: every response field and the rule counts "
            f"equal to the device='cpu' server; denied fraction "
            f"{denied[b]:.4f} (statuses {sorted(set(codes))})")
        if b == HEADLINE_B:
            with kernels.launches.capture() as captured:
                srv.check_many(bags)
            steps += 1
            torch.cuda.synchronize()
        results[b], n = time_check_many(srv, cpu, bags, "[6] authz")
        steps += n
    out = path_counts("[6] authz path", AUTHZ_KERNELS, steps)
    one_atom_launch_per_step("[6] authz path", out, snap.ruleset)
    log(f"[6] authz path, B={HEADLINE_B}: K1, K3, K4, K5, K6 and "
        "atom_eval against their plain versions on its own inputs (timed):")
    rows = check_kernels(captured, plan.engine.quota_counts.clone(),
                         int_rate)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    return {**out, "results": results, "denied": denied, "rows": rows,
            "pseudo_rows": len(g.allow_rows) + 1}


def atom_store_probe(batch, atoms, want) -> float:
    """atom_eval's device ms with its m / n stores coalesced, to weigh
    the served layout's: the same C entry point over the same programs,
    given x_stride 1 and column a at a * B, writes a transposed [A, B]
    plane, so a warp's stores are consecutive bytes instead of bytes X
    apart. Held equal to the served launch's columns `want` (m, n)."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.ops import field_ops as fo
    b = int(batch.ids.shape[0])
    args = fo._launch_args(batch, atoms.prog, "atom_eval")
    dev = batch.ids.device
    cols = torch.arange(atoms.n, dtype=torch.int32, device=dev) * b
    tm = torch.empty((atoms.n, b), dtype=torch.bool, device=dev)
    tn = torch.empty_like(tm)
    fn = kernels.function("atom_eval", "atom_eval", fo._ATOM_EVAL_ARGS)
    p = kernels.ptr

    def run():
        kernels.check(fn(*args, p(cols), p(tm), p(tn), 1,
                         kernels.VP(kernels.stream_ptr())), "atom_eval")
    run()
    c = atoms.cols_on(dev).long()
    assert_equal("atom_eval coalesced probe.m", tm.T, want[0][:, c])
    assert_equal("atom_eval coalesced probe.n", tn.T, want[1][:, c])
    return timed(run, 200)[0]


def one_atom_launch_per_step(label: str, out: dict, ruleset) -> None:
    """Every rule_match launch of the path's drive came with exactly one
    atom_eval launch (one grid), where the ruleset has op-program atoms;
    none where it has none."""
    counts, grids = out["counts"], out["grids"]
    want = counts["rule_match"] if ruleset.atoms.n else 0
    if counts["atom_eval"] != want or grids["atom_eval"] != want:
        raise AssertionError(f"{label}: {counts['atom_eval']} atom_eval "
                             f"launches ({grids['atom_eval']} grids) for "
                             f"{counts['rule_match']} rule_match launches "
                             f"and {ruleset.atoms.n} op-program atoms")
    log(f"{label}: one atom_eval launch per step ({want} launches, "
        f"{ruleset.atoms.n} atoms as {len(ruleset.atoms.prog.ops)} op "
        f"rows, stack {ruleset.atoms.prog.need}); no per-atom closure")


# atoms for atom_eval's edge inputs (phase 6b) over EDGE_ATOM_MANIFEST:
# runtime and constant patterns (empty, `*` only, leading / trailing `*`,
# longer than the subject), subjects at and past the cap, regexes, ordered
# compares with numeric NaN and malformed order keys, type mismatches,
# `|` views and map views, operand-order swaps with an error on either
# side, and a 40-deep LAND chain
EDGE_ATOM_MANIFEST = {"s": "STRING", "p": "STRING", "q": "STRING",
                      "n": "INT64", "m": "INT64", "d": "DOUBLE",
                      "d2": "DOUBLE", "t": "TIMESTAMP", "b": "BOOL",
                      "b2": "BOOL", "h": "STRING_MAP"}
EDGE_ATOMS = (
    "s.startsWith(p)", "s.endsWith(p)", "match(s, p)",
    "(s | q).startsWith(p | q)", 'match(h["k"] | s, h["j"] | "*")',
    'match("abc", p)', '"".endsWith(p)', 's.startsWith("abc")',
    's.endsWith("bc")', 'match(s, "*bc")', 'match(s, "abc*")',
    'match(s, "abcdefgh")', 's.endsWith("abcdefghijk")', '"^ab".matches(s)',
    '"c$".matches(s)', '"b+c".matches(h["k"] | p)', '"(".matches(s)',
    "s < p", "q >= p", '"abc" < s', 's >= "abcdefgh"', "n < m", "d < d2",
    "d > 1.5", "b < b2", "s < n", "b || (b2 && (n == 1 || m == 2))",
    'timestamp(s) == t || (b && (b2 || n == 1))',
    '(s | (p | (q | "z"))) == "abc"', 's < (p | (q | "zz"))',
    'match(s, p | (q | "*"))',
    " && ".join(f"n == {i % 3}" if i % 3 == 0 else
                ("b" if i % 3 == 1 else 's.startsWith("ab")')
                for i in range(40)))


def edge_atom_dicts(b: int, seed: int) -> list[dict]:
    """Records for atom_eval's edge inputs: strings around the cap of 8
    (empty, 1, 3, 7, 8, 10 bytes, `*`-led and -ended), NaN / inf / -0.0
    doubles, malformed numbers, maps, every attribute absent on some."""
    import datetime

    import numpy as np
    rng = np.random.default_rng(seed)
    strs = ["", "a", "abc", "abcdefg", "abcdefgh", "abcdefghij", "xbc",
            "*bc", "bc", "abc*", "*", "**", "a*c", "abcdefghijk"]
    nums = [0, -3, 7, 2 ** 40, "malformed", 7.5, 1]
    dbls = [float("nan"), 1.5, -0.0, 0.0, 2.5, "bad", float("inf")]
    t0 = datetime.datetime(2018, 3, 1, tzinfo=datetime.timezone.utc)
    out = []
    for _ in range(b):
        d = {}
        for k, vals in (("s", strs), ("p", strs), ("q", strs), ("n", nums),
                        ("m", nums), ("d", dbls), ("d2", dbls),
                        ("t", [t0]), ("b", [True, False]),
                        ("b2", [True, False])):
            if rng.random() < 0.8:
                d[k] = vals[int(rng.integers(len(vals)))]
        if rng.random() < 0.3:
            d["s"] = "2018-03-01T00:00:00Z"
        if rng.random() < 0.5:
            d["h"] = {"k": strs[int(rng.integers(len(strs)))],
                      "j": strs[int(rng.integers(len(strs)))]}
        out.append(d)
    return out


def atom_world(texts, manifest: dict, dicts, max_str_len: int):
    """BOOL expressions that lower on the device as one atom each over
    one layout → (AtomProgram, CPU batch of `dicts`)."""
    import numpy as np
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.compiler import layout as lay_mod
    from istio_tpu_torch.compiler import tensor_expr as te
    from istio_tpu_torch.compiler.op_lower import lower_programs
    from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder,
                                              DEFAULT_FUNCS, eval_type)
    from istio_tpu_torch.expr.parser import parse
    from istio_tpu_torch.ops import field_ops as fo

    finder = AttributeDescriptorFinder(manifest)
    asts, reqs = [], te.Requirements()
    for text in texts:
        try:
            ast = parse(text)
            if eval_type(ast, finder, DEFAULT_FUNCS).name != "BOOL":
                continue
            r = te.Requirements()
            te.collect_requirements(ast, finder, r)
        except Exception:          # parse / type errors, host fallback
            continue
        reqs.merge(r)
        asts.append(ast)
    layout = lay_mod.build_layout(
        manifest, sorted(reqs.derived_keys),
        sorted(reqs.byte_sources, key=str), max_str_len=max_str_len,
        extern_sources=[(n, k, a) for (n, k), a in
                        sorted(reqs.extern_sources.items(),
                               key=lambda kv: kv[0])])
    interner = lay_mod.InternTable()
    ctx = te._Ctx(layout, interner, finder)
    fns, kept = [], []
    for ast in asts:
        try:
            fns.append(te._compile_node(ast, ctx))
        except te.HostFallback:
            continue
        kept.append(ast)
    atoms = fo.AtomProgram(
        fns=fns, prog=lower_programs(kept, layout, interner, finder),
        cols=np.arange(len(fns), dtype=np.int32))
    batch = lay_mod.Tensorizer(layout, interner).tensorize(
        [bag_from_mapping(d) for d in dicts])
    return atoms, batch


def atom_edge_checks(int_rate: float) -> list[dict]:
    """Phase 6b: atom_eval against atom_eval_plain (the closures) and
    atom_eval_ops_plain (the op table) on the card: the atom world —
    every BOOL expression of the port's copy of the conformance corpus
    that lowers on the device, one atom each, over the corpus inputs
    tiled to B=2048 — and EDGE_ATOMS over B = 777 records at a cap of 8
    bytes, and at a cap of 32 on a plane narrowed to 12 bytes (records
    whose strings fit). Each world's launch is timed beside its plain
    version and its bound: the byte ops (B3's rest) dominate the edge
    worlds. → one row per world."""
    import torch
    from istio_tpu_torch.attribute.types import ValueType
    from istio_tpu_torch.ops import field_ops as fo
    from istio_tpu_torch.testing import corpus

    inputs = [c.input for c in corpus.CORPUS if c.compile_err is None]
    edge_man = {k: ValueType[v] for k, v in EDGE_ATOM_MANIFEST.items()}
    edge = edge_atom_dicts(777, seed=61)
    worlds = [("corpus", [c.e for c in corpus.CORPUS],
               corpus.CORPUS_MANIFEST,
               (inputs * (HEADLINE_B // len(inputs) + 1))[:HEADLINE_B], 128,
               None),
              ("edge cap 8", EDGE_ATOMS, edge_man, edge, 8, None),
              ("edge narrowed", EDGE_ATOMS, edge_man, [d for d in edge if all(
                  len(v) <= 12 for v in d.values() if isinstance(v, str))],
               32, 12)]
    rows = []
    for tag, texts, man, dicts, cap, width in worlds:
        atoms, batch = atom_world(texts, man, dicts, cap)
        if width is not None:
            batch = dataclasses.replace(
                batch, str_bytes=batch.str_bytes[:, :, :width].contiguous())
        batch = batch.to("cuda")
        b = batch.ids.shape[0]
        got, want, ops_want = (
            (torch.zeros((b, atoms.n), dtype=torch.bool, device="cuda"),
             torch.zeros((b, atoms.n), dtype=torch.bool, device="cuda"))
            for _ in range(3))
        fo.atom_eval(batch, atoms, *got)
        torch.cuda.synchronize()
        fo.atom_eval_plain(batch, atoms, *want)
        fo.atom_eval_ops_plain(batch, atoms, *ops_want)
        for part, g, w, o in zip(("m", "n"), got, want, ops_want):
            assert_equal(f"atom_eval {tag}.{part}", g, w)
            assert_equal(f"atom_eval {tag}.{part} (op table)", g, o)
        opcodes = {int(o) for o in atoms.prog.ops[:, 0]}
        ms, call, how = timed(lambda: fo.atom_eval(batch, atoms, *got), 100)
        plain, _, _ = timed(lambda: fo.atom_eval_plain(batch, atoms, *want),
                            5)
        nb, ops = atom_work(batch, atoms)
        bms, by = bound(nb, ops, int_rate)
        log(f"[6b] atom_eval {tag}: {atoms.n} atoms ({len(atoms.prog.ops)} "
            f"op rows, {len(opcodes)} opcodes, stack {atoms.prog.need}) x "
            f"B={b} width {batch.str_bytes.shape[2]}: m and n equal to the "
            f"closures and to the op table; kernel {ms:.5f} ms (per call "
            f"incl. launch {call:.5f}) plain {plain:.5f} ms bound "
            f"{bms:.6f} ms ({by}; {nb:.0f} B, {ops:.0f} ops) [{how}]")
        rows.append({"world": tag, "atoms": atoms.n, "b": b, "ms": ms,
                     "call_ms": call, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by})
    return rows


def list_world_store():
    """tests/test_fused_serving.py's store (the listchecker's usual
    deployments beside deniers): a STRINGS whitelist, a map-derived
    STRINGS blacklist, a fallback-expression whitelist and a
    case-insensitive list (both stay on the host), a REGEX path
    blacklist and an IP_ADDRESSES blacklist over source.ip, a denier, a
    host-fallback predicate and a namespace-scoped rule."""
    from istio_tpu_torch.runtime.store import MemStore
    s = MemStore()
    lst = lambda **p: {"adapter": "list", "params": p}  # noqa: E731
    inst = lambda t, **p: {"template": t, "params": p}  # noqa: E731
    for name, spec in (
            ("nswhitelist", lst(overrides=["default", "prod"],
                                blacklist=False, caching_ttl_s=30.0)),
            ("uablacklist", lst(overrides=["badbot"], blacklist=True)),
            ("verwhitelist", lst(overrides=["v1", "v2"], blacklist=False)),
            ("rxlist", lst(overrides=["^/api/"], entry_type="REGEX",
                           blacklist=True)),
            ("ipblock", lst(overrides=["10.0.0.0/8", "2001:db8::/32"],
                            entry_type="IP_ADDRESSES", blacklist=True)),
            ("cilist", lst(overrides=["Mozilla"],
                           entry_type="CASE_INSENSITIVE_STRINGS",
                           blacklist=True)),
            ("denyall", {"adapter": "denier", "params": {
                "status_code": 7, "status_message": "admin is off limits",
                "valid_duration_s": 3.0, "valid_use_count": 100}})):
        s.set(("handler", "istio-system", name), spec)
    for name, spec in (
            ("srcns", inst("listentry", value="source.namespace")),
            ("ua", inst("listentry", value='request.headers["user-agent"]')),
            ("appversion", inst("listentry",
                                value='source.labels["version"] | "none"')),
            ("path", inst("listentry", value="request.path")),
            ("srcip", inst("listentry", value="source.ip")),
            ("nothing", inst("checknothing"))):
        s.set(("instance", "istio-system", name), spec)
    rule = lambda m, *acts: {"match": m, "actions": [  # noqa: E731
        {"handler": h, "instances": list(i)} for h, *i in acts]}
    for ns, name, spec in (
            ("istio-system", "r0-denyadmin",
             rule('request.path.startsWith("/admin")',
                  ("denyall", "nothing"))),
            ("istio-system", "r1-nscheck",
             rule('destination.service == "ratings.default.svc.cluster.local"',
                  ("nswhitelist", "srcns"))),
            ("istio-system", "r2-uacheck",
             rule("connection.mtls", ("uablacklist", "ua"))),
            ("istio-system", "r3-version",
             rule('request.method == "POST"', ("verwhitelist", "appversion"))),
            ("istio-system", "r4-rx",
             rule('request.scheme == "http"', ("rxlist", "path"))),
            ("istio-system", "r5-dynkey",
             rule('request.headers[request.method] == "x"',
                  ("denyall", "nothing"))),
            ("prod", "r6-prodonly",
             rule("request.size > 100", ("denyall.istio-system",
                                          "nothing.istio-system"))),
            ("istio-system", "r7-mixed",
             rule('request.method == "DELETE"', ("denyall", "nothing"),
                  ("verwhitelist", "appversion"))),
            ("istio-system", "r8-ip",
             rule('request.scheme == "https"', ("ipblock", "srcip"))),
            ("istio-system", "r9-ci",
             rule('request.useragent == "x"', ("cilist", "ua")))):
        s.set(("rule", ns, name), spec)
    return s


def list_world_dicts() -> list[dict]:
    """Bags for the list world: a regex prefix hit and miss, truncated
    paths either way, IPv4, IPv6, v4-mapped IPv6 in and out of the nets,
    malformed IP lengths, an absent source.ip and path, beside the
    store's denier, whitelist and blacklist cases."""
    v4m = b"\x00" * 10 + b"\xff\xff"
    http, https = {"request.scheme": "http"}, {"request.scheme": "https"}
    return [
        {"request.path": "/admin/keys"}, {"request.path": "/ratings/1"},
        {"destination.service": "ratings.default.svc.cluster.local",
         "source.namespace": "evil"},
        {"connection.mtls": True, "request.headers": {"user-agent": "badbot"}},
        {"request.method": "POST", "source.labels": {"version": "v9"}},
        {"request.method": "GET", "request.headers": {"GET": "x"}},
        {"destination.service": "api.prod.svc.cluster.local",
         "request.size": 500},
        dict(http, **{"request.path": "/api/x"}),
        dict(http, **{"request.path": "/web/x"}),
        dict(http, **{"request.path": "/api/" + "x" * 200}),
        dict(http, **{"request.path": "/web/" + "x" * 200}),
        dict(http),
        dict(https, **{"source.ip": v4m + bytes([10, 1, 2, 3])}),
        dict(https, **{"source.ip": bytes([10, 0, 0, 1])}),
        dict(https, **{"source.ip": bytes.fromhex("20010db8") + b"\0" * 12}),
        dict(https, **{"source.ip": v4m + bytes([11, 1, 2, 3])}),
        dict(https, **{"source.ip": bytes([11, 0, 0, 1])}),
        dict(https, **{"source.ip": bytes.fromhex("fe80") + b"\0" * 14}),
        dict(https, **{"source.ip": b"\x01\x02\x03"}),
        dict(https, **{"source.ip": b""}),
        dict(https),
        {"request.useragent": "x",
         "request.headers": {"user-agent": "mozilla"}},
    ]


def list_phase(int_rate: float) -> dict:
    """Phase 7: the list world on the card against the same store served
    on the CPU, with the launch counters zeroed just before its drive and
    read just after: every response field and the rule counts equal at
    B ∈ {the bags once, 64, 2048 (the bags repeated)}, with the byte
    tiers both used; every kernel must launch, list_banks among them.
    The B=2048 batch is captured, and every kernel of it is held against
    its plain version (timed: the list_banks row)."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

    store, cpu_store = list_world_store(), list_world_store()
    srv = RuntimeServer(store, ServerArgs(buckets=E2E_BATCHES),
                        device="cuda")
    cpu = RuntimeServer(cpu_store, ServerArgs(**CPU_SERVER), device="cpu")
    plan = srv.controller.dispatcher.fused
    eng = plan.engine
    log(f"[7] list world: {plan.fused_deny} deny / {plan.fused_lists} lists "
        f"fused ({eng._rx_lists.n} REGEX, {eng._cidr_lists.n} IP_ADDRESSES); "
        f"host-overlay rules {sorted(plan.host_actions)}; unfused list kinds "
        f"{list(plan.unfused_list_kinds)}")
    dicts = list_world_dicts()
    kernels.launches.reset()
    steps = 0
    for b in (len(dicts), 64, HEADLINE_B):
        bags = [bag_from_mapping(x) for x in
                (dicts * (b // len(dicts) + 1))[:b]]
        before, cpu_before = rule_counts(srv), rule_counts(cpu)
        got = srv.check_many(bags)
        compare_responses(f"lists B={b}", got, cpu.check_many(bags))
        compare_counts(f"lists B={b}", counts_since(srv, before),
                       counts_since(cpu, cpu_before))
        steps += 1
        codes = sorted({r.status_code for r in got})
        if b == len(dicts):
            short = [bag_from_mapping(x) for x in dicts
                     if len(x.get("request.path", "")) <= 32]
            compare_responses("lists, small byte tier",
                              srv.check_many(short), cpu.check_many(short))
            steps += 1
            if codes != [0, 5, 7, 13]:
                raise AssertionError(f"list world statuses {codes}")
        log(f"[7] lists B={b}: every response field and the rule counts "
            f"equal to the device='cpu' server (statuses {codes})")
        if b == HEADLINE_B:
            with kernels.launches.capture() as captured:
                srv.check_many(bags)
            steps += 1
            torch.cuda.synchronize()
    out = path_counts("[7] list path", LIST_KERNELS, steps)
    log(f"[7] list path, B={HEADLINE_B}: every kernel against its plain "
        "version on its own inputs (timed):")
    rows = check_kernels(captured, eng.quota_counts.clone(), int_rate)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    return {**out, "rows": rows}


def list_banks_edge_checks() -> int:
    """Phase 7b: list_banks against its plain version on random inputs
    at B=2048: 64 REGEX lists over 256 pattern columns (a third of the
    patterns with `$`), values on four byte slots with a quarter of the
    rows truncated, lists sharing rules; and 64 IP_ADDRESSES lists × 16
    entries of mixed versions and prefix lengths, over values of length
    4, 16 (v4-mapped or not), and malformed lengths. → cases."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import bytes_ops

    rng = np.random.default_rng(12)
    b, n_slots, width, n_pat, n_rules = HEADLINE_B, 4, 128, 256, 200
    acc = torch.from_numpy(rng.random((b, n_pat)) < 0.05).cuda()
    lens = rng.integers(0, width + 40, size=(b, n_slots)).astype(np.int32)
    lens[rng.random((b, n_slots)) < 0.25] = width
    ptr, pat = [0], []
    for _ in range(64):
        pat.extend(rng.choice(n_pat, size=int(rng.integers(1, 9)),
                              replace=False).tolist())
        ptr.append(len(pat))
    rx = bytes_ops.RegexLists(
        pos=np.arange(0, 128, 2, dtype=np.int32),
        rule=rng.integers(0, n_rules, size=64).astype(np.int32),
        bslot=rng.integers(0, n_slots, size=64).astype(np.int32),
        ptr=np.asarray(ptr, np.int32), pat=np.asarray(pat, np.int32),
        pdef=(rng.random(n_pat) > 1 / 3).astype(np.uint8))
    nets = []
    for _ in range(64):
        ents = []
        for _ in range(16):
            if rng.random() < 0.5:
                a = rng.integers(0, 256, size=4)
                ents.append(f"{a[0]}.{a[1]}.{a[2]}.{a[3]}/"
                            f"{int(rng.integers(0, 33))}")
            else:
                a = rng.integers(0, 1 << 16, size=8)
                ents.append(":".join(f"{x:x}" for x in a) +
                            f"/{int(rng.integers(0, 129))}")
        nets.append(ents)
    cidr = bytes_ops.CidrLists.of(list(range(1, 128, 2)),
                                  rng.integers(0, n_slots, size=64).tolist(),
                                  nets)
    data = rng.integers(0, 256, size=(b, n_slots, width)).astype(np.uint8)
    data[::3, :, :8] = 0                      # near the :: and v4 nets
    data[1::3, :, :12] = np.frombuffer(b"\0" * 10 + b"\xff\xff", np.uint8)
    data[:, :, 12:16] = np.where(rng.random((b, n_slots, 1)) < 0.5, 10,
                                 data[:, :, 12:16])
    ip_lens = rng.choice([4, 16, 16, 0, 3, 5, 17], size=(b, n_slots))
    cases = 0
    for lens_np in (lens, ip_lens.astype(np.int32)):
        sb = torch.from_numpy(data).cuda()
        sl = torch.from_numpy(lens_np).cuda()
        outs = [(torch.zeros((b, 128), dtype=torch.uint8, device="cuda"),
                 torch.rand(b, n_rules, device="cuda") < 0.01)
                for _ in range(2)]
        outs[1][1].copy_(outs[0][1])
        bytes_ops.regex_list(acc, sl, width, rx, *outs[0])
        bytes_ops.regex_list_plain(acc, sl, width, *rx.on(acc.device),
                                   *outs[1])
        bytes_ops.cidr_list(sb, sl, cidr, outs[0][0])
        bytes_ops.cidr_list_plain(sb, sl, *cidr.on(sb.device), outs[1][0])
        for part, g, w in zip(("lstate", "err"), *outs):
            assert_equal(f"list_banks edge {part}", g, w)
        st = outs[0][0]
        bits = [int(((st & m) != 0).sum()) for m in (1, 2, 4)]
        if lens_np is lens and not (bits[0] and bits[1]):
            raise AssertionError(f"list_banks edge: member / und {bits}")
        if lens_np is not lens and not (bits[0] and bits[2]):
            raise AssertionError(f"list_banks edge: member / bad {bits}")
        cases += 1
    return cases


TELEMETRY_HTTP = ("requestcount", "requestduration", "requestsize",
                  "responsesize")
TELEMETRY_TCP = ("tcpbytesent", "tcpbytereceived")


def telemetry_world(store) -> None:
    """Istio's default Mixer telemetry config (install/kubernetes/
    istio.yaml of Istio 0.4/0.5: its metric, prometheus, logentry and
    rule resources) added to `store` with store.set alone, so that either
    package's MemStore takes it: six metrics into a prometheus handler
    `handler` and the accesslog logentry. Upstream routes the access log
    to the stdio adapter, which is not ported (it would print every
    record); it goes to a noop handler `sink` here."""
    ns = "istio-system"
    labels = ["source_service", "source_version", "destination_service",
              "destination_version", "response_code", "connection_mtls"]
    tcp_labels = [x for x in labels if x != "response_code"]
    kinds = {"requestcount": "COUNTER", "requestduration": "DISTRIBUTION",
             "requestsize": "DISTRIBUTION", "responsesize": "DISTRIBUTION",
             "tcpbytesent": "COUNTER", "tcpbytereceived": "COUNTER"}
    store.set(("handler", ns, "handler"), {
        "adapter": "prometheus", "params": {"metrics": [
            {"name": f"{m}.{ns}", "kind": kinds[m],
             "label_names": labels if m in TELEMETRY_HTTP else tcp_labels}
            for m in TELEMETRY_HTTP + TELEMETRY_TCP]}})
    store.set(("handler", ns, "sink"), {"adapter": "noop", "params": {}})
    dims = {"source_service": 'source.service | "unknown"',
            "source_version": 'source.labels["version"] | "unknown"',
            "destination_service": 'destination.service | "unknown"',
            "destination_version":
                'destination.labels["version"] | "unknown"',
            "response_code": "response.code | 200",
            "connection_mtls": "connection.mtls | false"}
    values = {"requestcount": "1",
              "requestduration": 'response.duration | "0ms"',
              "requestsize": "request.size | 0",
              "responsesize": "response.size | 0",
              "tcpbytesent": "connection.sent.bytes | 0",
              "tcpbytereceived": "connection.received.bytes | 0"}
    for m, value in values.items():
        store.set(("instance", ns, m), {"template": "metric", "params": {
            "value": value,
            "dimensions": {k: v for k, v in dims.items()
                           if m in TELEMETRY_HTTP or k != "response_code"},
            "monitored_resource_type": '"UNSPECIFIED"'}})
    store.set(("instance", ns, "accesslog"), {
        "template": "logentry", "params": {
            "severity": '"Default"', "timestamp": "request.time",
            "variables": {
                "sourceIp": 'source.ip | ip("0.0.0.0")',
                "destinationIp": 'destination.ip | ip("0.0.0.0")',
                "sourceUser": 'source.user | ""',
                "method": 'request.method | ""',
                "url": 'request.path | ""',
                "protocol": 'request.scheme | "http"',
                "responseCode": "response.code | 0",
                "responseSize": "response.size | 0",
                "requestSize": "request.size | 0",
                "latency": 'response.duration | "0ms"'}}})
    q = lambda *names: [f"{x}.{ns}" for x in names]  # noqa: E731
    for name, match, handler, insts in (
            ("promhttp", 'context.protocol == "http"', "handler",
             TELEMETRY_HTTP),
            ("promtcp", 'context.protocol == "tcp"', "handler",
             TELEMETRY_TCP),
            ("stdio", "true", "sink", ("accesslog",))):
        store.set(("rule", ns, name), {"match": match, "actions": [
            {"handler": f"{handler}.{ns}", "instances": q(*insts)}]})


def telemetry_dicts(b: int, seed: int) -> list[dict]:
    """Report traffic for the telemetry world: make_request_dicts(b,
    seed) plus seeded report attributes — context.protocol http on 90 %
    of records and tcp on 10 %, response.code in {200, 404, 503},
    response.size (absent on 1 in 6), response.duration, request.time,
    source.service, source / destination labels with version v1 or v2
    (absent on 1 in 5), IPv4 source / destination ips (absent on 1 in
    7), and the connection byte counts on tcp records. These ratios are
    a synthetic mix chosen for parity coverage (every default branch of
    the config, both rules), not taken from a measured deployment: the
    http / tcp split sets the instances per record (5 against 3), so
    report() walls at this mix are this mix's only."""
    import datetime

    import numpy as np
    from istio_tpu_torch.testing import workloads
    rng = np.random.default_rng(seed)
    t0 = datetime.datetime(2018, 3, 1, 12, 0, 0,
                           tzinfo=datetime.timezone.utc)
    dicts = workloads.make_request_dicts(b, seed=seed)
    for j, d in enumerate(dicts):
        tcp = rng.random() < 0.1
        d["context.protocol"] = "tcp" if tcp else "http"
        d["response.code"] = int(rng.choice([200, 404, 503]))
        if rng.random() >= 1 / 6:
            d["response.size"] = int(rng.integers(0, 1 << 20))
        d["response.duration"] = datetime.timedelta(
            microseconds=int(rng.integers(0, 2_000_000)))
        d["request.time"] = t0 + datetime.timedelta(milliseconds=j)
        d["source.service"] = \
            f"svc{rng.integers(0, 512)}.ns{rng.integers(0, 23)}" \
            ".svc.cluster.local"
        for side in ("source", "destination"):
            if rng.random() >= 1 / 5:
                d[f"{side}.labels"] = {
                    "version": "v1" if rng.random() < 0.5 else "v2",
                    "app": f"app{rng.integers(0, 40)}"}
            if rng.random() >= 1 / 7:
                d[f"{side}.ip"] = bytes(rng.integers(0, 256, size=4)
                                        .astype(np.uint8).tolist())
        if tcp:
            d["connection.sent.bytes"] = int(rng.integers(0, 1 << 24))
            d["connection.received.bytes"] = int(rng.integers(0, 1 << 24))
    return dicts


class CaptureSink:
    """Stands in for a built report handler: keeps every (template,
    instances) call when `keep` (else counts instances), and hands each
    instance on, one at a time, to the handler it replaced. The
    prometheus adapter refuses a DURATION value (float() of a timedelta,
    as in the JAX package's adapter); those refusals are counted, where
    the dispatcher would log each one as an adapter failure."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.keep = True
        self.calls: list = []
        self.instances = 0
        self.refused = 0

    def handle_report(self, template, instances) -> None:
        if self.keep:
            self.calls.append((template, [dict(i) for i in instances]))
        self.instances += len(instances)
        for inst in instances:
            try:
                self.inner.handle_report(template, [inst])
            except TypeError:
                self.refused += 1


def program_work(batch, prog) -> tuple[float, float]:
    """(bytes, ops) an op program interpreter must read and do on this
    run's data: each record reads the id and presence of every distinct
    column the programs name, the map-presence byte of every map slot,
    and the length and the stored bytes (up to its length) of every
    byte slot; the op and constant tables are read once. Each op row is
    a few int32 ops per record, and each byte op compares one byte per
    stored byte of the slot it reads."""
    import torch
    from istio_tpu_torch.ops import field_ops as fo
    ops = prog.ops
    cols, maps, slots, byte_rows = set(), set(), set(), {}
    for o in ops:
        if o[0] in (fo.OP_VAR, fo.OP_DSLOT, fo.OP_EXTERN):
            cols.add(int(o[1]))
        elif o[0] == fo.OP_MAPSEL:
            cols |= {int(o[1]), int(o[2])}
            maps |= {int(o[3]), int(o[4])}
        elif o[0] == fo.OP_BSLOT:
            cols.add(int(o[2]))
            slots.add(int(o[1]))
            byte_rows[int(o[1])] = byte_rows.get(int(o[1]), 0) + 1
    nb = batch.ids.shape[0]
    w = batch.str_bytes.shape[2]
    stored = {s: int(torch.clamp(batch.str_lens[:, s], 0, w).sum())
              for s in slots}
    b = nb * (5 * len(cols) + len(maps) + 4 * len(slots)) + \
        sum(stored.values()) + ops.nbytes + prog.starts.nbytes + \
        prog.consts.nbytes
    return float(b), float(nb) * 4 * len(ops) + float(
        sum(stored[s] * k for s, k in byte_rows.items()))


def field_work(batch, prog, got) -> tuple[float, float]:
    """(bytes, ops) field_eval must move and do on this run's data: its
    programs' reads (program_work) and the output rows, written once."""
    b, ops = program_work(batch, prog.prog)
    return b + nbytes(got), ops


def atom_work(batch, atoms) -> tuple[float, float]:
    """(bytes, ops) atom_eval must move and do on this run's data: its
    programs' reads (program_work) and each atom's m and n bytes per
    record, written once."""
    b, ops = program_work(batch, atoms.prog)
    return b + 2.0 * batch.ids.shape[0] * atoms.n + atoms.cols.nbytes, ops


# report fields for field_eval's edge inputs: every op of the op programs
# (CONST, VAR, DSLOT, MAPSEL, EXTERN, ERR, OR, EQ, NEQ, LAND, LOR, the byte
# views BSLOT and BCONST, an ordered compare CMP, a runtime-pattern prefix
# DPRED, constant byte predicates BPRED, a regex DFA, and a `|` chain
# deeper than a left-to-right stack of 8)
EDGE_FIELDS = (
    "request.size | 0", "connection.mtls", 'source.user | "anon"',
    'request.headers["host"]', '(request.headers | response.headers)["host"]',
    'ip(request.headers["x-ip"])', 'timestamp(request.headers["ts"])',
    'ip("not-an-ip")', 'source.ip | ip("10.0.0.1")',
    "source.user == destination.user", 'request.method != "GET"',
    'connection.mtls && request.method == "GET"',
    "connection.mtls || request.size == 7",
    'request.path.startsWith("/api")', 'match(request.host, "*.local")',
    '"^/api/v[0-9]+/".matches(request.path)',
    "request.path.startsWith(request.host)", "request.size > 100",
    " | (".join(["source.user", "destination.user", "request.host",
                 "request.method", "request.path", "request.scheme",
                 "source.name", "destination.name", "source.namespace",
                 "request.id"]) + ' | "zz"' + ")" * 9,
    "response.code | 200", "true", "request.time")


def edge_field_dicts(b: int, seed: int) -> list[dict]:
    """Records for field_eval's edge inputs: each attribute present on 3
    in 4 records, every fifth record empty, runtime values that are not
    interned (ephemeral ids), strings past the byte-slot width."""
    import datetime

    import numpy as np
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    t0 = datetime.datetime(2018, 3, 1, tzinfo=datetime.timezone.utc)
    out = []
    for j in range(b):
        d = {}
        for attr, vals in (
                ("request.path", ["/api/v1/x", "/apx", "svc.local/x", "",
                                  f"/p{j}", "/api/" + "y" * 140]),
                ("request.host", ["svc.local", "a.b", "/api", f"h{j}",
                                  "h" * 130]),
                ("request.size", [7, 99, 100, 101, j]),
                ("request.method", ["GET", "POST"]),
                ("source.user", ["alice", "bob", f"u{j}"]),
                ("destination.user", ["alice", "carol"]),
                ("connection.mtls", [True, False]),
                ("response.code", [200, 503]),
                ("request.time", [t0, t0 + datetime.timedelta(seconds=j)]),
                ("source.ip", [bytes([10, 1, 2, 3]),
                               bytes([9, 9, j % 256, 9])]),
                ("request.headers", [{"host": "h1", "x-ip": "10.0.0.9",
                                      "ts": "2018-03-01T12:00:00Z"},
                                     {"x-ip": "bad", "ts": "never"},
                                     {"host": f"x{j}"}, {}]),
                ("response.headers", [{"host": "h2"}, {}])):
            if rng.random() < 0.75:
                d[attr] = pick(vals)
        out.append({} if j % 5 == 0 else d)
    return out


def field_edge_checks() -> int:
    """Phase 8b: field_eval against field_eval_plain (the closures) and
    field_eval_ops_plain (the op table) on the card, on EDGE_FIELDS over
    GLOBAL_MANIFEST: F = 0, 1, 22 and 33 fields, B = 777 records (not a
    multiple of the block) with empty rows and ephemeral ids, every
    opcode present, on the full byte plane and on one narrowed to 32
    bytes (records whose strings fit). → cases."""
    import torch
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
    from istio_tpu_torch.compiler import layout as lay_mod
    from istio_tpu_torch.compiler import tensor_expr as te
    from istio_tpu_torch.compiler.op_lower import lower_programs
    from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
    from istio_tpu_torch.expr.parser import parse
    from istio_tpu_torch.ops import field_ops as fo

    finder = AttributeDescriptorFinder(GLOBAL_MANIFEST)
    asts = [parse(t) for t in EDGE_FIELDS]
    reqs = te.Requirements()
    for a in asts:
        te.collect_requirements(a, finder, reqs)
    layout = lay_mod.build_layout(
        GLOBAL_MANIFEST, sorted(reqs.derived_keys),
        sorted(reqs.byte_sources, key=str),
        extern_sources=[(n, k, a) for (n, k), a in
                        sorted(reqs.extern_sources.items(),
                               key=lambda kv: kv[0])])
    interner = lay_mod.InternTable()
    fns = [te.compile_field(a, finder, layout, interner)[0] for a in asts]
    dicts = edge_field_dicts(777, seed=21)
    tens = lay_mod.Tensorizer(layout, interner)
    full = tens.tensorize([bag_from_mapping(d) for d in dicts]).to("cuda")
    short = tens.tensorize([bag_from_mapping(d) for d in dicts if all(
        len(v) <= 32 for v in d.values() if isinstance(v, str))])
    short = dataclasses.replace(
        short, str_bytes=short.str_bytes[:, :, :32].contiguous()).to("cuda")
    n = len(asts)
    cases = 0
    for pick in ([], [0], list(range(n)), [i % n for i in range(33)]):
        prog = fo.FieldProgram(
            fns=[fns[i] for i in pick],
            prog=lower_programs([asts[i] for i in pick], layout, interner,
                                finder))
        for width, batch in (("full", full), ("narrowed", short)):
            got = fo.field_eval(batch, prog)
            torch.cuda.synchronize()
            tag = f"field_eval edge F={len(pick)} {width}"
            assert_equal(tag, got, fo.field_eval_plain(batch, prog))
            assert_equal(f"{tag} (op table)", got,
                         fo.field_eval_ops_plain(batch, prog))
            cases += 1
        if len(pick) == n:
            seen = {int(o) for o in prog.prog.ops[:, 0]}
            if seen != set(range(len(fo.OP_NAMES))):
                raise AssertionError(f"field_eval edge: opcodes {seen}")
            got = fo.field_eval(full, prog)
            if not bool((got[:len(pick)] < 0).any()):
                raise AssertionError("field_eval edge: no ephemeral id")
    return cases


REPORT_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold",
                  "check_pack", "field_eval")


def report_stage_sums() -> dict:
    from istio_tpu_torch.runtime import monitor
    h = monitor.REPORT_STAGE_SECONDS
    return {st: h.sum(st) for st in monitor.REPORT_STAGES}


def telemetry_server(device: str, args: dict):
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads
    store = workloads.make_store(HEADLINE_RULES)
    telemetry_world(store)
    srv = RuntimeServer(store, ServerArgs(**args), device=device)
    d = srv.controller.dispatcher
    sinks = {h: CaptureSink(d.handlers[h]) for h in
             ("handler.istio-system", "sink.istio-system")}
    d.handlers.update(sinks)
    return srv, store, sinks


class FullGcClock:
    """gc.callbacks hook: the wall time of each collection of the
    interpreter's oldest generation (a full collection walks every live
    object, the 10k-rule snapshots' among them)."""

    def __init__(self) -> None:
        self.t0 = None
        self.pauses: list[float] = []

    def __call__(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            self.pauses.append((time.perf_counter() - self.t0) * 1e3)
            self.t0 = None


def dtoh_copies(fn) -> int | None:
    """Device→host copies the profiler saw during fn(); None when it
    recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None
    return sum(e.count for e in evs if "DtoH" in e.key)


def report_pull_checks(captured, pull, head: int, cpu_plan, batch,
                       ns_ids) -> None:
    """The one pull of a captured report trip, row block by row block:
    check_pack's rows (written through its out= view of the shared
    buffer) equal check_pack_plain on the trip's captured inputs,
    field_eval's rows equal field_eval_plain on its captured inputs, and
    the whole pull is byte-equal to the device="cpu" server's plan on
    the same tensorized batch."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import field_ops
    from istio_tpu_torch.runtime import fused
    ins = {}
    for name, inputs in captured:
        ins.setdefault(name, []).append(inputs)
    if len(ins.get("check_pack", ())) != 1 or \
            len(ins.get("field_eval", ())) != 1:
        raise AssertionError("report trip: want one check_pack and one "
                             "field_eval launch, got "
                             f"{ {k: len(v) for k, v in ins.items()} }")
    got = torch.from_numpy(np.ascontiguousarray(pull))
    assert_equal("report pull: check_pack rows", got[:head],
                 fused.check_pack_plain(*ins["check_pack"][0]))
    assert_equal("report pull: field_eval rows", got[head:],
                 field_ops.field_eval_plain(*ins["field_eval"][0]))
    want = cpu_plan.packed_report(batch, ns_ids)
    if want.dtype != pull.dtype or not np.array_equal(want, pull):
        raise AssertionError("report pull differs from the device='cpu' "
                             "server's packed_report on the same batch")
    log(f"[8] report pull [{pull.shape[0]}, {pull.shape[1]}] int32: the "
        f"{head} check_pack rows and the {pull.shape[0] - head} field_eval "
        "rows equal their plain versions on the trip's inputs; the whole "
        "pull byte-equal to the device='cpu' server's")


def report_phase(int_rate: float) -> dict:
    """Phase 8: the served Report() path at the telemetry world
    (make_store(10_000) + Istio's default telemetry config), the launch
    counters zeroed just before its drive and read just after. The
    card's RuntimeServer (report coalescer on, pipeline=1 so records
    export in order) against a device="cpu" server: == instances into the
    capture sinks and equal prometheus series at B ∈ E2E_BATCHES; rule
    counts untouched by report traffic; one field_eval launch and one
    device→host copy per report trip; report() timed (p50 / p99,
    records/s, the five report stages, trips per call, device busy and
    idle share); field_eval held against its plain version on the
    path's B=2048 trip, with every other kernel of that trip (timed:
    field_eval's kernels table row and the others' report rows), and the
    trip's one pull checked block by block (report_pull_checks)."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping

    t0 = time.perf_counter()
    # no rule-stats drainer: its pulls would land among the report trips'
    srv, store, sinks = telemetry_server(
        "cuda", dict(buckets=E2E_BATCHES, max_batch=HEADLINE_B, pipeline=1,
                     rulestats_drain_s=0))
    build_s = time.perf_counter() - t0
    cpu, cpu_store, cpu_sinks = telemetry_server(
        "cpu", dict(CPU_SERVER, max_batch=HEADLINE_B, pipeline=1))
    d = srv.controller.dispatcher
    plan, snap = d.fused, d.snapshot
    rl = plan.report_lowering
    head = 5 + plan.n_ref_words + plan.n_overlay_words
    shape = (len(snap.rules), len(plan.report_rules), len(rl.specs),
             len(rl.host_instances), rl.n_fields)
    log(f"[8] telemetry world: snapshot + plan + warm on the card "
        f"{build_s:.2f} s; {shape[0]} rules, errors {len(snap.errors)}, "
        f"{shape[1]} report rules, {shape[2]} report instances lowered "
        f"({shape[3]} host-built), F = {shape[4]} field programs "
        f"({len(rl.program.prog.ops)} op rows, stack "
        f"{rl.program.prog.need}, 0 LEAF rows: every field an op program); "
        f"pull {head} check rows + {rl.n_fields} value rows + "
        f"{rl.n_valid_words} valid words = "
        f"{head + rl.n_fields + rl.n_valid_words} int32 rows x B")
    if shape != (HEADLINE_RULES + 5, 4, 8, 0, 60) or snap.errors:
        raise AssertionError(f"telemetry world {shape}, errors "
                             f"{snap.errors[:3]}")
    trips, last = [], []
    packed_report = plan.packed_report

    def counted(*a, **kw):
        trips.append(1)
        last[:] = [a, packed_report(*a, **kw)]
        return last[1]

    plan.packed_report = counted
    kernels.launches.reset()
    before = rule_counts(srv)
    for b in E2E_BATCHES:
        bags = [bag_from_mapping(x) for x in telemetry_dicts(b, seed=b)]
        for s in (*sinks.values(), *cpu_sinks.values()):
            s.calls, s.refused = [], 0
        n0 = len(trips)
        pulls = dtoh_copies(lambda: srv.report(bags))
        n_trips = len(trips) - n0
        cpu.report(bags)
        for h, s in sinks.items():
            c = cpu_sinks[h]
            if s.calls != c.calls or s.refused != c.refused:
                raise AssertionError(f"report B={b}: instances into {h} "
                                     "differ from the CPU server's")
        prom, cprom = (x["handler.istio-system"].inner
                       for x in (sinks, cpu_sinks))
        if prom.series != cprom.series or not prom.series:
            raise AssertionError(f"report B={b}: prometheus series differ")
        if pulls is None or pulls != n_trips:
            raise AssertionError(f"report B={b}: {pulls} device-to-host "
                                 f"copies for {n_trips} trips")
        per_tmpl: dict = {}
        for s in sinks.values():
            for tmpl, insts in s.calls:
                per_tmpl[tmpl] = per_tmpl.get(tmpl, 0) + len(insts)
        log(f"[8] report B={b}: instances equal to the device='cpu' "
            f"server's in order ({per_tmpl}; prometheus refused "
            f"{sinks['handler.istio-system'].refused} DURATION values on "
            f"both), {len(prom.series)} prometheus series equal; "
            f"{n_trips} trips, {pulls} device-to-host copies")
    for s in sinks.values():
        s.keep = False
    results = {}
    for b in E2E_BATCHES:
        bags = [bag_from_mapping(x) for x in telemetry_dicts(b, seed=b)]
        for _ in range(2):
            srv.report(bags)
        st0, n0 = report_stage_sums(), len(trips)
        walls = []
        gc_clock = FullGcClock()
        gc.callbacks.append(gc_clock)
        try:
            for _ in range(SERVED_ITERS):
                t = time.perf_counter()
                srv.report(bags)
                walls.append((time.perf_counter() - t) * 1e3)
        finally:
            gc.callbacks.remove(gc_clock)
        st1 = report_stage_sums()
        gcs = gc_clock.pauses
        per_call = (len(trips) - n0) / SERVED_ITERS
        busy = device_ms(lambda: srv.report(bags), 5)
        p50, p99 = (float(np.percentile(walls, q)) for q in (50, 99))
        stages = {k: (st1[k] - st0[k]) * 1e3 / SERVED_ITERS for k in st1}
        idle = "not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {1 - busy / p50:.3f}"
        # the same records as ONE trip: Dispatcher.report, no coalescer
        n1 = len(trips)
        one = []
        for _ in range(SERVED_ITERS):
            t = time.perf_counter()
            d.report(bags)
            one.append((time.perf_counter() - t) * 1e3)
        if len(trips) - n1 != SERVED_ITERS:
            raise AssertionError("Dispatcher.report took more than one trip")
        one_p50 = float(np.percentile(one, 50))
        one_busy = device_ms(lambda: d.report(bags), 5)
        log(f"[8] report B={b:5d}: wall p50 {p50:.4f} ms p99 {p99:.4f} ms "
            f"= {b / p50 * 1e3:,.0f} records/s; {per_call:.2f} trips per "
            f"call ({idle}); stages ms/call "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
            + f"; {len(gcs)} full GC collections in the loop"
            + (f" (max {max(gcs):.1f} ms, sum {sum(gcs):.1f} ms)" if gcs
               else "")
            + f"; as one trip (Dispatcher.report) p50 {one_p50:.4f} ms = "
            f"{b / one_p50 * 1e3:,.0f} records/s, "
            + ("busy not measured" if one_busy is None else
               f"busy {one_busy:.4f} ms, idle share "
               f"{1 - one_busy / one_p50:.3f} per trip"))
        results[b] = {"p50_ms": p50, "p99_ms": p99,
                      "records_per_s": b / p50 * 1e3,
                      "trips_per_call": per_call, "busy_ms": busy,
                      "idle_share": None if busy is None else
                      1 - busy / p50, "stages_ms": stages,
                      "one_trip_p50_ms": one_p50,
                      "one_trip_busy_ms": one_busy, "full_gc_ms": gcs}
    bags = [bag_from_mapping(x) for x in
            telemetry_dicts(HEADLINE_B, seed=HEADLINE_B)]
    n1 = len(trips)
    with kernels.launches.capture() as captured:
        d.report(bags)
    torch.cuda.synchronize()
    if len(trips) != n1 + 1:
        raise AssertionError("the captured report took more than one trip")
    (batch, ns_ids), pull = last
    del plan.packed_report
    if rule_counts(srv) != before:
        raise AssertionError("report traffic changed the rule counts")
    steps = len(trips)
    out = path_counts("[8] report path", REPORT_KERNELS, steps)
    one_atom_launch_per_step("[8] report path", out, snap.ruleset)
    if out["counts"]["field_eval"] != steps or out["counts"]["rule_stats"]:
        raise AssertionError(f"report path: {out['counts']['field_eval']} "
                             f"field_eval launches for {steps} trips, "
                             f"{out['counts']['rule_stats']} rule_stats")
    log(f"[8] report path: one field_eval launch per trip ({steps} trips), "
        "no rule-telemetry fold, rule counts unchanged; every kernel of "
        f"the B={HEADLINE_B} trip against its plain version on that trip's "
        "inputs (timed):")
    rows = check_kernels(captured, plan.engine.quota_counts.clone(),
                         int_rate)
    report_pull_checks(captured, pull, head,
                       cpu.controller.dispatcher.fused, batch, ns_ids)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    return {**out, "results": results, "rows": rows}


# ---------------------------------------------------------------------------
# phase 9: the served Quota() path (K9 quota_alloc)
# ---------------------------------------------------------------------------

QUOTA_INSTANCE = "rq.istio-system"
QUOTA_KEYS = 100_000          # bench.py's config 4: 100k live keys
# the default quota of Istio's Bookinfo rate-limit sample
# (samples/bookinfo/kube/mixer-rule-ratings-ratelimit.yaml: maxAmount
# 5000, validDuration 1s); its per-destination overrides are dropped
QUOTA_MAX, QUOTA_WINDOW_S = 5000, 1.0
QUOTA_T0, QUOTA_STEP_S = 1000.0, 0.01   # injected clock, step per batch
QUOTA_ZIPF = 1.3              # bench.py:2290's key skew
# compared batches per stage: enough unit traffic at 2048 that the hot
# keys ask for more than QUOTA_MAX inside one window
QUOTA_UNIT_BATCHES = {64: 3, 256: 3, 2048: 10}
QUOTA_MIXED_BATCHES = {64: 3, 256: 3, 2048: 4}
QUOTA_ITERS = 20              # timed calls per batch size
QUOTA_KERNELS = SERVED_KERNELS + ("quota_alloc",)
QUOTA_REPLACES = {
    "fast": "istio_tpu/models/quota_alloc.py:177",
    "unit": "istio_tpu/models/quota_alloc.py:313",
    "seg": "istio_tpu/models/quota_alloc.py:230",
    "scan": "istio_tpu/models/quota_alloc.py:195",
    "instep": "istio_tpu/runtime/fused.py:467"}


def quota_world(store) -> None:
    """make_store's memquota handler `mq` with the Bookinfo sample's
    default limit on its `rq` quota (dimensions user: source.user |
    "anon", sent there by make_store's quota-rule, match "")."""
    store.set(("handler", "istio-system", "mq"), {
        "adapter": "memquota",
        "params": {"quotas": [{"name": QUOTA_INSTANCE,
                               "max_amount": QUOTA_MAX,
                               "valid_duration_s": QUOTA_WINDOW_S}]}})


class StepClock:
    """The pools' injected clock: moved only between batches."""

    def __init__(self) -> None:
        self.t = QUOTA_T0

    def __call__(self) -> float:
        return self.t


def quota_server(device: str, args: dict):
    """The quota world served on `device` with quota_in_step on → (server,
    store, its one pool, the pool's clock)."""
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads
    store = workloads.make_store(HEADLINE_RULES)
    quota_world(store)
    srv = RuntimeServer(store, ServerArgs(quota_in_step=True, **args),
                        device=device)
    pools = set(srv.controller.device_quotas.values())
    if len(pools) != 1:
        raise AssertionError(f"quota world: {len(pools)} device pools")
    pool = pools.pop()
    clock = StepClock()
    pool._clock = clock
    return srv, store, pool, clock


def quota_bags(users, seed: int) -> tuple[list, list]:
    """make_request_dicts traffic with source.user = user<u> → the same
    requests as bags for the card's server and for the CPU's."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.testing import workloads
    dicts = workloads.make_request_dicts(len(users), seed=seed)
    for d, u in zip(dicts, users):
        d["source.user"] = f"user{int(u)}"
    return ([bag_from_mapping(d) for d in dicts],
            [bag_from_mapping(d) for d in dicts])


def zipf_users(rng, b: int):
    return (rng.zipf(QUOTA_ZIPF, b) - 1) % QUOTA_KEYS


def capture_if(on: bool):
    """kernels.launches.capture() when `on`, else an empty list."""
    from contextlib import nullcontext
    from istio_tpu_torch import kernels
    return kernels.launches.capture() if on else nullcontext([])


def same_quota(label: str, got, want) -> None:
    for f in ("granted_amount", "status_code", "valid_duration_s",
              "status_message"):
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{label}: QuotaResult.{f}: card "
                                 f"{getattr(got, f)!r}, plain "
                                 f"{getattr(want, f)!r}")


def resolve(q):
    return q.result() if hasattr(q, "result") else q


def classic_round(srv, bags, args):
    """The served defer path: check_many, then quota_fused for every row
    whose check passed (the fronts' grpcServer.go:188 gate) → (responses,
    {row: QuotaResult})."""
    resp = srv.check_many(bags)
    futs = {i: srv.quota_fused(bags[i], "rq", a, r)
            for i, (r, a) in enumerate(zip(resp, args))
            if r.status_code == OK}
    return resp, {i: resolve(q) for i, q in futs.items()}


def quota_alloc_check(tag: str, mode: str, before, rows, gate) -> bool:
    """K9 against its plain version on one set of inputs: granted, the
    whole plane after the alloc, and the gate. → True."""
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    got_plane, want_plane = before.clone(), before.clone()
    b = int(rows[0].shape[0])
    gate_k = None if gate is None else torch.full(
        (b,), -1, dtype=torch.int32, device=before.device)
    got = qa.quota_alloc(mode, got_plane, *rows, gate=gate, gate_out=gate_k)
    want, want_gate = qa.quota_alloc_plain(mode, want_plane, *rows, gate)
    assert_equal(f"{tag} {mode} granted", got, want)
    assert_equal(f"{tag} {mode} plane", got_plane, want_plane)
    if gate is not None:
        assert_equal(f"{tag} {mode} gate", gate_k, want_gate.to(torch.int32))
    return True


def quota_work(mode: str, before, rows, gate) -> tuple[float, float]:
    """(bytes, int32 ops) the alloc needs on these inputs: each row input
    read once, granted (and gate) written once, and the rows of the
    plane its live rows touch read and written once; ops: the roll and
    the sum over K per live row, the grant's ~20, and for the contended
    modes a comparison sort's B log2 B."""
    import math
    import torch
    b = int(rows[0].shape[0])
    k = int(before.shape[1])
    live = rows[4] != 0
    touched = int(torch.unique(rows[0][live]).numel())
    n_bytes = 4.0 * b * len(rows) + 4.0 * b + 2 * 4.0 * k * touched
    if gate is not None:
        n_bytes += 4.0 * b * 4 + b + 4.0 * b   # status, rule, ns x2; matched
    ops = float(int(live.sum())) * (2 * k + 20)
    if mode != "fast":
        ops += b * math.log2(max(b, 2))
    return n_bytes, ops


def quota_alloc_times(mode: str, before, rows, gate):
    """Time K9 (in place on a scratch plane: later calls find the rolls
    done and the hot buckets fuller), its plain version and the
    library's stable argsort of the batch's bucket keys."""
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    scratch = before.clone()
    b = int(rows[0].shape[0])
    gate_k = None if gate is None else torch.zeros(
        b, dtype=torch.int32, device=before.device)
    ms, call, how = timed(lambda: qa.quota_alloc(
        mode, scratch, *rows, gate=gate, gate_out=gate_k), 200)
    plain, _, _ = timed(lambda: qa.quota_alloc_plain(
        mode, scratch, *rows, gate), 5 if mode == "scan" else 20)
    n_bytes, ops = quota_work(mode, before, rows, gate)
    lib, lib_call = None, None
    if mode != "fast":
        key = torch.where(rows[4] != 0, rows[0], 2**31 - 1)
        lib = time_ms(lambda: torch.argsort(key, stable=True), 200)
        lib_call = "torch.argsort(stable=True) of the bucket keys only"
    return ms, call, how, plain, n_bytes, ops, lib, lib_call


def quota_edge_rows(rng, n_buckets: int, k: int, b: int, kind: str,
                    device: str):
    """One edge batch → (plane, the 8 row tensors, modes to hold)."""
    import numpy as np
    import torch
    nb = n_buckets
    buckets = rng.integers(0, min(nb, 3 + b // 8), b)
    amounts = rng.integers(-2, 9, b)
    be = rng.random(b) < 0.4
    mx = np.take(rng.integers(5, 40, nb), buckets)
    active = rng.random(b) < 0.9
    ticks = np.take(rng.integers(20, 40, nb), buckets)
    gap = np.take(rng.choice([0, 1, k, k + 3, 3 * k, -1], nb), buckets)
    lasts = ticks - gap
    rolling = np.take(rng.random(nb) < 0.6, buckets)
    plane = rng.integers(0, 4, (nb, k))
    modes = ("scan", "unit", "seg")
    if kind == "over_domain":
        amounts[rng.random(b) < 0.2] = 1_500_000_000
        amounts[rng.random(b) < 0.1] = 1 << 21
        amounts[rng.random(b) < 0.1] = 0
    elif kind == "shrunken":
        plane[:, 0] = 2**31 - 5
        mx = mx - 50
    elif kind == "ties":
        amounts = rng.choice([3, 3, 3, 5], b)
        plane[:] = 2
    elif kind == "unique":
        buckets = rng.permutation(nb)[:b]
        mx, ticks = np.take(rng.integers(5, 40, nb), buckets), \
            np.take(rng.integers(20, 40, nb), buckets)
        lasts = ticks - np.take(rng.choice([0, 1, k, k + 3], nb), buckets)
        rolling = np.take(rng.random(nb) < 0.6, buckets)
        modes = ("scan", "fast", "seg")
    rows = [torch.from_numpy(np.asarray(x, np.int32)).to(device)
            for x in (buckets, amounts, be, mx, active, ticks, lasts,
                      rolling)]
    return torch.from_numpy(plane.astype(np.int32)).to(device), rows, modes


def quota_edge_checks(device: str = "cuda") -> int:
    """Phase 9b: K9 against its plain version on inputs the served
    traffic does not produce: negative, zero, DOMAIN_MAX and over-domain
    amounts; used > max; same-amount ties at the budget boundary;
    rolling and exact rows mixed with ticks - last of 0, 1, K, more
    than K and negative; K = 1; B = 1, 64, 512, 2048 and a ragged 777;
    the in-step gate with rule -1, a denied status, an invisible
    namespace, an unmatched rule and R = 0."""
    import numpy as np
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    rng = np.random.default_rng(77)
    n = 0
    for b, kind, k in ((1, "plain", 10), (64, "over_domain", 10),
                       (512, "shrunken", 10), (2048, "ties", 10),
                       (777, "plain", 10), (512, "unique", 10),
                       (2048, "unique", 10), (777, "over_domain", 1),
                       (64, "ties", 1)):
        plane, rows, modes = quota_edge_rows(rng, 4096, k, b, kind, device)
        if k == 1:
            rows[7].zero_()           # make_alloc_step: no row rolls
        for mode in modes:
            quota_alloc_check(f"edge {kind} B={b} K={k}", mode, plane, rows,
                              None)
            n += 1
        for n_rules in (5, 0):
            gate = qa.QuotaGate(
                status=torch.from_numpy(np.where(
                    rng.random(b) < 0.2, 7, 0).astype(np.int32)).to(device),
                matched=torch.from_numpy(rng.random((b, n_rules)) < 0.7).to(
                    device),
                rule_idx=torch.from_numpy(rng.integers(
                    -1, n_rules + 1, b).astype(np.int32)).to(device),
                rule_ns=torch.from_numpy(rng.integers(
                    0, 3, n_rules).astype(np.int32)).to(device),
                req_ns=torch.from_numpy(rng.integers(
                    -1, 3, b).astype(np.int32)).to(device),
                default_ns=0)
            quota_alloc_check(f"edge {kind} B={b} gate R={n_rules}", "seg",
                              plane, rows, gate)
            n += 1
    if device == "cuda":
        torch.cuda.synchronize()
    return n


def quota_ledger_checks(pool, ledger: list) -> dict:
    """Conservation on the card's pool after the drive: for every bucket
    a grant was committed to, the plane's row reads back exactly the sum
    of the grants committed at the ticks its last roll kept (last tick -
    K, last tick]; rows past the keymap are zero; and no key was granted
    more than QUOTA_MAX inside any window of K ticks."""
    import numpy as np
    from istio_tpu_torch.adapters.memquota import _key
    k = pool.k_ticks
    tick_len = QUOTA_WINDOW_S / k
    key_of = pool._bucket_of
    buckets = np.asarray([key_of[_key({"name": QUOTA_INSTANCE,
                                       "dimensions": {"user": u}})]
                          for u, _, _ in ledger], np.int64)
    ticks = np.asarray([int(now / tick_len) for _, now, _ in ledger],
                       np.int64)
    grants = np.asarray([g for _, _, g in ledger], np.int64)
    t0 = int(ticks.min())
    span = int(ticks.max()) - t0 + 1
    touched, inv = np.unique(buckets, return_inverse=True)
    per_tick = np.zeros((touched.size, span + k), np.int64)
    np.add.at(per_tick, (inv, ticks - t0 + k), grants)
    cum = np.cumsum(per_tick, axis=1)
    window = cum[:, k:] - cum[:, :-k]      # window ending at each tick
    worst = int(window.max())
    if worst > QUOTA_MAX:
        raise AssertionError(f"a key was granted {worst} > {QUOTA_MAX} "
                             "inside one window")
    last = pool._last_tick[touched] - t0
    if (last < 0).any() or (last >= span).any():
        raise AssertionError("a touched bucket's last tick lies outside "
                             "the drive")
    expect = window[np.arange(touched.size), last]
    plane = pool.counts.cpu().numpy().astype(np.int64)
    got = plane[touched].sum(axis=1)
    bad = np.nonzero(got != expect)[0]
    if bad.size:
        i = int(bad[0])
        raise AssertionError(f"bucket {int(touched[i])} reads back "
                             f"{int(got[i])}, its grants in the window sum "
                             f"to {int(expect[i])} ({bad.size} buckets "
                             "differ)")
    beyond = int(np.count_nonzero(plane[len(key_of):]))
    if beyond:
        raise AssertionError(f"{beyond} nonzero cells past the keymap")
    return {"buckets": int(touched.size), "grants": int(grants.sum()),
            "max_window": worst, "ticks": span}


def quota_phase(int_rate: float) -> dict:
    """Phase 9: the served Quota() path on the quota world
    (make_store(10_000) + the Bookinfo sample's limit, 100,000 live
    keys), the launch counters zeroed just before its drive and read just
    after. The card's server and a device="cpu" server, each pool on its
    own injected clock stepped QUOTA_STEP_S per batch:
      fill         100,000 unique users in a random order, check_many +
                   quota_fused per row on the card, the CPU pool's alloc
                   on the same instances (fast-mode flushes);
      classic unit zipf users, amount 1, check_many + quota_fused per
                   passed row from one thread (unit-mode flushes);
      in-step      check_batch_quota_instep on zipf users at amount 1,
                   then at amounts 1-5 (the seg kernel with the gate);
    every CheckResponse and QuotaResult equal to the CPU server's, at
    B in E2E_BATCHES. Then classic mixed amounts on the card alone
    (seg-mode flushes, whose grants depend on flush boundaries: held at
    the kernel level). One quota_alloc launch per flush and per in-step
    trip; conservation and the window limit on the card's plane; K9 vs
    its plain version on a captured trip of every mode (timed), then
    edge inputs (9b); walls, busy and idle share; K9 per mode at 512 and
    2048 rows."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.adapters.sdk import QuotaArgs

    t0 = time.perf_counter()
    srv, store, pool, clock = quota_server(
        "cuda", dict(buckets=E2E_BATCHES, max_batch=HEADLINE_B,
                     rulestats_drain_s=0))
    build_s = time.perf_counter() - t0
    cpu, cpu_store, cpu_pool, cpu_clock = quota_server(
        "cpu", dict(CPU_SERVER, max_batch=HEADLINE_B))
    plan = srv.controller.dispatcher.fused
    if srv.instep_quota_target() is None or \
            cpu.instep_quota_target() is None:
        raise AssertionError("quota world: the snapshot is not in-step "
                             "eligible")
    warmed = plan._instep_warmed
    log(f"[9] quota world: snapshot + plan + in-step warm {sorted(warmed)} "
        f"on the card {build_s:.2f} s; "
        f"{len(srv.controller.dispatcher.snapshot.rules)} rules, pool "
        f"[{pool.n_buckets}, {pool.k_ticks}] int32 "
        f"({pool.counts.numel() * 4 / 1e6:.2f} MB), limit {QUOTA_MAX} per "
        f"{QUOTA_WINDOW_S} s window")
    flushes, trips = [], []
    flush, instep = pool._flush, plan.packed_check_instep

    def counted_flush(batch):
        flushes.append(len(batch))
        return flush(batch)

    def counted_instep(*a, **kw):
        trips.append(1)
        return instep(*a, **kw)

    pool._flush, plan.packed_check_instep = counted_flush, counted_instep
    ledger: list = []       # (user, now, units consumed) on the card

    def book(users, results, resp=None):
        for i, q in results.items():
            if resp is None or resp[i].status_code == OK:
                ledger.append((f"user{int(users[i])}", clock.t,
                               q.granted_amount))

    def step():
        clock.t += QUOTA_STEP_S
        cpu_clock.t += QUOTA_STEP_S

    rng = np.random.default_rng(2279)
    captured: dict = {}
    kernels.launches.reset()
    checks = 0
    # ---- fill: 100k unique users through the classic path
    t_fill = time.perf_counter()
    users_all = rng.permutation(QUOTA_KEYS)
    inst = cpu.controller.dispatcher.snapshot.instances[QUOTA_INSTANCE]
    one = QuotaArgs(quota_amount=1)
    for n, lo in enumerate(range(0, QUOTA_KEYS, HEADLINE_B)):
        users = users_all[lo:lo + HEADLINE_B]
        bags, cbags = quota_bags(users, seed=lo)
        with capture_if(n == 0) as cap:
            resp = srv.check_many(bags)
            futs = [srv.quota_fused(b, "rq", one, r)
                    for b, r in zip(bags, resp)]
            got = {i: resolve(q) for i, q in enumerate(futs)}
        checks += 1
        want = [cpu_pool.alloc(QUOTA_INSTANCE, inst.build(b), one)
                for b in cbags]
        for i, q in enumerate(want):
            same_quota(f"fill batch {n} row {i}", got[i], q.result())
        book(users, got)
        if n == 0:
            captured["fast"] = [c for c in cap if c[0] == "quota_alloc"]
        step()
    if len(pool._bucket_of) != QUOTA_KEYS:
        raise AssertionError(f"fill: {len(pool._bucket_of)} live keys")
    modes = {c[1][0] for c in captured["fast"]}
    if modes != {"fast"}:
        raise AssertionError(f"fill flushes ran {modes}")
    log(f"[9] fill: {QUOTA_KEYS:,} unique users, {len(flushes)} flushes "
        f"(fast mode), every QuotaResult equal to the CPU pool's; "
        f"{len(pool._bucket_of):,} live keys of {pool.n_buckets:,} "
        f"({time.perf_counter() - t_fill:.1f} s)")
    # ---- classic path, unit amounts, one thread: grant by grant
    exhausted = {"classic": 0, "in-step unit": 0, "in-step mixed": 0}
    for b, n_batches in QUOTA_UNIT_BATCHES.items():
        for s in range(n_batches):
            users = zipf_users(rng, b)
            bags, cbags = quota_bags(users, seed=b + s)
            args = [one] * b
            cap_this = b == HEADLINE_B and s == 0
            with capture_if(cap_this) as cap:
                resp, got = classic_round(srv, bags, args)
            checks += 1
            cresp, want = classic_round(cpu, cbags, args)
            compare_responses(f"classic B={b} batch {s}", resp, cresp)
            if set(got) != set(want):
                raise AssertionError(f"classic B={b}: quota rows differ")
            for i in got:
                same_quota(f"classic B={b} batch {s} row {i}", got[i],
                           want[i])
            exhausted["classic"] += sum(q.status_code == RESOURCE_EXHAUSTED
                                        for q in got.values())
            book(users, got)
            if cap_this:
                captured["unit"] = [c for c in cap if c[0] == "quota_alloc"]
            step()
    modes = {c[1][0] for c in captured["unit"]}
    if modes != {"unit"}:
        raise AssertionError(f"contended unit flushes ran {modes}")
    log(f"[9] classic path (check_many + quota_fused), unit amounts: "
        f"{sum(QUOTA_UNIT_BATCHES.values())} batches at B in "
        f"{list(QUOTA_UNIT_BATCHES)}, responses and QuotaResults equal to "
        f"the CPU server's grant by grant; {exhausted['classic']} "
        "RESOURCE_EXHAUSTED (the hot keys pass the limit)")
    # ---- in-step: unit, then mixed amounts
    for label, batches in (("in-step unit", QUOTA_UNIT_BATCHES),
                           ("in-step mixed", QUOTA_MIXED_BATCHES)):
        for b, n_batches in batches.items():
            for s in range(n_batches):
                users = zipf_users(rng, b)
                amounts = np.ones(b, np.int64) if label == "in-step unit" \
                    else rng.integers(1, 6, b)
                be = rng.random(b) < 0.5
                bags, cbags = quota_bags(users, seed=7 * b + s)
                qrows = [(i, "rq", QuotaArgs(quota_amount=int(a),
                                             best_effort=bool(e)))
                         for i, (a, e) in enumerate(zip(amounts, be))]
                cap_this = b == HEADLINE_B and label == "in-step mixed"
                with capture_if(cap_this) as cap:
                    resp, got = srv.check_batch_quota_instep(
                        bags, qrows, srv.instep_quota_target())
                checks += 1
                cresp, want = cpu.check_batch_quota_instep(
                    cbags, qrows, cpu.instep_quota_target())
                compare_responses(f"{label} B={b} batch {s}", resp, cresp)
                if set(got) != set(want):
                    raise AssertionError(f"{label} B={b}: quota rows differ")
                for i in got:
                    same_quota(f"{label} B={b} batch {s} row {i}", got[i],
                               want[i])
                exhausted[label] += sum(
                    got[i].status_code == RESOURCE_EXHAUSTED
                    for i in got if resp[i].status_code == OK)
                book(users, got, resp)
                if cap_this:
                    captured["instep"] = [c for c in cap
                                          if c[0] == "quota_alloc"]
                step()
    log(f"[9] in-step path (check_batch_quota_instep): unit and mixed "
        f"amounts at B in {list(E2E_BATCHES)}, every CheckResponse and "
        f"QuotaResult equal to the CPU server's; RESOURCE_EXHAUSTED: "
        f"{exhausted['in-step unit']} unit, {exhausted['in-step mixed']} "
        "mixed")
    # ---- classic path, mixed amounts, the card alone (seg flushes)
    for s in range(2):
        users = zipf_users(rng, HEADLINE_B)
        bags, _ = quota_bags(users, seed=99 + s)
        args = [QuotaArgs(quota_amount=int(a), best_effort=bool(e))
                for a, e in zip(rng.integers(1, 6, HEADLINE_B),
                                rng.random(HEADLINE_B) < 0.5)]
        with capture_if(s == 0) as cap:
            resp, got = classic_round(srv, bags, args)
        checks += 1
        book(users, got)
        if s == 0:
            captured["seg"] = [c for c in cap if c[0] == "quota_alloc"]
        step()
    modes = {c[1][0] for c in captured["seg"]}
    if modes != {"seg"}:
        raise AssertionError(f"contended mixed flushes ran {modes}")
    torch.cuda.synchronize()
    pool._flush, plan.packed_check_instep = flush, instep
    out = path_counts("[9] quota path", QUOTA_KERNELS, checks)
    n_launch = out["counts"]["quota_alloc"]
    if n_launch != len(flushes) + len(trips) or \
            out["grids"]["quota_alloc"] != n_launch:
        raise AssertionError(f"quota_alloc: {n_launch} launches for "
                             f"{len(flushes)} flushes and {len(trips)} "
                             "in-step trips")
    log(f"[9] quota_alloc: {n_launch} launches = {len(flushes)} flushes "
        f"+ {len(trips)} in-step trips (one each)")
    cons = quota_ledger_checks(pool, ledger)
    log(f"[9] conservation: {cons['buckets']:,} buckets read back exactly "
        f"the grants committed inside their window ({cons['grants']:,} "
        f"units over {cons['ticks']} ticks); the most any key got inside "
        f"a window: {cons['max_window']} <= {QUOTA_MAX}; no cell past the "
        "keymap")
    # ---- K9 against its plain version on a captured trip of each mode
    rows = {}
    log("[9] quota_alloc against its plain version on captured trips "
        "(timed; seg also through the sequential scan):")
    for mode in ("fast", "unit", "seg", "instep"):
        caps = captured[mode]
        if not caps:
            raise AssertionError(f"no captured {mode} launch")
        for c in caps[1:]:
            check_kernels([c], None)
        # the largest captured launch of the mode is its timed row
        big = max(caps, key=lambda c: int(c[1][2].shape[0]))
        rows[mode] = check_kernels([big], None, int_rate)[0]
    mode_rows = quota_mode_times(pool, rng, int_rate)
    n_edge = quota_edge_checks(pool.counts.device.type)
    log(f"[9b] {n_edge} edge cases: quota_alloc equal to its plain version")
    results = quota_walls(srv, rng)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    log("[9c] quota_alloc above 8,192 rows (the multi-block path) against "
        "its plain version, zipf keys over the 100,000-key pool (timed; "
        f"{time.perf_counter() - t0:.1f} s into phase 9):")
    mode_rows.update(quota_big_checks(int_rate, rng))
    big = quota_instep_big(rng)
    row = dict(rows["instep"])
    row["path"] = "quota"
    row["modes"] = {m: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "bytes", "ops", "grids")
                        if k in r}
                    for m, r in {**rows, **mode_rows}.items()}
    return {**out, "results": results, "rows": [row], "conservation": cons,
            "flushes": len(flushes), "trips": len(trips),
            "instep_16384": big}


QUOTA_BIG_BATCHES = (8193, 32768)   # the multi-block K9 path
QUOTA_INSTEP_BIG = 16384            # ServerArgs(max_batch=16384) trip
QUOTA_INSTEP_BIG_TRIPS = 1
K9_SCAN_TILE = 4096                 # csrc/quota_alloc.cu kScanTile


def quota_big_rows(rng, b: int, mode: str, device: str):
    """One contended batch of `b` rows: zipf(QUOTA_ZIPF) keys over the
    QUOTA_KEYS pool (per-key max / tick / last / rolling), amounts 1
    (unit) or -1..5, a random [QUOTA_KEYS, 10] plane, and for "gate"
    the in-step gate inputs → (plane, rows, gate, the hot key's run)."""
    import numpy as np
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    nb, k = QUOTA_KEYS, 10
    keys = zipf_users(rng, b).astype(np.int64)
    amounts = np.ones(b) if mode == "unit" else rng.integers(-1, 6, b)
    per_key = [rng.integers(40, 400, nb), rng.integers(0, 3 * k, nb),
               rng.integers(0, 3 * k, nb), rng.random(nb) < 0.7]
    mx, ticks, lasts, rolling = (np.take(x, keys) for x in per_key)
    rows = [torch.from_numpy(np.asarray(x).astype(np.int32)).to(device)
            for x in (keys, amounts, rng.random(b) < 0.4, mx,
                      rng.random(b) < 0.9, ticks, lasts, rolling)]
    plane = torch.from_numpy(rng.integers(0, 3, (nb, k)).astype(
        np.int32)).to(device)
    gate = None
    if mode == "gate":
        n_rules = 5

        def t(x):
            return torch.from_numpy(np.asarray(x)).to(device)

        gate = qa.QuotaGate(
            status=t(np.where(rng.random(b) < 0.2, 7, 0).astype(np.int32)),
            matched=t(rng.random((b, n_rules)) < 0.7),
            rule_idx=t(rng.integers(-1, n_rules + 1, b).astype(np.int32)),
            rule_ns=t(rng.integers(0, 3, n_rules).astype(np.int32)),
            req_ns=t(rng.integers(-1, 3, b).astype(np.int32)),
            default_ns=0)
    hot = int(np.bincount(keys).max())
    return plane, rows, gate, hot


def quota_big_checks(int_rate: float, rng) -> dict:
    """Phase 9 (the K9 repair): quota_alloc above the one-block path's
    8,192 rows, against its plain version in unit, seg, scan and gated
    seg at QUOTA_BIG_BATCHES rows, each timed with its grids and bound.
    At 32,768 rows the hottest key's run is longer than a scan tile, so
    its sums and running maxima cross block seams."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.models import quota_alloc as qa
    out = {}
    for b in QUOTA_BIG_BATCHES:
        for mode in ("unit", "seg", "scan", "gate"):
            plane, rows, gate, hot = quota_big_rows(rng, b, mode, "cuda")
            if b == QUOTA_BIG_BATCHES[-1] and hot <= K9_SCAN_TILE:
                raise AssertionError(f"B={b}: the hottest key has {hot} "
                                     "rows, no run spans several tiles")
            kmode = "seg" if mode == "gate" else mode
            quota_alloc_check(f"big {mode} B={b}", kmode, plane, rows, gate)
            g0 = kernels.launches.grids["quota_alloc"]
            gate_k = None if gate is None else torch.zeros(
                b, dtype=torch.int32, device="cuda")
            qa.quota_alloc(kmode, plane.clone(), *rows, gate=gate,
                           gate_out=gate_k)
            grids = kernels.launches.grids["quota_alloc"] - g0
            if grids < 2:
                raise AssertionError(f"B={b} {mode}: {grids} grid(s), the "
                                     "multi-block path did not run")
            ms, call, how, plain, n_bytes, ops, lib, _ = quota_alloc_times(
                kmode, plane, rows, gate)
            bms, by = bound(n_bytes, ops, int_rate)
            log(f"  quota_alloc {mode:<5} B={b:6d} kernel {ms:9.5f} ms (per "
                f"call incl. launch {call:8.5f}, {grids} grids)   plain "
                f"{plain:9.5f} ms   bound {bms:9.7f} ms ({by})   equal: yes"
                f"   hottest key {hot} rows   [{how}]   argsort "
                f"{lib:9.5f} ms")
            out[f"{mode}@{b}"] = {"ms": ms, "plain_ms": plain,
                                  "bound_ms": bms, "bound_by": by,
                                  "library_ms": lib, "bytes": n_bytes,
                                  "ops": ops, "grids": grids,
                                  "hot_rows": hot}
    return out


def quota_instep_big(rng) -> dict:
    """Phase 9: in-step trips of QUOTA_INSTEP_BIG rows — the card's
    server at ServerArgs(max_batch=16384, quota_in_step=True) with a
    16,384 bucket (its constructor warms it) against a device="cpu"
    server: every CheckResponse and QuotaResult equal, one quota_alloc
    launch on the multi-block path, and conservation on the card's
    plane."""
    import numpy as np
    from istio_tpu_torch import kernels
    from istio_tpu_torch.adapters.sdk import QuotaArgs
    b = QUOTA_INSTEP_BIG
    t_build = time.perf_counter()
    srv, store, pool, clock = quota_server(
        "cuda", dict(buckets=(b,), max_batch=b, rulestats_drain_s=0))
    cpu, cpu_store, _, cpu_clock = quota_server(
        "cpu", dict(CPU_SERVER, max_batch=b))
    build_s = time.perf_counter() - t_build
    plan = srv.controller.dispatcher.fused
    if not any(b in key[0] for key in plan._instep_warmed):
        raise AssertionError(f"in-step warm {sorted(plan._instep_warmed)} "
                             f"lacks the {b} bucket")
    ledger, walls, cpu_walls = [], [], []
    for s in range(QUOTA_INSTEP_BIG_TRIPS):
        users = zipf_users(rng, b)
        bags, cbags = quota_bags(users, seed=31 + s)
        qrows = [(i, "rq", QuotaArgs(quota_amount=int(a),
                                     best_effort=bool(e)))
                 for i, (a, e) in enumerate(zip(rng.integers(1, 6, b),
                                                rng.random(b) < 0.5))]
        g0 = dict(kernels.launches.grids)
        n0 = kernels.launches["quota_alloc"]
        t0 = time.perf_counter()
        resp, got = srv.check_batch_quota_instep(
            bags, qrows, srv.instep_quota_target())
        walls.append((time.perf_counter() - t0) * 1e3)
        if kernels.launches["quota_alloc"] != n0 + 1 or \
                kernels.launches.grids["quota_alloc"] - \
                g0["quota_alloc"] < 2:
            raise AssertionError(f"in-step B={b}: not one multi-block "
                                 "quota_alloc launch")
        t0 = time.perf_counter()
        cresp, want = cpu.check_batch_quota_instep(
            cbags, qrows, cpu.instep_quota_target())
        cpu_walls.append((time.perf_counter() - t0) * 1e3)
        compare_responses(f"in-step B={b} trip {s}", resp, cresp)
        if set(got) != set(want):
            raise AssertionError(f"in-step B={b}: quota rows differ")
        for i in got:
            same_quota(f"in-step B={b} trip {s} row {i}", got[i], want[i])
            if resp[i].status_code == OK:
                ledger.append((f"user{int(users[i])}", clock.t,
                               got[i].granted_amount))
        clock.t += QUOTA_STEP_S
        cpu_clock.t += QUOTA_STEP_S
    cons = quota_ledger_checks(pool, ledger)
    n_ex = sum(q.status_code == RESOURCE_EXHAUSTED for q in got.values())
    log(f"[9] in-step B={b} (ServerArgs(max_batch={b}), bucket {b}; both "
        f"servers built in {build_s:.1f} s): {len(walls)} trip(s), every "
        f"CheckResponse and QuotaResult equal to the CPU server's, one "
        f"multi-block quota_alloc launch each; card walls "
        + " / ".join(f"{w:.1f}" for w in walls) + " ms, CPU "
        + " / ".join(f"{w:.1f}" for w in cpu_walls) + f" ms; {n_ex} "
        f"RESOURCE_EXHAUSTED; conservation: {cons['buckets']:,} buckets "
        f"read back their grants, most in a window {cons['max_window']}")
    for x in (srv, cpu, store, cpu_store):
        x.close()
    return {"walls_ms": walls, "conservation": cons}


def quota_mode_times(pool, rng, int_rate: float) -> dict:
    """K9 per mode at 512 and 2048 rows on the live plane: the rows a
    flush of zipf users (unique users for fast) would stage."""
    import numpy as np
    import torch
    out = {}
    tick_len = QUOTA_WINDOW_S / pool.k_ticks
    abs_tick = int(pool._clock() / tick_len)
    for b in (512, HEADLINE_B):
        for mode in ("fast", "unit", "seg", "scan"):
            users = rng.permutation(QUOTA_KEYS)[:b] if mode == "fast" \
                else zipf_users(rng, b)
            buckets = users.astype(np.int64)   # the fill's keys: any rows
            amounts = np.ones(b) if mode == "unit" else rng.integers(1, 6, b)
            base = pool._tick_base[buckets]
            staged = np.stack([
                buckets, amounts, rng.random(b) < 0.5,
                np.full(b, QUOTA_MAX), np.ones(b), abs_tick - base,
                pool._last_tick[buckets] - base, np.ones(b)]).astype(np.int32)
            qrows = list(torch.from_numpy(staged).to(pool.counts.device))
            quota_alloc_check(f"{mode} B={b}", mode, pool.counts, qrows, None)
            ms, call, how, plain, n_bytes, ops, lib, _ = quota_alloc_times(
                mode, pool.counts, qrows, None)
            bms, by = bound(n_bytes, ops, int_rate)
            log(f"  quota_alloc {mode:<5} B={b:5d} kernel {ms:9.5f} ms (per "
                f"call incl. launch {call:8.5f})   plain {plain:9.5f} ms   "
                f"bound {bms:9.7f} ms ({by})   equal: yes   [{how}]"
                + ("" if lib is None else f"   argsort {lib:9.5f} ms"))
            out[f"{mode}@{b}"] = {"ms": ms, "plain_ms": plain,
                                  "bound_ms": bms, "bound_by": by,
                                  "library_ms": lib, "bytes": n_bytes,
                                  "ops": ops}
    return out


def quota_walls(srv, rng) -> dict:
    """Walls of the two served paths on the card (zipf users): the
    in-step trip (mixed amounts) and the classic check-then-quota round
    (unit amounts), p50 / p99 over QUOTA_ITERS calls, and the in-step
    trip's device busy and idle share."""
    import numpy as np
    from istio_tpu_torch.adapters.sdk import QuotaArgs
    out = {}
    for b in E2E_BATCHES:
        users = zipf_users(rng, b)
        bags, _ = quota_bags(users, seed=5 * b)
        qrows = [(i, "rq", QuotaArgs(quota_amount=int(a)))
                 for i, a in enumerate(rng.integers(1, 6, b))]
        args = [QuotaArgs(quota_amount=1)] * b

        def instep():
            return srv.check_batch_quota_instep(bags, qrows,
                                                srv.instep_quota_target())

        pulls = dtoh_copies(instep)
        if pulls is not None and pulls != 1:
            raise AssertionError(f"in-step B={b}: {pulls} device-to-host "
                                 "copies in one trip")

        walls = {"instep": [], "classic": []}
        for name, fn in (("instep", instep),
                         ("classic", lambda: classic_round(srv, bags, args))):
            fn()
            for _ in range(QUOTA_ITERS):
                t = time.perf_counter()
                fn()
                walls[name].append((time.perf_counter() - t) * 1e3)
        busy = device_ms(instep, 5)
        r = {name: {"p50_ms": float(np.percentile(w, 50)),
                    "p99_ms": float(np.percentile(w, 99))}
             for name, w in walls.items()}
        r["instep"]["busy_ms"] = busy
        r["instep"]["idle_share"] = None if busy is None else \
            1 - busy / r["instep"]["p50_ms"]
        out[b] = r
        idle = "busy not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {1 - busy / r['instep']['p50_ms']:.3f}"
        log(f"[9] B={b:5d}: check_batch_quota_instep ({pulls} "
            "device-to-host copy) p50 "
            f"{r['instep']['p50_ms']:.4f} ms p99 {r['instep']['p99_ms']:.4f}"
            f" ms ({idle}); classic check_many + quota_fused p50 "
            f"{r['classic']['p50_ms']:.4f} ms p99 "
            f"{r['classic']['p99_ms']:.4f} ms")
    return out


ROUTE_RULES = 10_000          # BASELINE config 3: 10k route rules
ROUTE_BATCHES = (64, 256, 2048, 8192)
ROUTE_ITERS = 20              # timed selects per batch size
ROUTE_ORACLE_ROWS = 256       # select_host sample per batch size
ROUTE_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "route_select",
                 "atom_eval")


def route_h2d_bytes(batch, planes) -> tuple[int, int]:
    """Host-to-device bytes of one select: the dense batch's planes (what
    AttributeBatch.to moves) and the compact select's."""
    dense = nbytes(batch.ids, batch.present, batch.map_present,
                   batch.str_bytes, batch.str_lens, batch.hash_ids)
    compact = nbytes(batch.ids, batch.map_present) + int(sum(
        x.nbytes for x in planes))
    return dense, compact


def compact_select(tbl, batch):
    """The compact select of one tensorized batch → (int32 [B] on the
    device, the shipped host planes)."""
    planes = tbl._compact_planes(batch)
    if planes is None:
        raise AssertionError("compact select: the dense plane is smaller")
    flat, pres, lens = planes
    return tbl._select_on_device_compact(batch.ids, pres, batch.map_present,
                                         flat, lens), planes


def route_entry_counts() -> dict:
    from istio_tpu_torch import kernels
    return {"rule_match": kernels.launches["rule_match"],
            **kernels.launches.entries}


def route_edge_checks() -> int:
    """Phase 10b: route_winner and route_densify against their plain
    versions on inputs the route traffic does not produce (no match,
    every row matched, R = 1, ties and non-positive weights; lens 0 and
    L with cap > total, n_cols not a multiple of 8, several byte slots),
    and a host-fallback world (tests/test_pilot.py:414's backreference
    rule) selected on the card equal to the CPU table and select_host."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import route_ops
    from istio_tpu_torch.pilot.model import (Config, ConfigMeta, Port,
                                             Service)
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    rng = np.random.default_rng(10)
    n = 0
    for b, r, p, kind in ((2048, ROUTE_RULES, 0.0, "no match"),
                          (256, ROUTE_RULES, 1.0, "all matched"),
                          (300, 1, 0.5, "R = 1"), (64, 300, 0.3, "ties"),
                          (64, 300, 0.3, "non-positive")):
        m = torch.from_numpy(rng.random((b, r)) < p).cuda()
        w = rng.permutation(r).astype(np.int32) + 1
        if kind == "ties":
            w = rng.integers(1, 4, r).astype(np.int32)
        elif kind == "non-positive":
            w = rng.integers(-3, 2, r).astype(np.int32)
        w = torch.from_numpy(w).cuda()
        assert_equal(f"route_winner {kind}", route_ops.route_winner(m, w, r),
                     route_ops.route_winner_plain(m, w, r))
        n += 1
    for b, nbyte, max_len, n_cols in ((2048, 1, 256, 7), (300, 3, 256, 19),
                                      (8192, 1, 256, 7), (5, 2, 16, 3)):
        lens = rng.integers(0, 40, (b, nbyte))
        lens[::3] = 0
        lens[1::5] = max_len
        cap = max(1024, 1 << int(lens.sum()).bit_length())
        flat = torch.from_numpy(rng.integers(0, 256, cap).astype(
            np.uint8)).cuda()
        l16 = torch.from_numpy(lens.astype(np.int16)).cuda()
        pres = torch.from_numpy(rng.integers(0, 256, (b, -(-n_cols // 8)))
                                .astype(np.uint8)).cuda()
        got = route_ops.route_densify(flat, l16, pres, n_cols, max_len)
        want = route_ops.route_densify_plain(flat, l16, pres, n_cols,
                                             max_len)
        for part, g, w_ in zip(("bytes", "lens", "present"), got, want):
            assert_equal(f"route_densify B={b} nbyte={nbyte} {part}", g, w_)
        n += 1
    svc = Service(hostname="svc0.default.svc.cluster.local",
                  address="10.0.0.1", ports=(Port("http", 80, "HTTP"),))

    def rule(name, headers):
        return Config(ConfigMeta(type="route-rule", name=name,
                                 namespace="default"),
                      {"destination": {"name": "svc0"},
                       "match": {"request": {"headers": headers}},
                       "route": [{"labels": {}}]})

    rules = {svc.hostname: [rule("rr-backref", {"uri": {"regex":
                                                        r"^/(a+)\1$"}}),
                            rule("rr-plain", {"uri": {"prefix": "/api/"}})]}
    card = RouteTable([svc], rules, device="cuda")
    cpu = RouteTable([svc], rules, device="cpu")
    if not card.program.host_fallback:
        raise AssertionError("host-fallback world: no rule fell back")
    reqs = [{"destination.service": svc.hostname, "request.path": p}
            for p in ("/aaaa", "/aaa", "/api/x", "/other", "/aa")]
    got = card.select(reqs)
    if not (got == cpu.select(reqs)).all() or \
            list(got) != [card.select_host(q) for q in reqs]:
        raise AssertionError("host-fallback world: selections differ")
    torch.cuda.synchronize()
    return n + 1


def route_phase(int_rate: float) -> dict:
    """Phase 10: Pilot's route selection at BASELINE config 3 —
    make_route_world(10_000), 1,000 services and 10,000 route rules
    (URI prefix, full-match regex, cookie exact, source-constrained
    prefix) — on the card against the same RouteTable on the CPU, the
    launch counters zeroed just before the drive and read just after. At
    each B of ROUTE_BATCHES (make_route_requests): the dense select
    index-equal to the CPU table and to select_host on a sample, the
    compact select equal to the dense one, the H2D bytes of both, and
    the launches of one select of each (dense: one rule_match and one
    route_winner; compact: one more route_densify); select p50 / p99,
    device busy and idle share. Every kernel of the B=2048 trips held
    against its plain version (timed), then edge inputs (10b)."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.testing import workloads

    t0 = time.perf_counter()
    services, rules = workloads.make_route_world(ROUTE_RULES)
    tbl = RouteTable(services, rules, device="cuda")
    compile_s = time.perf_counter() - t0
    cpu = RouteTable(services, rules, device="cpu")
    if tbl.program.host_fallback:
        raise AssertionError("route world: host-fallback rules")
    log(f"[10] route world: {len(services)} services, {len(tbl.entries)} "
        f"route rules compiled on the card in {compile_s:.2f} s; geometry "
        f"{json.dumps(tbl.program.geometry)}")
    rng = np.random.default_rng(1010)
    n_atom = int(tbl.program.atoms.n > 0)     # atom_eval per select
    kernels.launches.reset()
    steps, results, captured = 0, {}, {}
    for b in ROUTE_BATCHES:
        reqs = workloads.make_route_requests(b, n_services=len(services),
                                             seed=b)
        bags = [bag_from_mapping(r) for r in reqs]
        c0 = route_entry_counts()
        with capture_if(b == HEADLINE_B) as cap:
            got = tbl.select(bags)
        torch.cuda.synchronize()
        c1 = route_entry_counts()
        steps += 1
        if {k: c1[k] - c0[k] for k in c1} != {
                "rule_match": 1, "route_winner": 1, "route_densify": 0,
                "field_eval": 0, "atom_eval": n_atom}:
            raise AssertionError(f"B={b} dense select launched "
                                 f"{ {k: c1[k] - c0[k] for k in c1} }")
        want = cpu.select(bags)
        if not (got == want).all():
            raise AssertionError(f"B={b}: card and CPU tables select "
                                 f"differently in {(got != want).sum()} rows")
        sample = rng.choice(b, min(b, ROUTE_ORACLE_ROWS), replace=False)
        for i in sample:
            if tbl.select_host(reqs[i]) != got[i]:
                raise AssertionError(f"B={b} row {i}: select_host differs")
        batch = tbl.tensorizer.tensorize(bags)
        with capture_if(b == HEADLINE_B) as cap_c:
            comp, planes = compact_select(tbl, batch)
            comp = comp.cpu().numpy()
        c2 = route_entry_counts()
        steps += 1
        if {k: c2[k] - c1[k] for k in c2} != {
                "rule_match": 1, "route_winner": 1, "route_densify": 1,
                "field_eval": 0, "atom_eval": n_atom}:
            raise AssertionError(f"B={b} compact select launched "
                                 f"{ {k: c2[k] - c1[k] for k in c2} }")
        if not (comp == got).all():
            raise AssertionError(f"B={b}: compact and dense selects differ")
        dense_b, compact_b = route_h2d_bytes(batch, planes)
        if b == HEADLINE_B:
            captured = {"dense": cap, "compact": cap_c}
        walls = []
        for _ in range(ROUTE_ITERS):
            t = time.perf_counter()
            tbl.select(bags)
            walls.append((time.perf_counter() - t) * 1e3)
        steps += ROUTE_ITERS
        staged = batch.to("cuda")
        busy = device_ms(lambda: tbl._select_on_device(staged), 5)
        steps += 6
        p50 = float(np.percentile(walls, 50))
        r = {"p50_ms": p50, "p99_ms": float(np.percentile(walls, 99)),
             "busy_ms": busy, "idle_share": None if busy is None else
             1 - busy / p50, "selects_per_s": b / p50 * 1e3,
             "h2d_dense": dense_b, "h2d_compact": compact_b,
             "hit_rows": int((got != tbl.default_index).sum())}
        results[b] = r
        idle = "busy not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {r['idle_share']:.3f}"
        log(f"[10] B={b:5d}: select equal to the CPU table and to "
            f"select_host on {len(sample)} rows; compact equal to dense; "
            f"{r['hit_rows']} rows routed; select p50 {p50:.4f} ms p99 "
            f"{r['p99_ms']:.4f} ms ({r['selects_per_s']:,.0f} requests/s; "
            f"{idle}); H2D dense {dense_b:,} B, compact {compact_b:,} B; "
            "launches per select: dense rule_match 1 + atom_eval 1 + "
            "route_winner 1, compact + route_densify 1")
    out = path_counts("[10] route path", ROUTE_KERNELS, steps)
    one_atom_launch_per_step("[10] route path", out, tbl.program)
    out["entries"] = dict(kernels.launches.entries)
    log(f"[10] route_select entry points: {out['entries']}")
    log(f"[10] every kernel of the B={HEADLINE_B} dense select against its "
        "plain version (timed):")
    rows = check_kernels(captured["dense"], None, int_rate)
    log(f"[10] route_densify of the B={HEADLINE_B} compact select (timed):")
    dens = [c for c in captured["compact"] if c[0] == "route_select"
            and c[1][0] == "densify"]
    check_kernels([c for c in captured["compact"] if c not in dens], None)
    dens_row = check_kernels(dens, None, int_rate)[0]
    win_row = next(r for r in rows if r["name"] == "route_select")
    win_row["entries"] = {e: {k: r[k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library_call", "bytes", "ops")} for e, r in (
            ("route_winner", win_row), ("route_densify", dens_row))}
    log(f"[10b] {route_edge_checks()} edge cases: route_winner and "
        "route_densify equal to their plain versions; a host-fallback "
        "world equal to the CPU table and select_host")
    return {**out, "results": results, "rows": rows}


DISCOVERY_FLEET = dict(n_services=2000, n_namespaces=64, replicas=5,
                       n_routes=2500, source_ns=2, seed=17)   # bench.py:2072
DISCOVERY_CHURN_ROUNDS = 8


def discovery_poll(ds, nodes, meta) -> tuple[list, float]:
    """Every sidecar's RDS poll (its namespace's port) → (bodies, s)."""
    replicas = DISCOVERY_FLEET["replicas"]
    t0 = time.perf_counter()
    bodies = [ds.list_routes(str(8000 + meta["ns_of"][i // replicas]), "c",
                             n) for i, n in enumerate(nodes)]
    return bodies, time.perf_counter() - t0


def discovery_phase(int_rate: float) -> dict:
    """Phase 11: Pilot's discovery service at bench.py's fleet
    (make_discovery_world: 2,000 services over 64 namespaces, 5 replicas
    = 10,000 sidecars, 2,500 route rules, the first 2 namespaces
    source-constrained) — a DiscoveryService on the card against one on
    the CPU, the launch counters zeroed just before the drive and read
    just after: every sidecar's RDS byte-equal on a cold and a warm poll,
    CDS / LDS / SDS byte-equal for one node per namespace, the same
    node groups; then DISCOVERY_CHURN_ROUNDS rounds of one-namespace
    churn, every sidecar's RDS equal after each and the scope program
    carried while its digest holds. Exactly one rule_match launch per
    admit_rows call that reaches the program; one captured launch held
    against its plain version (timed)."""
    from istio_tpu_torch import kernels
    from istio_tpu_torch.pilot.discovery import DiscoveryService
    from istio_tpu_torch.runtime import monitor
    from istio_tpu_torch.testing import workloads

    t0 = time.perf_counter()
    registry, store, nodes, meta = workloads.make_discovery_world(
        **DISCOVERY_FLEET)
    c_registry, c_store, _, _ = workloads.make_discovery_world(
        **DISCOVERY_FLEET)
    ds = DiscoveryService(registry, store, device="cuda")
    cpu = DiscoveryService(c_registry, c_store, device="cpu")
    build_s = time.perf_counter() - t0
    snap = ds.snapshot
    log(f"[11] discovery fleet: {len(nodes):,} sidecars, "
        f"{snap.n_services:,} services, {snap.n_rules:,} route rules "
        f"({snap.scope.n_constrained} source-constrained) built on both in "
        f"{build_s:.2f} s")
    admits = {"calls": 0, "program": 0}
    counted = set()

    def count_admits():
        """Count the admit_rows calls of the card's current scope
        program (each snapshot's program is wrapped once)."""
        scope = ds.snapshot.scope
        if id(scope) in counted:
            return
        counted.add(id(scope))
        real = scope.admit_rows

        def admit_rows(sources):
            admits["calls"] += 1
            if scope._program is not None and sources:
                admits["program"] += 1
            return real(sources)
        scope.admit_rows = admit_rows

    count_admits()
    kernels.launches.reset()
    base = monitor.discovery_stage_baseline()
    with kernels.launches.capture() as cap:
        cold, cold_s = discovery_poll(ds, nodes, meta)
    lat = monitor.discovery_latency_snapshot(base)["stages"]
    c_cold, c_cold_s = discovery_poll(cpu, nodes, meta)
    bad = sum(a != b for a, b in zip(cold, c_cold))
    if bad:
        raise AssertionError(f"cold poll: {bad} sidecars' RDS differ")
    groups = ds._cache.stats()["by_endpoint"]
    if groups != cpu._cache.stats()["by_endpoint"]:
        raise AssertionError("node-group counts differ")
    warm, warm_s = discovery_poll(ds, nodes, meta)
    if warm != cold:
        raise AssertionError("warm poll served other bytes")
    k_of = {}
    for i, n in enumerate(nodes):
        k_of.setdefault(meta["ns_of"][i // DISCOVERY_FLEET["replicas"]], n)
    n_other = 0
    for k, n in sorted(k_of.items()):
        host = meta["hosts_by_ns"][k][0]
        for fn, args in ((ds.list_clusters, ("c", n)),
                         (ds.list_listeners, ("c", n)),
                         (ds.list_endpoints, (f"{host}|http",))):
            other = getattr(cpu, fn.__name__)(*args)
            if fn(*args) != other:
                raise AssertionError(f"{fn.__name__}{args} differs")
            n_other += 1
    log(f"[11] cold poll: {len(nodes):,} sidecars' RDS byte-equal to the "
        f"CPU service, {groups.get('rds', 0)} RDS node groups; card "
        f"{cold_s:.3f} s ({len(nodes) / cold_s:,.0f} polls/s), CPU "
        f"{c_cold_s:.3f} s; warm poll {warm_s:.3f} s "
        f"({len(nodes) / warm_s:,.0f} polls/s); CDS / LDS / SDS equal for "
        f"{len(k_of)} namespaces ({n_other} payloads)")
    reused, churn_walls = 0, []
    ks = sorted(meta["rules_by_ns"])
    for tick in range(DISCOVERY_CHURN_ROUNDS):
        k = ks[(tick * 7) % len(ks)]
        prev = ds.snapshot.scope
        workloads.churn_discovery_rule(store, meta, k, tick)
        workloads.churn_discovery_rule(c_store, meta, k, tick)
        if ds.snapshot.scope_reused != cpu.snapshot.scope_reused:
            raise AssertionError(f"churn {tick}: scope reuse differs")
        if ds.snapshot.scope_reused:
            if ds.snapshot.scope is not prev:
                raise AssertionError(f"churn {tick}: digest held but the "
                                     "scope program was not carried")
            reused += 1
        count_admits()
        bodies, s = discovery_poll(ds, nodes, meta)
        churn_walls.append(s)
        c_bodies, _ = discovery_poll(cpu, nodes, meta)
        bad = sum(a != b for a, b in zip(bodies, c_bodies))
        if bad:
            raise AssertionError(f"churn round {tick} (ns{k}): {bad} "
                                 "sidecars' RDS differ")
        if ds._last_publish["changed_scopes"] != \
                cpu._last_publish["changed_scopes"]:
            raise AssertionError(f"churn {tick}: changed scopes differ")
    out = path_counts("[11] discovery path", ("rule_match",),
                      admits["program"])
    if out["counts"]["rule_match"] != admits["program"]:
        raise AssertionError(f"rule_match: {out['counts']['rule_match']} "
                             f"launches for {admits['program']} admit_rows "
                             "calls that reach the program")
    route_eval = lat.get("route_eval", {})
    log(f"[11] {DISCOVERY_CHURN_ROUNDS} churn rounds: every sidecar's RDS "
        f"equal after each; scope program carried in {reused}; poll after "
        f"churn {min(churn_walls):.3f}-{max(churn_walls):.3f} s; "
        f"admit_rows calls {admits['calls']} ({admits['program']} reach "
        f"the program), rule_match launches {out['counts']['rule_match']} "
        f"= one per batched generation; the card's cold poll: route_eval "
        f"{route_eval}, generate {lat.get('generate', {})}")
    log("[11] rule_match of one captured admit_rows trip against its plain "
        "version (timed):")
    rows = check_kernels([c for c in cap if c[0] == "rule_match"][:1], None,
                         int_rate)
    for d in (ds, cpu):
        d.stop()
    return {**out, "rows": rows, "cold_s": cold_s, "warm_s": warm_s,
            "churn_s": churn_walls, "stages": lat,
            "sidecars": len(nodes), "groups": groups, "admits": admits,
            "scope_reused": reused}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        from istio_tpu_torch import kernels
        from istio_tpu_torch.testing import workloads
    except ImportError as exc:
        print(f"chip_smoke: the istio_tpu_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # ---- phase 1: the card
    card = smi("name,power.limit")
    int_rate, int_how = int_ops_per_s()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"int32 peak {int_rate:.4g} op/s ({int_how})")

    log(f"[t] phase 2 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 2: build
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[2] built {len(built)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc, sm_90a)")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log(f"[t] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 3: each kernel against its plain version, main-path inputs
    t0 = time.perf_counter()
    eng = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                device="cuda")
    log(f"[3] make_engine({HEADLINE_RULES}) host compile "
        f"{time.perf_counter() - t0:.2f} s; geometry "
        f"{json.dumps(eng.ruleset.geometry)}")
    table = None
    for traffic, (bags, req) in (
            ("headline", headline_batch(eng, HEADLINE_B)),
            ("hit", hit_batch(eng, HEADLINE_RULES, HEADLINE_B, seed=100))):
        batch = eng.tensorizer.tensorize(bags).to("cuda")
        eng.check(batch, req)                 # warm quota state
        quota_before = eng.quota_counts.clone()
        with kernels.launches.capture() as captured:
            eng.check(batch, req)
        torch.cuda.synchronize()
        names = sorted({n for n, _ in captured})
        if names != sorted(ENGINE_KERNELS):
            raise AssertionError(f"engine step launched {names}, want all "
                                 f"of {sorted(ENGINE_KERNELS)}")
        log(f"[3] {traffic} traffic, B={HEADLINE_B}: "
            f"{len(captured)} captured launches"
            + (", timed:" if table is None else ", parity only"))
        rows = check_kernels(captured, quota_before,
                             int_rate if table is None else None)
        table = table or rows
        eng.quota_counts.copy_(quota_before)
    log(f"[3b] {edge_checks()} edge cases: every kernel equal to its "
        "plain version")

    log(f"[t] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 4: end to end, counters zeroed just before
    kernels.launches.reset()
    cpu_eng = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                    device="cpu")
    steps = 0
    e2e = {}
    for b in E2E_BATCHES:
        for s in range(N_STEPS):
            bags, req = hit_batch(eng, HEADLINE_RULES, b, seed=1000 + 10 * b
                                  + s)
            vg = compare_step(eng, cpu_eng, bags, req,
                              f"e2e hit B={b} step {s}")
            steps += 1
        n_or = oracle_sample(eng, bags, vg, HEADLINE_RULES)
        bags, req = headline_batch(eng, b)
        for s in range(N_STEPS):           # bench.py repeats one batch
            vg = compare_step(eng, cpu_eng, bags, req,
                              f"e2e headline B={b} step {s}")
            steps += 1
        n_or += oracle_sample(eng, bags, vg, HEADLINE_RULES)
        staged = eng.tensorizer.tensorize(bags).to("cuda")
        req_d = torch.as_tensor(req).to("cuda")
        t0 = time.perf_counter()
        eng.tensorizer.tensorize(bags)
        host_ms = (time.perf_counter() - t0) * 1e3
        iters = 30
        ms = time_ms(lambda: eng.check(staged, req_d), iters)
        busy = device_ms(lambda: eng.check(staged, req_d), 10)
        steps += iters + 3 + 11
        e2e[b] = ms
        idle = "not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {1 - busy / ms:.3f}"
        st = torch.bincount(vg.status.cpu(), minlength=14).tolist()
        log(f"[4] B={b:5d}: {N_STEPS} hit and {N_STEPS} headline steps "
            f"equal to the plain path; {n_or} oracle cells agree; headline "
            f"traffic: device step {ms:.4f} ms = {b / ms * 1e3:,.0f} "
            f"checks/s ({idle}); host tensorize {host_ms:.1f} ms; "
            f"statuses {dict((i, n) for i, n in enumerate(st) if n)}")
    small = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                  device="cuda", quota_max=2)
    small_cpu = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                      device="cpu", quota_max=2)
    exhausted = 0
    for s in range(N_STEPS):
        bags, req = hit_batch(small, HEADLINE_RULES, 256, seed=5000 + s)
        vg = compare_step(small, small_cpu, bags, req, f"small quota {s}")
        exhausted += int((vg.status == RESOURCE_EXHAUSTED).sum())
        steps += 1
    if exhausted == 0:
        raise AssertionError("small-quota engine never hit "
                             "RESOURCE_EXHAUSTED")
    log(f"[4] small quotas (max 2): {exhausted} RESOURCE_EXHAUSTED over "
        f"{N_STEPS} batches, equal to the plain path")
    counts = dict(kernels.launches)
    grids = dict(kernels.launches.grids)
    missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the engine "
                             f"path: {missing}")
    log(f"[4] wrapper calls on the engine path ({steps} steps): {counts}; "
        f"__global__ launches: {grids}")

    log(f"[t] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 5: the served Check() path, counters zeroed just before
    sv = served_phase()
    swap_phase(*sv["servers"])
    log(f"[5b] served path, B={HEADLINE_B}: every kernel against its "
        "plain version on the served path's own inputs (timed):")
    table = check_kernels(sv["captured"], sv["quota0"], int_rate)
    log(f"[5b] {served_edge_checks()} edge cases: check_pack and "
        "rule_stats equal to their plain versions; a served host-overlay "
        "world on padded batches equal to the CPU server")

    log(f"[t] phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 6: the authz world, counters zeroed just before
    az = authz_phase(int_rate)
    az["atom_worlds"] = atom_edge_checks(int_rate)
    log(f"[6b] {len(az['atom_worlds'])} atom worlds: atom_eval equal to "
        "atom_eval_plain and to the op-table interpreter")
    log(f"[t] phase 7 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 7: the list world, counters zeroed just before
    ls = list_phase(int_rate)
    log(f"[7b] {list_banks_edge_checks()} edge cases at B={HEADLINE_B}: "
        "list_banks equal to its plain version")
    log(f"[t] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 8: the report path, counters zeroed just before
    rp = report_phase(int_rate)
    log(f"[8b] {field_edge_checks()} edge cases: field_eval equal to "
        "field_eval_plain and to the op-table interpreter")
    log(f"[t] phase 9 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 9: the quota path, counters zeroed just before
    qt = quota_phase(int_rate)
    log(f"[t] phase 10 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 10: route selection, counters zeroed just before
    rt = route_phase(int_rate)
    log(f"[t] phase 11 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 11: the discovery service, counters zeroed just before
    dc = discovery_phase(int_rate)

    log(f"[t] phase 12 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 12: result lines. K1-K6 keep the headline served path's
    # row; list_banks reports the list path's, field_eval the report
    # path's, quota_alloc the quota path's (its in-step trip, with every
    # mode's row under "modes") and route_select the route path's (its
    # winner, with both entry points under "entries"). Each row carries
    # its kernel's rows on the other paths under "paths".
    paths = {"served": sv, "authz": az, "lists": ls, "report": rp,
             "quota": qt, "routes": rt, "discovery": dc}
    by_name = {r["name"]: r for r in table}
    for name, path, res in (("list_banks", "lists", ls),
                            ("atom_eval", "authz", az),
                            ("field_eval", "report", rp),
                            ("quota_alloc", "quota", qt),
                            ("route_select", "routes", rt)):
        by_name[name] = next(r for r in res["rows"] if r["name"] == name)
        by_name[name]["path"] = path
    table = [by_name[k] for k in kernels.KERNELS]
    by_name["atom_eval"]["worlds"] = az["atom_worlds"]
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "calls_per_step", "bytes", "ops")
    for row in table:
        name = row["name"]
        home = paths[row.setdefault("path", "served")]
        row["launches"] = home["counts"][name]
        row["grid_launches"] = home["grids"][name]
        row["calls_per_served_step"] = home["per_step"][name]
        row["engine_path_launches"] = counts[name]
        row["launches_by_path"] = {"engine": counts[name], **{
            p: r["counts"][name] for p, r in paths.items()}}
        row["paths"] = {p: {k: x[k] for k in keep}
                        for p in ("authz", "lists", "report", "quota",
                                  "routes", "discovery")
                        for x in paths[p]["rows"] if x["name"] == name
                        and p != row["path"]}
    log("kernels (launches by path): " + "; ".join(
        f"{p}: " + ", ".join(f"{k}={r['counts'][k]}" for k in kernels.KERNELS)
        for p, r in paths.items()))
    log("authz (check_many, make_rbac_store(1000), "
        f"{az['pseudo_rows']} pseudo-rule rows): " + ", ".join(
            f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
            f"{r['checks_per_s']:.0f} checks/s denied "
            f"{az['denied'][b]:.4f}" for b, r in az["results"].items()))
    log("report (report(), telemetry world): " + ", ".join(
        f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
        f"{r['records_per_s']:.0f} records/s {r['trips_per_call']:.2f} "
        "trips/call" for b, r in rp["results"].items()))
    log("quota (quota world, 100,000 live keys): " + ", ".join(
        f"B={b} in-step p50 {r['instep']['p50_ms']:.4f} ms p99 "
        f"{r['instep']['p99_ms']:.4f} ms, classic p50 "
        f"{r['classic']['p50_ms']:.4f} ms p99 {r['classic']['p99_ms']:.4f} "
        "ms" for b, r in qt["results"].items())
        + f"; {qt['flushes']} flushes and {qt['trips']} in-step trips, one "
        "quota_alloc launch each")
    log("quota (K9 above 8,192 rows): " + ", ".join(
        f"{m} {r['ms']:.4f} ms ({r['grids']} grids)"
        for m, r in qt["rows"][0]["modes"].items() if "grids" in r)
        + f"; in-step B={QUOTA_INSTEP_BIG} walls "
        + " / ".join(f"{w:.1f}" for w in qt["instep_16384"]["walls_ms"])
        + " ms")
    log("routes (RouteTable.select, make_route_world(10_000)): " + ", ".join(
        f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
        f"{r['selects_per_s']:.0f} requests/s idle share "
        f"{r['idle_share'] if r['idle_share'] is None else round(r['idle_share'], 4)}"
        f" H2D {r['h2d_dense']} / {r['h2d_compact']} B"
        for b, r in rt["results"].items()))
    log(f"discovery ({dc['sidecars']:,} sidecars): cold poll "
        f"{dc['cold_s']:.3f} s = {dc['sidecars'] / dc['cold_s']:.0f} "
        f"polls/s, warm {dc['warm_s']:.3f} s = "
        f"{dc['sidecars'] / dc['warm_s']:.0f} polls/s; route_eval "
        f"{dc['stages'].get('route_eval')}; rule_match "
        f"{dc['counts']['rule_match']} launches for "
        f"{dc['admits']['program']} batched generations")
    log("e2e (engine step): " + ", ".join(
        f"B={b} {ms:.4f} ms {b / ms * 1e3:.0f} checks/s"
        for b, ms in e2e.items()))
    log("served (check_many): " + ", ".join(
        f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
        f"{r['checks_per_s']:.0f} checks/s" for b, r in
        sv["results"].items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
