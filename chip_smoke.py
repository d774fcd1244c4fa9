#!/usr/bin/env python3
"""Drive the port's fused Check() policy step on one NVIDIA H100.

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
  5. print the kernels JSON line, the card line, and last the device
     line {"ok": true, "device": {...}}.
Exits non-zero, with no result line, when CUDA is absent or the package
is not beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

HEADLINE_RULES = 10_000
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


def fold_work(matched, req, batch, params, c, quota0, quota1, got
              ) -> tuple[float, float]:
    """(bytes, ops) the verdict fold must move and do on this run's
    data. A request row reads its matched / err cells only for the rules
    its namespace sees (every headline rule is namespaced), the per-rule
    tables of the rules any row sees, the batch columns the list and
    quota banks name, and one read per quota counter an active row keys
    into plus one write per counter that changed (quota1 vs quota0);
    got is the fold's output."""
    import torch
    status = got[0]
    rule_ns = params["pe_rule_ns"]
    ns_ok = (rule_ns[None, :] == c.default_ns) | \
        (rule_ns[None, :] == req[:, None])
    active = matched & ns_ok
    cells = int(ns_ok.sum())
    seen = int(ns_ok.any(0).sum())
    per_rule = [params[k] for k in ("pe_deny_mask", "pe_deny_status",
                                    "pe_deny_dur", "pe_deny_uses",
                                    "pe_err_rule_mask")
                if params.get(k) is not None]
    nb = matched.shape[0]
    b = nbytes(req, rule_ns, params["pe_ref_table"], *got) * 1.0
    b += 2 * cells + seen * sum(t.element_size() for t in per_rule)
    ops = 4.0 * cells
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
        ops += float(l_act.sum()) * params["pe_list_ids"].shape[1]
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


def check_kernels(captured: list, quota0, int_rate: float | None = None
                  ) -> list[dict]:
    """Phase 3: every captured launch, kernel vs plain (exact equality).
    With int_rate, also time both and compute each kernel's bound →
    the kernels table rows. quota0 is the quota state the captured
    verdict_fold launch started from."""
    import torch
    from istio_tpu_torch.compiler import ruleset
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.ops import bytes_ops

    rows: dict[str, dict] = {}
    for idx, (name, inputs) in enumerate(captured):
        tag = f"{name}#{idx}"
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
            matched, errp, req, batch, params, _, c = inputs
            qk, qp = quota0.clone(), quota0.clone()
            got = pe.verdict_fold(matched, errp, req, batch, params, qk, c)
            want = pe.verdict_fold_plain(matched, errp, req, batch, params,
                                         qp, c)
            for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                                   "referenced", "err_count"), got, want):
                assert_equal(f"{tag}.{part}", g, w)
            assert_equal(f"{tag}.quota_counts", qk, qp)
            if int_rate is None:
                continue
            scratch = quota0.clone()
            ms, call, how = timed(lambda: pe.verdict_fold(
                matched, errp, req, batch, params, scratch, c), 50)
            plain, _, _ = timed(lambda: pe.verdict_fold_plain(
                matched, errp, req, batch, params, scratch, c), 10)
            b, ops = fold_work(matched, req, batch, params, c, quota0, qk,
                               got)
            src, rep = ("verdict_fold.cu",
                        "istio_tpu/models/policy_engine.py:379")
            err = int(sum(int((g.float() != w.float()).sum())
                          for g, w in zip(got, want)))
        else:
            raise AssertionError(f"unknown kernel {name}")
        bms, by = bound(b, ops, int_rate)
        log(f"  {tag:<16} kernel {ms:9.5f} ms (per call incl. launch "
            f"{call:8.5f})   plain {plain:9.5f} ms   bound {bms:8.5f} ms "
            f"({by}; {b:.0f} B, {ops:.0f} ops)   equal: yes   [{how}]")
        row = rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": f"istio_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": 0, "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": by, "library_ms": None,
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
        row["calls_per_step"] += 1
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

    # ---- phase 2: build
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[2] built {len(built)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc, sm_90a)")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

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
        if names != sorted(kernels.KERNELS):
            raise AssertionError(f"main path launched {names}, want all "
                                 f"of {sorted(kernels.KERNELS)}")
        log(f"[3] {traffic} traffic, B={HEADLINE_B}: "
            f"{len(captured)} captured launches"
            + (", timed:" if table is None else ", parity only"))
        rows = check_kernels(captured, quota_before,
                             int_rate if table is None else None)
        table = table or rows
        eng.quota_counts.copy_(quota_before)
    log(f"[3b] {edge_checks()} edge cases: every kernel equal to its "
        "plain version")

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
    missing = [k for k in kernels.KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log(f"[4] wrapper calls on the main path ({steps} steps): {counts}; "
        f"__global__ launches: {grids}")

    # ---- phase 5: result lines
    for row in table:
        row["launches"] = counts[row["name"]]
        row["grid_launches"] = grids[row["name"]]
    log("kernels: " + ", ".join(f"{k}={counts[k]}" for k in kernels.KERNELS))
    log("e2e: " + ", ".join(f"B={b} {ms:.4f} ms {b / ms * 1e3:.0f} checks/s"
                             for b, ms in e2e.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
