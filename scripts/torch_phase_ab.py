#!/usr/bin/env python3
"""Time the H100 port's kernels in two or more checkouts on one card.

    python3 scripts/torch_phase_ab.py [--out FILE] [--phases P,...]
                                      DIR [DIR ...]

Each DIR is the root of a checkout (the same one may be named twice, as
in `parent change change parent`). For each, in the order given and in
a process of its own started from that directory, the checkout's
`chip_smoke.py` is imported, its kernels are built, and the chosen
phases run (default: all twelve). The timers that must read every
checkout alike (chip_smoke's graph_ms, kernel_ms, seq_times,
mesh_entry_times, seq_work, combine_work) come from the chip_smoke.py
beside this script, loaded by path:

  engine  the headline engine step at B=2048, every kernel held against
          its plain version (phase 3's headline traffic);
  seq     the sequence-parallel DFA phase (`seq_phase`), then K12 on
          one needle match (workloads.LONG_PATTERNS[0]) at each of this
          script's chip_smoke SEQ_LAYOUTS: every chunk_map and
          compose_maps launch of the match timed alone on one stream
          (chip_smoke.seq_times: a CUDA graph of 50 launches between
          CUDA events, its output held against the plain version),
          summed per entry point into device ms a match, with the bound,
          the table lookups chunk_map's function needs (the bound's
          ops; chip_smoke.chunk_map_work) beside S a byte walked, and
          the match's CUDA-event wall;
  mesh    the mesh serving phase (`mesh_phase`);
  k6      rule_stats on phase 5's served launch (make_store(10_000),
          bench.py's headline traffic, B=2048), against its plain
          version, with its library yardstick and the rate at which it
          reads the two dense planes;
  k9      quota_alloc in unit, seg and gated seg at 512, 2,048, 8,193
          and 32,768 zipf rows (phase 9c's `quota_big_rows`, one seed),
          against its plain version, with its `__global__` grids per
          call, the stable argsort of its keys, and, where the checkout
          has `k9_stage_split`, the stage stamps of its probe build;
  k1      rule_match on three captured B=2,048 launches: the served
          Check() path (make_store(10_000), headline traffic), the authz
          world (make_rbac_store(1000)) and the route select
          (make_route_world(10_000)), each against its plain version:
          the median of 7 profiler windows of 20 calls beside CUDA-event
          time per call, each `__global__` function's device time per
          call, `__global__` grids per call, the planes the
          caller asked for, and (where the checkout's chip_smoke has
          `k1_work`) the bound and the index_select yardstick; and the
          served check_many wall p50 at B = 64, 256 and 2,048;
  k1d     rule_match on the discovery service's largest admit_rows
          launch of a cold poll of bench.py's fleet (chip_smoke's
          DISCOVERY_FLEET; the RDS of every node of namespace 0, whose
          rules are source-constrained): the same columns as k1;
  fold    verdict_fold and check_pack on captured B = 2,048 launches —
          the served Check() path (make_store(10_000), headline
          traffic), the authz world (make_rbac_store(1000)), the list
          world (chip_smoke.list_world_store) and the in-step quota
          trip (chip_smoke.quota_server, zipf users) — and K13's
          mesh_fold call of one (4, 2) mesh step (make_store(10_000) on
          8 virtual devices of card 0), each against its plain version:
          the median of 7 profiler windows of 20 calls beside CUDA-event
          time per call, each `__global__` function's device time per
          call (mesh_partial's partial_kernel among them), grids per
          call, the bound (chip_smoke's fold_work / pack_work), the
          dense-plane floor (the launch's [B, R] planes read once at
          3.35 TB/s), check_pack's torch._int_mm yardstick, and the
          served check_many wall p50 at B = 64, 256 and 2,048; then one
          (2, 4) mesh_fold call of the authz world
          (make_rbac_store(1000)), and for both mesh calls each entry
          point's device ms per launch (chip_smoke.mesh_entry_times:
          profiler windows that saw every launch of mesh_partial,
          mesh_combine and mesh_quota; the combine's bound and torch.amin
          yardstick).

  fe      field_eval and atom_eval, each against its plain version:
          field_eval on the telemetry world's captured report trips at
          B = 64, 256 and 2,048 (chip_smoke.telemetry_server, 60
          fields) and on the 8b edge inputs (EDGE_FIELDS over 777
          records, F = 22 and 33); atom_eval on the captured launches of
          the authz world (306 atoms) at B = 64, 256 and 2,048 and of
          the route select (13 atoms, B = 2,048), and on the
          6b worlds (the corpus atoms at B = 2,048, EDGE_ATOMS at cap 8
          and on a byte plane narrowed to 12): the median of 7 profiler
          windows of 20 calls beside CUDA-event time, each `__global__`
          function's device time, grids per call, the bound
          (chip_smoke's field_work / atom_work), the plain version's
          time, the gather-only index_select yardstick (where the
          checkout's chip_smoke has program_library_ms), [B, programs,
          op rows, stack need], and the served report() and authz
          check_many wall p50 at B = 64, 256 and 2,048. The build lines
          name every instantiation with its registers, stack frame and
          spills.
  lits    dfa_scan and byte_pred (K2, K3) on every launch they make in
          the headline engine step, the authz world's served step
          (make_rbac_store(1000)) and the route select
          (make_route_world(10_000)), each at B = 64, 256 and 2,048, and
          the REGEX lists' acceptance plane of the list world (B =
          2,048): each held against its plain version, the median of 7
          profiler windows of 20 calls beside CUDA-event time, grids
          and [B, L, patterns] (and, where the checkout's chip_smoke has
          subject_work, the bound); and per step of each of those
          drives, the ext stage — every device op from the first K2 /
          K3 kernel to the next rule_match kernel, the torch glue
          between them included — its launches and device time, the
          device time and count of every op that is not a hand-written
          kernel, and the whole step's device time.

  quota   the verdict fold's quota rank / grant / commit: on the headline
          engine (make_engine(10_000, with_quota=True), 34 quota specs)
          under make_hit_requests traffic (aimed at quota rules) and
          bench.py's headline traffic at B = 64, 256, 2,048 and 8,192,
          on make_engine(1,000) at a limit of 3 from zero counters at B =
          2,048 and 8,192 (keys whose limit falls inside their rows: the
          kernel's row-order walk; `groups` counts them), and on one (4,
          2) mesh step with quotas (shard_engine_check, hit traffic, B =
          256 and 2,048: the mesh_quota launches of every dp replica),
          each fold held against its plain version:
          the device ms a call of every `__global__` function whose name
          holds "quota" (chip_smoke's kernel_ms: profiler windows that
          saw every launch), its launches a call, the whole call's grid
          times, the bound (chip_smoke.quota_grant_work over the
          composite keys of chip_smoke.quota_keys) and the stable
          torch.argsort of those Q·B keys;
  lists   list_banks (K7) a step — one launch of the combined entry
          point where the checkout has it, else regex_list and
          cidr_list — on the list world (chip_smoke.list_world_store,
          its acceptance plane from dfa_scan) at B = 64 and 2,048, on
          phase 7b's random world (chip_smoke.random_list_world, both
          value layouts) and on the sized list world
          (chip_smoke.sized_list_world: a 1,024-entry blocklist and a
          64-pattern path list) at B = 2,048, each held against the
          plain versions: device ms a step of every `__global__`
          function whose name holds "list" (kernel_ms), launches a step,
          the plain versions' time and the bound (chip_smoke.list_work
          per bank).

Each phase fails as it does in chip_smoke. Per run, the device time,
plain time and bound of every kernel row (and the registers ptxas gave
each `__global__` function) is printed, and the rows are written as JSON
lines to FILE (default chiprun_out/phase_ab.jsonl), beside the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import dataclasses, importlib.util, json, re, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from istio_tpu_torch import kernels
from istio_tpu_torch.testing import workloads

phases = sys.argv[1].split(",")
# the timers of the script's own chip_smoke.py, the same in every checkout
_spec = importlib.util.spec_from_file_location("ab_timers", sys.argv[2])
tm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tm)
for src, info in kernels.build().items():
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or (
                src in ("rule_match", "verdict_fold", "check_pack",
                        "field_eval") and "Compiling entry" in line):
            print(f"BUILD {src}: {line.strip()}")
rate, _ = cs.int_ops_per_s()
rows = []


def walls_ms(fn, n=20):
    fn()
    fn()
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return sorted(out)[n // 2]


# A timing row of `call`: the median of 7 profiler windows of 20 calls,
# CUDA-event ms per call, each __global__ function's device ms per call,
# and the grids per call of kernel `kernel`.
def profiled(call, kernel, **extra):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n0 = kernels.launches[kernel]
    g0 = kernels.launches.grids[kernel]
    call()
    calls = kernels.launches[kernel] - n0
    grids = (kernels.launches.grids[kernel] - g0) / calls if calls else None
    call_ms = cs.time_ms(call, 100)
    windows = [w for w in (cs.device_ms(call, 20) for _ in range(7))
               if w is not None]
    ms = sorted(windows)[len(windows) // 2] if windows else call_ms
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    grid_ms = {re.sub(r"^.*::|[<(].*$", "", e.key.split("(")[-2]
                      if "(" in e.key else e.key):
               e.self_device_time_total / 20 / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    return {"ms": ms, "call_ms": call_ms, "windows": windows,
            "ms_source": f"median of {len(windows)} profiler windows"
            if windows else "cuda_events", "grids": grids,
            "grid_ms": grid_ms, **extra}
if "engine" in phases:
    eng = workloads.make_engine(cs.HEADLINE_RULES, with_quota=True,
                                device="cuda")
    bags, req = cs.headline_batch(eng, cs.HEADLINE_B)
    batch = eng.tensorizer.tensorize(bags).to("cuda")
    eng.check(batch, req)
    before = eng.quota_counts.clone()
    with kernels.launches.capture() as cap:
        eng.check(batch, req)
    torch.cuda.synchronize()
    for r in cs.check_kernels(cap, before, rate):
        rows.append({"phase": "engine", **r})
for phase in (cs.seq_phase, cs.mesh_phase):
    if phase.__name__.split("_")[0] not in phases:
        continue
    for r in phase(rate)["rows"]:
        rows.append({"phase": phase.__name__, **r})
        subs = {**r.get("entries", {}),
                **({"authz": r["authz"]} if "authz" in r else {})}
        for k, sub in subs.items():
            rows.append({"phase": phase.__name__,
                         **sub, "name": f"{r['name']}.{k}"})
if "seq" in phases:
    import numpy as np
    from istio_tpu_torch import platform
    from istio_tpu_torch.ops.regex_dfa import compile_regex
    from istio_tpu_torch.parallel import seq_match as sm
    from istio_tpu_torch.parallel.mesh import Mesh
    pat = workloads.LONG_PATTERNS[0]
    dfa = compile_regex(pat)
    with platform.force_virtual_devices(tm.N_VIRTUAL, "cuda:0") as devs:
        mesh = Mesh(np.array(devs, dtype=object), ("sp",))
        for b, c, lc in tm.SEQ_LAYOUTS:
            data, lens = workloads.make_long_subjects(b, c, lc, seed=b)
            data = torch.from_numpy(data.reshape(b, c, lc)).cuda()
            lens = torch.from_numpy(lens).cuda()

            def match():
                return sm.sharded_dfa_match(mesh, "sp", data, lens,
                                            dfa.transitions, dfa.accept)
            match()
            with kernels.launches.capture() as cap:
                match()
            torch.cuda.synchronize()
            parts = tm.seq_times([(n, x) for n, x in cap], rate)
            wall = cs.time_ms(match, 20)
            for kind, r in parts.items():
                rows.append({"phase": "seq_k12", **r,
                             "name": f"seq_match.{kind}.{b}x{c}x{lc}",
                             "call_ms": None, "pattern": pat,
                             "match_wall_ms": wall})
if "k6" in phases:
    srv, store = cs.served(cs.HEADLINE_RULES, "cuda",
                           dict(buckets=(cs.HEADLINE_B,),
                                rulestats_drain_s=0))
    big = cs.served_traffic("headline", cs.HEADLINE_RULES, cs.HEADLINE_B,
                            seed=1)
    srv.check_many(big)
    with kernels.launches.capture() as cap:
        srv.check_many(big)
    torch.cuda.synchronize()
    stats = [c for c in cap if c[0] == "rule_stats"]
    for r in cs.check_kernels(stats, None, rate):
        planes = 2 * stats[0][1][0].numel()
        rows.append({"phase": "k6", **r, "plane_bytes": planes,
                     "plane_gb_s": planes / (r["ms"] * 1e-3) / 1e9})
    srv.close()
    store.close()
if "k9" in phases:
    import numpy as np
    from istio_tpu_torch.models import quota_alloc as qa
    rng = np.random.default_rng(9)
    for b in (512, 2048, 8193, 32768):
        for mode in ("unit", "seg", "gate"):
            plane, qrows, gate, hot = cs.quota_big_rows(rng, b, mode, "cuda")
            kmode = "seg" if mode == "gate" else mode
            cs.quota_alloc_check(f"k9 {mode} B={b}", kmode, plane, qrows,
                                 gate)
            g0 = kernels.launches.grids["quota_alloc"]
            gate_k = None if gate is None else torch.zeros(
                b, dtype=torch.int32, device="cuda")
            qa.quota_alloc(kmode, plane.clone(), *qrows, gate=gate,
                           gate_out=gate_k)
            grids = kernels.launches.grids["quota_alloc"] - g0
            ms, call, how, plain, n_bytes, ops, lib, _ = \
                cs.quota_alloc_times(kmode, plane, qrows, gate)
            bms, by = cs.bound(n_bytes, ops, rate)
            row = {"phase": "k9", "name": f"quota_alloc.{mode}@{b}",
                   "ms": ms, "call_ms": call, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by, "ms_source": how,
                   "library_ms": lib, "grids": grids, "hot_rows": hot}
            if hasattr(cs, "k9_stage_split"):
                row["stages"] = cs.k9_stage_split(kmode, plane, qrows, gate)
            rows.append(row)
# every checkout's rule_match returns these planes (in a checkout whose
# rule_match takes `planes`, None in place of one not asked for)
K1_PLANES = ("matched", "not_matched", "err")


# A captured rule_match launch held against its plain version and timed
# (profiled), with the bound and index_select yardstick where the
# checkout's chip_smoke has them.
def k1_row(world, inputs, phase="k1"):
    from istio_tpu_torch.compiler import ruleset
    ids, present, em, en, params, c, *planes = inputs
    args = (ids, present, em, en, params, c, *planes)
    call = lambda: ruleset.rule_match(*args)
    want = ruleset.rule_match_plain(ids, present, em, en, params, c)
    for g, w in zip(call(), want):
        if g is not None:
            cs.assert_equal(f"k1 {world}", g, w)
    row = profiled(call, "rule_match", phase=phase,
                   name=f"rule_match.{world}",
                   planes=list(planes[0]) if planes else list(K1_PLANES),
                   bound_ms=None, bound_by=None, library_ms=None)
    row["plain_ms"] = cs.time_ms(lambda: ruleset.rule_match_plain(
        ids, present, em, en, params, c), 5)
    if hasattr(cs, "k1_work"):
        work = cs.k1_work(*inputs[:6], row["planes"])
        row["bound_ms"], row["bound_by"] = cs.bound(*work, rate)
        row["library_ms"], _ = cs.k1_library_ms(*inputs[:6])
    return row


if "k1" in phases:
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

    def k1_launch(drive):
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        (inputs,) = [x for n, x in cap if n == "rule_match"]
        return inputs

    srv, store = cs.served(cs.HEADLINE_RULES, "cuda",
                           dict(buckets=(64, 256, cs.HEADLINE_B),
                                rulestats_drain_s=0))
    big = cs.served_traffic("headline", cs.HEADLINE_RULES, cs.HEADLINE_B,
                            seed=1)
    srv.check_many(big)
    row = k1_row("served", k1_launch(lambda: srv.check_many(big)))
    row["walls_p50_ms"] = {b: walls_ms(lambda: srv.check_many(
        cs.served_traffic("headline", cs.HEADLINE_RULES, b, seed=b)))
        for b in (64, 256, cs.HEADLINE_B)}
    rows.append(row)
    srv.close()
    store.close()
    az_store = workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES)
    az = RuntimeServer(az_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST, buckets=(cs.HEADLINE_B,),
        rulestats_drain_s=0), device="cuda")
    az_bags = [bag_from_mapping(x) for x in workloads.make_rbac_request_dicts(
        cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    az.check_many(az_bags)
    rows.append(k1_row("authz", k1_launch(lambda: az.check_many(az_bags))))
    az.close()
    az_store.close()
    services, rules = workloads.make_route_world(cs.ROUTE_RULES)
    tbl = RouteTable(services, rules, device="cuda")
    rt_bags = [bag_from_mapping(r) for r in workloads.make_route_requests(
        cs.HEADLINE_B, n_services=len(services), seed=cs.HEADLINE_B)]
    tbl.select(rt_bags)
    rows.append(k1_row("routes", k1_launch(lambda: tbl.select(rt_bags))))
if "k1d" in phases:
    from istio_tpu_torch.pilot.discovery import DiscoveryService
    registry, dstore, nodes, meta = workloads.make_discovery_world(
        **cs.DISCOVERY_FLEET)
    ds = DiscoveryService(registry, dstore, device="cuda")
    reps = cs.DISCOVERY_FLEET["replicas"]
    with kernels.launches.capture() as cap:
        for i, n in enumerate(nodes):
            if meta["ns_of"][i // reps] == 0:   # source-constrained
                ds.list_routes("8000", "c", n)
    torch.cuda.synchronize()
    k1 = [x for nm, x in cap if nm == "rule_match"]
    ins = max(k1, key=lambda x: x[0].shape[0] * x[4]["conj_m_idx"].shape[0])
    row = k1_row("discovery", ins, phase="k1d")
    row["shape"] = [int(ins[0].shape[0]),
                    int(ins[4]["conj_m_idx"].shape[0])]
    row["launches"] = len(k1)
    rows.append(row)
    ds.stop()
if "fold" in phases:
    import numpy as np
    from istio_tpu_torch import platform
    from istio_tpu_torch.adapters.sdk import QuotaArgs
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.ops.bytes_ops import unpack_bits
    from istio_tpu_torch.parallel import mesh_fold as mf
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs, fused

    def floor_ms(*planes):
        return sum(t.numel() * t.element_size() for t in planes) \
            / cs.HBM_BYTES_PER_S * 1e3

    def fold_rows(world, cap, q0):
        for name, ins in cap:
            if name == "verdict_fold":
                m, e, req, batch, params, _, c, ls, kind = ins
                qk, qp = q0.clone(), q0.clone()
                got = pe.verdict_fold(m, e, req, batch, params, qk, c, ls,
                                      kind)
                want = pe.verdict_fold_plain(m, e, req, batch, params, qp,
                                             c, ls, kind)
                for g, w in zip(got, want):
                    cs.assert_equal(f"fold {world}", g, w)
                cs.assert_equal(f"fold {world} quota", qk, qp)
                scratch = q0.clone()
                row = profiled(lambda: pe.verdict_fold(
                    m, e, req, batch, params, scratch, c, ls, kind),
                    "verdict_fold", phase="fold",
                    name=f"verdict_fold.{world}", floor_ms=floor_ms(m, e))
                row["plain_ms"] = cs.time_ms(lambda: pe.verdict_fold_plain(
                    m, e, req, batch, params, scratch, c, ls, kind), 5)
                work = cs.fold_work(m, req, batch, params, c, q0, qk, got,
                                    ls, kind)
                row["library_ms"] = cs.rbac_library_ms(m, params)[0] \
                    if c.has_rbac else None
            elif name == "check_pack":
                cs.assert_equal(f"pack {world}", fused.check_pack(*ins),
                                fused.check_pack_plain(*ins))
                t = ins[8]
                row = profiled(lambda: fused.check_pack(*ins), "check_pack",
                               phase="fold", name=f"check_pack.{world}",
                               floor_ms=floor_ms(ins[6]))
                row["plain_ms"] = cs.time_ms(
                    lambda: fused.check_pack_plain(*ins), 5)
                work = cs.pack_work(ins, fused.check_pack(*ins))
                ns_ok = (t.rule_ns[None, :] == t.default_ns) | \
                    (t.rule_ns[None, :] == ins[7][:, None])
                row["library_ms"] = cs.int_mm_ms(
                    ins[6] & ns_ok, unpack_bits(t.inst_bits, t.n_items))[0] \
                    if t.n_items else None
            else:
                continue
            row["bound_ms"], row["bound_by"] = cs.bound(*work, rate)
            rows.append(row)

    def captured(drive):
        drive()
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        return cap

    srv, store = cs.served(cs.HEADLINE_RULES, "cuda",
                           dict(buckets=(64, 256, cs.HEADLINE_B),
                                rulestats_drain_s=0))
    big = cs.served_traffic("headline", cs.HEADLINE_RULES, cs.HEADLINE_B,
                            seed=1)
    eng = srv.controller.dispatcher.fused.engine
    fold_rows("served", captured(lambda: srv.check_many(big)),
              eng.quota_counts.clone())
    served_row = next(r for r in rows if r["name"] == "verdict_fold.served")
    served_row["walls_p50_ms"] = {b: walls_ms(lambda: srv.check_many(
        cs.served_traffic("headline", cs.HEADLINE_RULES, b, seed=b)))
        for b in (64, 256, cs.HEADLINE_B)}
    srv.close()
    store.close()
    az_store = workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES)
    az = RuntimeServer(az_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST, buckets=(cs.HEADLINE_B,),
        rulestats_drain_s=0), device="cuda")
    az_bags = [bag_from_mapping(x) for x in workloads.make_rbac_request_dicts(
        cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    fold_rows("authz", captured(lambda: az.check_many(az_bags)),
              az.controller.dispatcher.fused.engine.quota_counts.clone())
    az.close()
    az_store.close()
    l_store = cs.list_world_store()
    lsrv = RuntimeServer(l_store, ServerArgs(buckets=(cs.HEADLINE_B,),
                                             rulestats_drain_s=0),
                         device="cuda")
    dicts = cs.list_world_dicts()
    l_bags = [bag_from_mapping(x) for x in
              (dicts * (cs.HEADLINE_B // len(dicts) + 1))[:cs.HEADLINE_B]]
    fold_rows("lists", captured(lambda: lsrv.check_many(l_bags)),
              lsrv.controller.dispatcher.fused.engine.quota_counts.clone())
    lsrv.close()
    l_store.close()
    qsrv, q_store, pool, clock = cs.quota_server(
        "cuda", dict(buckets=(cs.HEADLINE_B,), rulestats_drain_s=0))
    rng = np.random.default_rng(11)
    q_bags, _ = cs.quota_bags(cs.zipf_users(rng, cs.HEADLINE_B), seed=11)
    qrows = [(i, "rq", QuotaArgs(quota_amount=1))
             for i in range(cs.HEADLINE_B)]

    def instep():
        clock.t += 0.01
        qsrv.check_batch_quota_instep(q_bags, qrows,
                                      qsrv.instep_quota_target())
    fold_rows("instep", captured(instep),
              qsrv.controller.dispatcher.fused.engine.quota_counts.clone())
    qsrv.close()
    q_store.close()
    with platform.force_virtual_devices(cs.N_VIRTUAL, "cuda:0"):
        msrv = cs.mesh_server(workloads.make_store(cs.HEADLINE_RULES),
                              cs.MESH_SHAPE, (cs.HEADLINE_B,),
                              workloads.MESH_MANIFEST)
        m_bags = cs.served_traffic("headline", cs.HEADLINE_RULES,
                                   cs.HEADLINE_B, seed=cs.HEADLINE_B + 3)
        cap = captured(lambda: msrv.check_many(m_bags))
        ((_, ins),) = [x for x in cap if x[0] == "mesh_fold"]
        parts, params, before, c, lk, dev = ins
        q0 = before if before is not None else torch.zeros(
            1, 1, dtype=torch.int32, device=dev)
        cs.mesh_fold_check("mesh_fold (4, 2)", ins, None)
        scratch = q0.clone()
        row = profiled(lambda: mf.mesh_fold(parts, params, scratch, c, lk,
                                            dev), "mesh_fold", phase="fold",
                       name="mesh_fold.4x2",
                       floor_ms=floor_ms(*(getattr(p, f) for r in parts
                                           for p in r
                                           for f in ("matched", "err"))))
        row["plain_ms"] = cs.time_ms(lambda: mf.mesh_fold_plain(
            parts, params, scratch, c, lk, dev), 5)
        row["bound_ms"] = row["bound_by"] = row["library_ms"] = None
        rows.append(row)
        msrv.close()
        az = cs.mesh_server(workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES),
                            (2, 4), (cs.HEADLINE_B,), workloads.MESH_MANIFEST)
        az_bags = [bag_from_mapping(x) for x in
                   workloads.make_rbac_request_dicts(cs.HEADLINE_B,
                                                     seed=cs.HEADLINE_B)]
        cap = captured(lambda: az.check_many(az_bags))
        ((_, az_ins),) = [x for x in cap if x[0] == "mesh_fold"]
        cs.mesh_fold_check("mesh_fold (2, 4)", az_ins, None)
        parts, params, before, c, lk, dev = az_ins
        scratch = torch.zeros(1, 1, dtype=torch.int32, device=dev)
        az_row = profiled(lambda: mf.mesh_fold(parts, params, scratch, c, lk,
                                               dev), "mesh_fold",
                          phase="fold", name="mesh_fold.authz2x4")
        az_row["plain_ms"] = cs.time_ms(lambda: mf.mesh_fold_plain(
            parts, params, scratch, c, lk, dev), 5)
        az_row["bound_ms"] = az_row["bound_by"] = az_row["library_ms"] = None
        rows.append(az_row)
        az.close()
        # each entry point's device ms per launch (windows that saw every
        # launch), the combine with its bound and torch.amin yardstick
        for name, x in (("4x2", ins), ("authz2x4", az_ins)):
            for ent, e in tm.mesh_entry_times(f"mesh_fold.{name}", x,
                                              rate).items():
                rows.append({"phase": "fold", "name": f"{ent}.{name}",
                             "call_ms": None, "plain_ms": None,
                             "bound_ms": None, "bound_by": None, **e})
if "fe" in phases:
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
    from istio_tpu_torch.attribute.types import ValueType
    from istio_tpu_torch.compiler import layout as lay_mod
    from istio_tpu_torch.compiler import tensor_expr as te
    from istio_tpu_torch.compiler.op_lower import lower_programs
    from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
    from istio_tpu_torch.expr.parser import parse
    from istio_tpu_torch.ops import field_ops as fo
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import corpus

    def fe_launch(drive, kernel):
        drive()
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        (ins,) = [x for n, x in cap if n == kernel]
        return ins

    # the gather-only yardstick, where the checkout's chip_smoke has it
    def fe_library(batch, prog):
        if not hasattr(cs, "program_library_ms"):
            return None
        return cs.program_library_ms(batch, prog)[0]

    def field_row(world, batch, prog):
        got = fo.field_eval(batch, prog)
        cs.assert_equal(f"fe {world}", got, fo.field_eval_plain(batch, prog))
        row = profiled(lambda: fo.field_eval(batch, prog), "field_eval",
                       phase="fe", name=f"field_eval.{world}",
                       library_ms=fe_library(batch, prog.prog),
                       shape=[int(batch.ids.shape[0]), prog.n_fields,
                              len(prog.prog.ops), int(prog.prog.need)])
        row["plain_ms"] = cs.time_ms(lambda: fo.field_eval_plain(batch,
                                                                 prog), 5)
        row["bound_ms"], row["bound_by"] = cs.bound(
            *cs.field_work(batch, prog, got), rate)
        rows.append(row)
        return row

    def atom_row(world, batch, atoms, x):
        b = int(batch.ids.shape[0])
        got, want = ((torch.zeros((b, x), dtype=torch.bool, device="cuda"),
                      torch.zeros((b, x), dtype=torch.bool, device="cuda"))
                     for _ in range(2))
        fo.atom_eval(batch, atoms, *got)
        fo.atom_eval_plain(batch, atoms, *want)
        for g, w in zip(got, want):
            cs.assert_equal(f"fe {world}", g, w)
        row = profiled(lambda: fo.atom_eval(batch, atoms, *got), "atom_eval",
                       phase="fe", name=f"atom_eval.{world}",
                       library_ms=fe_library(batch, atoms.prog),
                       shape=[b, atoms.n, len(atoms.prog.ops),
                              int(atoms.prog.need)])
        row["plain_ms"] = cs.time_ms(lambda: fo.atom_eval_plain(
            batch, atoms, *want), 3)
        row["bound_ms"], row["bound_by"] = cs.bound(
            *cs.atom_work(batch, atoms), rate)
        rows.append(row)
        return row

    tsrv, tstore, _ = cs.telemetry_server("cuda", dict(
        buckets=(64, 256, cs.HEADLINE_B), max_batch=cs.HEADLINE_B,
        pipeline=1, rulestats_drain_s=0))
    td = tsrv.controller.dispatcher
    t_bags = [bag_from_mapping(x) for x in
              cs.telemetry_dicts(cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    for b in (64, 256):
        field_row(f"report{b}", *fe_launch(lambda: td.report(t_bags[:b]),
                                           "field_eval")[:2])
    row = field_row("report", *fe_launch(lambda: td.report(t_bags),
                                         "field_eval")[:2])
    row["walls_p50_ms"] = {b: walls_ms(lambda: tsrv.report(
        [bag_from_mapping(x) for x in cs.telemetry_dicts(b, seed=b)]))
        for b in (64, 256, cs.HEADLINE_B)}
    tsrv.close()
    tstore.close()
    finder = AttributeDescriptorFinder(GLOBAL_MANIFEST)
    asts = [parse(t) for t in cs.EDGE_FIELDS]
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
    e_batch = lay_mod.Tensorizer(layout, interner).tensorize(
        [bag_from_mapping(d) for d in cs.edge_field_dicts(777, seed=21)]
    ).to("cuda")
    for pick in (list(range(len(asts))),
                 [i % len(asts) for i in range(33)]):
        field_row(f"edge{len(pick)}", e_batch, fo.FieldProgram(
            fns=[fns[i] for i in pick],
            prog=lower_programs([asts[i] for i in pick], layout, interner,
                                finder)))
    az_store = workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES)
    az = RuntimeServer(az_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST,
        buckets=(64, 256, cs.HEADLINE_B), rulestats_drain_s=0),
        device="cuda")
    az_bags = [bag_from_mapping(x) for x in workloads.make_rbac_request_dicts(
        cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    for b in (64, 256):
        batch, atoms, em, _ = fe_launch(
            lambda: az.check_many(az_bags[:b]), "atom_eval")
        atom_row(f"authz{b}", batch, atoms, int(em.shape[1]))
    batch, atoms, em, _ = fe_launch(lambda: az.check_many(az_bags),
                                    "atom_eval")
    row = atom_row("authz", batch, atoms, int(em.shape[1]))
    row["walls_p50_ms"] = {b: walls_ms(lambda: az.check_many(
        [bag_from_mapping(x) for x in
         workloads.make_rbac_request_dicts(b, seed=b)]))
        for b in (64, 256, cs.HEADLINE_B)}
    az.close()
    az_store.close()
    services, rules = workloads.make_route_world(cs.ROUTE_RULES)
    tbl = RouteTable(services, rules, device="cuda")
    rt_bags = [bag_from_mapping(r) for r in workloads.make_route_requests(
        cs.HEADLINE_B, n_services=len(services), seed=cs.HEADLINE_B)]
    batch, atoms, em, _ = fe_launch(lambda: tbl.select(rt_bags), "atom_eval")
    atom_row("routes", batch, atoms, int(em.shape[1]))
    inputs = [c.input for c in corpus.CORPUS if c.compile_err is None]
    edge_man = {k: ValueType[v] for k, v in cs.EDGE_ATOM_MANIFEST.items()}
    edge = cs.edge_atom_dicts(777, seed=61)
    for world, texts, man, dicts, cap, width in (
            ("corpus", [c.e for c in corpus.CORPUS], corpus.CORPUS_MANIFEST,
             (inputs * (cs.HEADLINE_B // len(inputs) + 1))[:cs.HEADLINE_B],
             128, None),
            ("edge", cs.EDGE_ATOMS, edge_man, edge, 8, None),
            ("edge_narrowed", cs.EDGE_ATOMS, edge_man, [d for d in edge if all(
                len(v) <= 12 for v in d.values() if isinstance(v, str))],
             32, 12)):
        atoms, batch = cs.atom_world(texts, man, dicts, cap)
        if width is not None:
            batch = dataclasses.replace(
                batch, str_bytes=batch.str_bytes[:, :, :width].contiguous())
        atom_row(world, batch.to("cuda"), atoms, atoms.n)
if "lits" in phases:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.ops import bytes_ops
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

    # the checkout's __global__ functions → their csrc source
    gfn = {}
    for src in sorted(kernels.SRC_DIR.glob("*.cu")):
        for fn in re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                             r"\([^)]*\)\s+)?(\w+)", src.read_text()):
            gfn[fn] = src.stem

    def src_of(name):
        for fn, src in gfn.items():
            if re.search(r"(?:^|[\s:])" + fn + r"[<(]", name):
                return src
        return None

    # per step of `call` (10 steps profiled): the ext stage (every device
    # op from the first K2 / K3 kernel to the next rule_match kernel),
    # the device time of the ops that are not hand-written, and the
    # whole step's device time
    def ext_stage(call, world):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        tagged = [(e, src_of(e.name)) for e in evs]
        stages, cur = [], None
        for e, src in tagged:
            if cur is None and src in ("byte_pred", "dfa_scan"):
                cur = []
            if cur is not None:
                if src == "rule_match":
                    stages.append(cur)
                    cur = None
                else:
                    cur.append((e, src))
        n = max(len(stages), 1)
        us = sum(e.time_range.elapsed_us() for st in stages for e, _ in st)
        other = [e for e, src in tagged if src is None]
        busy = cs.device_ms(call, 10)
        rows.append({"phase": "lits", "name": f"ext.{world}",
                     "ms": us / 1e3 / n,
                     "launches": sum(len(st) for st in stages) / n,
                     "ms_source": f"{len(stages)} profiled steps",
                     "bound_ms": None,
                     "other_ms": sum(e.time_range.elapsed_us()
                                     for e in other) / 1e3 / 10,
                     "other_ops": len(other) / 10, "busy_ms": busy,
                     "ops": sorted({e.name.split("(")[0][:60]
                                    for st in stages for e, _ in st})})

    # one captured K2 / K3 call of either checkout's wrappers: this PR's
    # captures carry their entry kind first ("plane" / "lits"), earlier
    # ones are (data, lens, table) plane calls
    def k23_row(name, x, world):
        if isinstance(x[0], str):
            kind, args = x[0], x[1:]
            cs.subject_check(name, kind, args, f"lits {world}")
            planes = None
            if kind == "lits":
                planes = [torch.zeros_like(args[7]) for _ in range(2)]
            call = lambda: cs.subject_kernel(name, kind, args, planes)
            data, k = args[0], (args[2] if kind == "plane" else args[4]).n
            bnd = cs.bound(*cs.subject_work(name, kind, args), rate)
        else:
            kind, (data, lens, table) = "plane", x
            fn, plain = ((bytes_ops.dfa_scan, bytes_ops.dfa_scan_plain)
                         if name == "dfa_scan" else
                         (bytes_ops.byte_pred, bytes_ops.byte_pred_plain))
            cs.assert_equal(f"lits {world}", fn(data, lens, table),
                            plain(data, lens, *table.on(data.device)))
            call = lambda: fn(data, lens, table)
            k, bnd = table.n, (None, None)
        row = profiled(call, name, phase="lits",
                       name=f"{name}.{kind}.{world}",
                       shape=[int(data.shape[0]), int(data.shape[1]), k])
        row["bound_ms"], row["bound_by"] = bnd
        rows.append(row)

    def k23_rows(drive, world, want=("byte_pred", "dfa_scan")):
        drive()
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        for i, (n, x) in enumerate(c for c in cap if c[0] in want):
            k23_row(n, x, f"{world}#{i}")

    eng = workloads.make_engine(cs.HEADLINE_RULES, with_quota=True,
                                device="cuda")
    for b in (64, 256, cs.HEADLINE_B):
        bags, req = cs.headline_batch(eng, b)
        batch = eng.tensorizer.tensorize(bags).to("cuda")
        req_d = torch.as_tensor(req).to("cuda")
        step = lambda: eng.check(batch, req_d)
        k23_rows(step, f"headline{b}")
        ext_stage(step, f"headline{b}")
    az_store = workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES)
    az = RuntimeServer(az_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST,
        buckets=(64, 256, cs.HEADLINE_B), rulestats_drain_s=0),
        device="cuda")
    az_bags = [bag_from_mapping(x) for x in workloads.make_rbac_request_dicts(
        cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    for b in (64, 256, cs.HEADLINE_B):
        step = lambda: az.check_many(az_bags[:b])
        k23_rows(step, f"authz{b}")
        ext_stage(step, f"authz{b}")
    az.close()
    az_store.close()
    services, rules = workloads.make_route_world(cs.ROUTE_RULES)
    tbl = RouteTable(services, rules, device="cuda")
    for b in (64, 256, cs.HEADLINE_B):
        rt_bags = [bag_from_mapping(r) for r in workloads.make_route_requests(
            b, n_services=len(services), seed=b)]
        staged = tbl.tensorizer.tensorize(rt_bags).to("cuda")
        step = lambda: tbl._select_on_device(staged)
        k23_rows(step, f"routes{b}")
        ext_stage(step, f"routes{b}")
    ls_store = cs.list_world_store()
    ls = RuntimeServer(ls_store, ServerArgs(
        buckets=(64, 256, cs.HEADLINE_B), rulestats_drain_s=0),
        device="cuda")
    dicts = cs.list_world_dicts()
    ls_bags = [bag_from_mapping(x) for x in
               (dicts * (cs.HEADLINE_B // len(dicts) + 1))[:cs.HEADLINE_B]]
    k23_rows(lambda: ls.check_many(ls_bags), f"lists{cs.HEADLINE_B}",
             want=("dfa_scan",))
    ls.close()
    ls_store.close()
if "quota" in phases:
    import numpy as np
    from istio_tpu_torch import platform
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.parallel import mesh_fold as mf
    from istio_tpu_torch.parallel.mesh import MeshSpec, shard_engine_check

    # The quota grids of one call (every __global__ function whose name
    # holds "quota"; the fold's other grids are `other`): device ms a call
    # from profiler windows that saw every launch, beside the bound and
    # the stable argsort of the same composite keys.
    def quota_row(name, call, kernel, other, keys, q0, q1, over, **extra):
        g0 = kernels.launches.grids[kernel]
        call()
        torch.cuda.synchronize()
        per = kernels.launches.grids[kernel] - g0 - other
        ms, kept = tm.kernel_ms(call, "quota", per)
        whole = profiled(call, kernel, phase="quota", name=name, **extra)
        work = tm.quota_grant_work(keys, q0, q1, over)
        flat = keys.reshape(-1)
        row = {"phase": "quota", "name": name, "ms": ms * per,
               "ms_source": f"profiler, {kept} windows that saw every "
                            "launch", "launches_per_call": per,
               "per_launch_ms": ms, "grid_ms": whole["grid_ms"],
               "call_ms": whole["ms"], "grids": whole["grids"],
               "plain_ms": None, "shape": list(keys.shape),
               "library_ms": tm.time_ms(
                   lambda: torch.argsort(flat, stable=True), 50),
               "library_call": "torch.argsort(stable=True) of the Q*B "
                               "composite keys", **extra}
        row["bound_ms"], row["bound_by"] = tm.bound(*work, rate)
        row["bytes"], row["ops"] = work
        rows.append(row)

    eng = workloads.make_engine(cs.HEADLINE_RULES, with_quota=True,
                                device="cuda")
    n_b = int(eng.quota_counts.shape[1])
    for traffic in ("hit", "headline"):
        for b in (64, 256, cs.HEADLINE_B, 8192):
            bags, req = (cs.hit_batch(eng, cs.HEADLINE_RULES, b,
                                      seed=900 + b)
                         if traffic == "hit" else cs.headline_batch(eng, b))
            batch = eng.tensorizer.tensorize(bags).to("cuda")
            req = torch.as_tensor(req).to("cuda")
            eng.check(batch, req)
            with kernels.launches.capture() as cap:
                eng.check(batch, req)
            torch.cuda.synchronize()
            ((_, ins),) = [x for x in cap if x[0] == "verdict_fold"]
            m, e, rq, bt, params, _, c, ls, kind = ins
            q0 = eng.quota_counts.clone()
            qk, qp = q0.clone(), q0.clone()
            got = pe.verdict_fold(m, e, rq, bt, params, qk, c, ls, kind)
            want = pe.verdict_fold_plain(m, e, rq, bt, params, qp, c, ls,
                                         kind)
            for g, w in zip(got, want):
                cs.assert_equal(f"quota {traffic} B={b}", g, w)
            cs.assert_equal(f"quota {traffic} B={b} counters", qk, qp)
            keys = tm.quota_keys(m, rq, bt, params, c, n_b, ls, kind)
            over = int((got[0] == cs.RESOURCE_EXHAUSTED).sum())
            scratch = q0.clone()
            quota_row(f"quota.{traffic}.B{b}", lambda: pe.verdict_fold(
                m, e, rq, bt, params, scratch, c, ls, kind), "verdict_fold",
                1, keys, q0, qk, over,
                active=int((keys != pe.INT32_MAX).sum()),
                groups=int(torch.unique(keys[keys != pe.INT32_MAX]).numel()))
            # the plan's rows a block as a rule, where the checkout has it
            if traffic == "hit" and b >= cs.HEADLINE_B and \
                    hasattr(pe, "QUOTA_BLOCK_ROWS"):
                rows0 = pe.QUOTA_BLOCK_ROWS
                for blk in (512, 2048, 4096):
                    pe.QUOTA_BLOCK_ROWS = blk
                    quota_row(f"quota.{traffic}.B{b}.rows{blk}",
                              lambda: pe.verdict_fold(
                                  m, e, rq, bt, params, scratch, c, ls,
                                  kind), "verdict_fold", 1, keys, q0, qk,
                              over, plan=str(pe.quota_plan(b)))
                pe.QUOTA_BLOCK_ROWS = rows0
    # keys whose limit falls inside their rows: make_engine(1,000) at a
    # limit of 3 from zero counters (reset before every call, so each
    # call ranks the same contested groups), hit traffic
    weng = workloads.make_engine(1000, with_quota=True, device="cuda",
                                 quota_max=3)
    for b in (cs.HEADLINE_B, 8192):
        weng.reset_quota()
        bags, req = cs.hit_batch(weng, 1000, b, seed=990 + b)
        batch = weng.tensorizer.tensorize(bags).to("cuda")
        req = torch.as_tensor(req).to("cuda")
        with kernels.launches.capture() as cap:
            weng.check(batch, req)
        torch.cuda.synchronize()
        ((_, ins),) = [x for x in cap if x[0] == "verdict_fold"]
        m, e, rq, bt, params, _, c, ls, kind = ins
        q0 = torch.zeros_like(weng.quota_counts)
        qk, qp = q0.clone(), q0.clone()
        got = pe.verdict_fold(m, e, rq, bt, params, qk, c, ls, kind)
        want = pe.verdict_fold_plain(m, e, rq, bt, params, qp, c, ls, kind)
        for g, w in zip(got, want):
            cs.assert_equal(f"quota walk B={b}", g, w)
        cs.assert_equal(f"quota walk B={b} counters", qk, qp)
        keys = tm.quota_keys(m, rq, bt, params, c,
                             int(weng.quota_counts.shape[1]), ls, kind)
        live = keys[keys != pe.INT32_MAX]
        _, n_rows = torch.unique(live, return_counts=True)
        over = int((got[0] == cs.RESOURCE_EXHAUSTED).sum())
        scratch = q0.clone()

        def walk_call():
            scratch.copy_(q0)
            pe.verdict_fold(m, e, rq, bt, params, scratch, c, ls, kind)
        quota_row(f"quota.walk.B{b}", walk_call, "verdict_fold", 1, keys,
                  q0, qk, over, active=int(live.numel()),
                  groups=int((n_rows > 3).sum()))
    with platform.force_virtual_devices(tm.N_VIRTUAL, "cuda:0"):
        meng = workloads.make_engine(cs.HEADLINE_RULES, with_quota=True,
                                     device="cuda")
        step = shard_engine_check(MeshSpec(*tm.MESH_SHAPE).build(), meng)
        dp, mp = tm.MESH_SHAPE
        for b in (256, cs.HEADLINE_B):
            bags, req = cs.hit_batch(meng, cs.HEADLINE_RULES, b,
                                     seed=950 + b)
            batch = meng.tensorizer.tensorize(bags)
            step(meng.params, batch, req, meng.quota_counts)
            with kernels.launches.capture() as cap:
                step(meng.params, batch, req, meng.quota_counts)
            torch.cuda.synchronize()
            ((_, ins),) = [x for x in cap if x[0] == "mesh_fold"]
            cs.mesh_fold_check(f"mesh_fold quota B={b}", ins, None)
            parts, params, before, c, lk, dev = ins
            q0 = before.clone()
            qk = q0.clone()
            got = mf.mesh_fold(parts, params, qk, c, lk, dev)
            m = mf.gather_plane(parts, "matched", dev)
            rq = torch.cat([r[0].req_ns for r in parts])
            bt = type(parts[0][0].batch).cat([r[0].batch for r in parts],
                                              dev)
            keys = tm.quota_keys(m, rq, bt, params, c, n_b,
                                 mf.gather_lstate(parts, dev), lk)
            over = int((got[0] == cs.RESOURCE_EXHAUSTED).sum())
            scratch = q0.clone()
            quota_row(f"mesh_quota.4x2.B{b}", lambda: mf.mesh_fold(
                parts, params, scratch, c, lk, dev), "mesh_fold",
                dp * mp + dp, keys, q0, qk, over, replicas=dp)
if "lists" in phases:
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.ops import bytes_ops
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

    # one list_banks step: one combined launch where the checkout has
    # the combined entry point, else (a checkout before it) its two banks'
    # regex_list and cidr_list, one launch each
    def list_step(acc, sb, sl, max_len, rx, cidr, lstate, err):
        if hasattr(bytes_ops, "list_banks"):
            return lambda: bytes_ops.list_banks(acc, sb, sl, max_len, rx,
                                                cidr, lstate, err)
        return lambda: (bytes_ops.regex_list(acc, sl, max_len, rx, lstate,
                                             err),
                        bytes_ops.cidr_list(sb, sl, cidr, lstate))

    def list_plain(acc, sb, sl, max_len, rx, cidr, lstate, err):
        bytes_ops.regex_list_plain(acc, sl, max_len, *rx.on(acc.device),
                                   lstate, err)
        bytes_ops.cidr_list_plain(sb, sl, *cidr.on(sb.device), lstate)

    # The list_banks grids of a step (every __global__ function whose name
    # holds "list"): device ms a step from profiler windows that saw every
    # launch, the plain versions' time, the bound (list_work per bank).
    def list_row(name, acc, sb, sl, max_len, rx, cidr, n_pos, n_rules):
        b = int(acc.shape[0])
        outs = [(torch.zeros((b, n_pos), dtype=torch.uint8, device="cuda"),
                 torch.zeros((b, n_rules), dtype=torch.bool,
                             device="cuda")) for _ in range(2)]
        call = list_step(acc, sb, sl, max_len, rx, cidr, *outs[0])
        g0 = kernels.launches.grids["list_banks"]
        call()
        torch.cuda.synchronize()
        per = kernels.launches.grids["list_banks"] - g0
        list_plain(acc, sb, sl, max_len, rx, cidr, *outs[1])
        for part, g, w in zip(("lstate", "err"), *outs):
            cs.assert_equal(f"{name} {part}", g, w)
        ms, kept = tm.kernel_ms(call, "list", per)
        whole = profiled(call, "list_banks")
        work = [tm.list_work(("regex_list", acc, sl, max_len, rx, None,
                              None), *outs[0]),
                tm.list_work(("cidr_list", sb, sl, cidr, None), *outs[0])]
        moved, ops = (sum(w[i] for w in work) for i in (0, 1))
        row = {"phase": "lists", "name": name, "ms": ms * per,
               "ms_source": f"profiler, {kept} windows that saw every "
                            "launch", "launches_per_call": per,
               "per_launch_ms": ms, "grid_ms": whole["grid_ms"],
               "call_ms": whole["call_ms"], "grids": whole["grids"],
               "plain_ms": tm.time_ms(lambda: list_plain(
                   acc, sb, sl, max_len, rx, cidr, *outs[1]), 10),
               "shape": [b, rx.n, cidr.n, int(cidr.valid.sum())],
               "bytes": moved, "ops": ops}
        row["bound_ms"], row["bound_by"] = tm.bound(moved, ops, rate)
        rows.append(row)

    ls_store = cs.list_world_store()
    ls = RuntimeServer(ls_store, ServerArgs(
        buckets=(64, cs.HEADLINE_B), rulestats_drain_s=0), device="cuda")
    dicts = cs.list_world_dicts()
    leng = ls.controller.dispatcher.fused.engine
    for b in (64, cs.HEADLINE_B):
        bags = [bag_from_mapping(x) for x in
                (dicts * (b // len(dicts) + 1))[:b]]
        batch = leng.tensorizer.tensorize(bags).to("cuda")
        accs = [bytes_ops.dfa_scan(batch.str_bytes[:, bslot],
                                   batch.str_lens[:, bslot], bank)
                for bslot, bank in leng._dfa_banks]
        acc = accs[0] if len(accs) == 1 else torch.cat(accs, dim=1)
        list_row(f"list_banks.tiny.B{b}", acc.contiguous(),
                 batch.str_bytes, batch.str_lens, leng._max_len,
                 leng._rx_lists, leng._cidr_lists,
                 int(leng._list_kind.shape[0]),
                 int(leng.ruleset.rule_ns.shape[0]))
    ls.close()
    ls_store.close()
    acc, sb, (sl, ip_sl), width, rx, cidr, n_rules = tm.random_list_world()
    list_row("list_banks.random.B2048", acc, sb, sl, width, rx, cidr, 128,
             n_rules)
    list_row("list_banks.random_ip.B2048", acc, sb, ip_sl, width, rx, cidr,
             128, n_rules)
    acc, sb, sl, width, rx, cidr, n_rules = tm.sized_list_world()
    list_row("list_banks.sized.B2048", acc, sb, sl, width, rx, cidr, 2,
             n_rules)
    # the lanes plan's thread cap, where the checkout has one
    if hasattr(bytes_ops, "LIST_THREADS"):
        cap0 = bytes_ops.LIST_THREADS
        for cap in (1 << 17, 1 << 21, 1 << 30):
            bytes_ops.LIST_THREADS = cap
            acc, sb, (sl, ip_sl), width, rx, cidr, n_rules = \
                tm.random_list_world()
            list_row(f"list_banks.random.B2048.cap{cap}", acc, sb, sl,
                     width, rx, cidr, 128, n_rules)
            list_row(f"list_banks.random_ip.B2048.cap{cap}", acc, sb, ip_sl,
                     width, rx, cidr, 128, n_rules)
            acc, sb, sl, width, rx, cidr, n_rules = tm.sized_list_world()
            list_row(f"list_banks.sized.B2048.cap{cap}", acc, sb, sl, width,
                     rx, cidr, 2, n_rules)
        bytes_ops.LIST_THREADS = cap0
keep = ("phase", "name", "ms", "call_ms", "plain_ms", "bound_ms",
        "bound_by", "ms_source", "library_ms", "grids", "hot_rows",
        "plane_gb_s", "stages", "windows", "planes", "walls_p50_ms",
        "grid_ms", "floor_ms", "shape", "launches", "other_ms",
        "other_ops", "busy_ms", "ops", "bytes", "per_launch_ms", "lookups",
        "lookups_all_walks", "match_wall_ms", "launches_per_match",
        "launches_per_call", "library_call", "replicas", "active",
        "groups", "plan")
print("ROWS " + json.dumps([{k: r.get(k) for k in keep} for r in rows]))
"""

PHASES = ("engine", "seq", "mesh", "k6", "k9", "k1", "k1d", "fold",
          "fe", "lits", "quota", "lists")


def _ms(x) -> str:
    return "none" if x is None else f"{x:.5f}"


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


_TIMERS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--out", default="chiprun_out/phase_ab.jsonl")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    if not set(args.phases.split(",")) <= set(PHASES):
        ap.error(f"--phases: choose from {','.join(PHASES)}")
    card = smi()
    print(card, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rc = 0
    with open(args.out, "a") as out:
        for i, d in enumerate(args.dirs):
            p = subprocess.run([sys.executable, "-c", _CHILD, args.phases,
                                _TIMERS], cwd=d, capture_output=True,
                               text=True)
            rows = [json.loads(line[5:]) for line in p.stdout.splitlines()
                    if line.startswith("ROWS ")]
            if p.returncode != 0 or not rows:
                print(f"run {i} ({d}) failed, rc {p.returncode}:\n"
                      f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}", flush=True)
                rc = 1
                continue
            for line in p.stdout.splitlines():
                if line.startswith("BUILD "):
                    print(f"run {i} {d}: {line[6:]}", flush=True)
            for r in rows[0]:
                extra = "".join(
                    f"  {k} {r[k]:.5f}" if isinstance(r[k], float) else
                    f"  {k} {r[k]}" for k in ("library_ms", "grids",
                                              "plane_gb_s", "floor_ms")
                    if r.get(k) is not None)
                bnd = "not computed" if r["bound_ms"] is None else \
                    f"{r['bound_ms']:.6f} ({r['bound_by']})"
                print(f"run {i} {d}: {r['phase']:10s} {r['name']:22s} "
                      f"{r['ms']:.5f} ms [{r['ms_source']}]  call "
                      f"{_ms(r.get('call_ms'))}  plain "
                      f"{_ms(r.get('plain_ms'))}  bound {bnd}{extra}",
                      flush=True)
                for k in ("windows", "planes", "walls_p50_ms", "grid_ms",
                          "shape", "launches", "other_ms", "other_ops",
                          "busy_ms", "ops", "per_launch_ms", "lookups",
                          "lookups_all_walks", "match_wall_ms",
                          "launches_per_call", "replicas", "active",
                          "groups", "plan"):
                    if r.get(k) is not None:
                        print(f"run {i} {d}:   {k} {r[k]}", flush=True)
                for st in r.get("stages") or ():
                    print(f"run {i} {d}:   stage slot {st['slot']:2d}  "
                          f"{st['us']:9.3f} us  {st['cycles']:8d} cycles  "
                          f"(latest block {st['last_us']:9.3f} us)",
                          flush=True)
            out.write(json.dumps({"run": i, "dir": d, "card": card,
                                  "rows": rows[0]}) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
