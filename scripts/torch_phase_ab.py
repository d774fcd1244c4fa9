#!/usr/bin/env python3
"""Time the H100 port's kernels in two or more checkouts on one card.

    python3 scripts/torch_phase_ab.py [--out FILE] [--phases P,...]
                                      DIR [DIR ...]

Each DIR is the root of a checkout (the same one may be named twice, as
in `parent change change parent`). For each, in the order given and in
a process of its own started from that directory, the checkout's
`chip_smoke.py` is imported, its kernels are built, and the chosen
phases run (default: all six):

  engine  the headline engine step at B=2048, every kernel held against
          its plain version (phase 3's headline traffic);
  seq     the sequence-parallel DFA phase (`seq_phase`);
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
          served check_many wall p50 at B = 64, 256 and 2,048.

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
import json, re, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from istio_tpu_torch import kernels
from istio_tpu_torch.testing import workloads

phases = sys.argv[1].split(",")
for src, info in kernels.build().items():
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or (
                src == "rule_match" and "Compiling entry" in line):
            print(f"BUILD {src}: {line.strip()}")
rate, _ = cs.int_ops_per_s()
rows = []
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
if "k1" in phases:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.compiler import ruleset
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

    # every checkout's rule_match returns these planes (in a checkout
    # whose rule_match takes `planes`, None in place of one not asked for)
    K1_PLANES = ("matched", "not_matched", "err")

    def k1_launch(drive):
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        (inputs,) = [x for n, x in cap if n == "rule_match"]
        return inputs

    def k1_row(world, inputs):
        ids, present, em, en, params, c, *planes = inputs
        args = (ids, present, em, en, params, c, *planes)
        call = lambda: ruleset.rule_match(*args)
        want = ruleset.rule_match_plain(ids, present, em, en, params, c)
        for g, w in zip(call(), want):
            if g is not None:
                cs.assert_equal(f"k1 {world}", g, w)
        n0 = kernels.launches["rule_match"]
        g0 = kernels.launches.grids["rule_match"]
        call()
        grids = (kernels.launches.grids["rule_match"] - g0) / \
            (kernels.launches["rule_match"] - n0)
        call_ms = cs.time_ms(call, 100)
        windows = [w for w in (cs.device_ms(call, 20) for _ in range(7))
                   if w is not None]
        ms = sorted(windows)[len(windows) // 2] if windows else call_ms
        plain = cs.time_ms(lambda: ruleset.rule_match_plain(
            ids, present, em, en, params, c), 5)
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
        row = {"phase": "k1", "name": f"rule_match.{world}", "ms": ms,
               "call_ms": call_ms, "plain_ms": plain, "windows": windows,
               "ms_source": f"median of {len(windows)} profiler windows"
               if windows else "cuda_events", "grids": grids,
               "planes": list(planes[0]) if planes else list(K1_PLANES),
               "grid_ms": grid_ms,
               "bound_ms": None, "bound_by": None, "library_ms": None}
        if hasattr(cs, "k1_work"):
            work = cs.k1_work(*inputs[:6], row["planes"])
            row["bound_ms"], row["bound_by"] = cs.bound(*work, rate)
            row["library_ms"], _ = cs.k1_library_ms(*inputs[:6])
        return row

    def walls_ms(fn, n=20):
        fn()
        fn()
        out = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)[n // 2]

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
keep = ("phase", "name", "ms", "call_ms", "plain_ms", "bound_ms",
        "bound_by", "ms_source", "library_ms", "grids", "hot_rows",
        "plane_gb_s", "stages", "windows", "planes", "walls_p50_ms",
        "grid_ms")
print("ROWS " + json.dumps([{k: r.get(k) for k in keep} for r in rows]))
"""

PHASES = ("engine", "seq", "mesh", "k6", "k9", "k1")


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


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
            p = subprocess.run([sys.executable, "-c", _CHILD, args.phases],
                               cwd=d, capture_output=True, text=True)
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
                                              "plane_gb_s")
                    if r.get(k) is not None)
                bnd = "not computed" if r["bound_ms"] is None else \
                    f"{r['bound_ms']:.6f} ({r['bound_by']})"
                print(f"run {i} {d}: {r['phase']:10s} {r['name']:22s} "
                      f"{r['ms']:.5f} ms [{r['ms_source']}]  call "
                      f"{r['call_ms']:.5f}  plain {r['plain_ms']:.5f}  "
                      f"bound {bnd}{extra}", flush=True)
                for k in ("windows", "planes", "walls_p50_ms", "grid_ms"):
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
