#!/usr/bin/env python3
"""Time the H100 port's kernels in two or more checkouts on one card.

    python3 scripts/torch_phase_ab.py [--out FILE] DIR [DIR ...]

Each DIR is the root of a checkout (the same one may be named twice, as
in `parent change change parent`). For each, in the order given and in
a process of its own started from that directory, the checkout's
`chip_smoke.py` is imported, its kernels are built, and three of its
phases run: the headline engine step at B=2048 with every kernel held
against its plain version (phase 3's headline traffic), the
sequence-parallel DFA phase (`seq_phase`) and the mesh serving phase
(`mesh_phase`). Each phase fails as it does in chip_smoke. Per run, the
device time, plain time and bound of every kernel row (and the
registers ptxas gave each `__global__` function) is printed, and the
rows are written as JSON lines to FILE (default
chiprun_out/phase_ab.jsonl), beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from istio_tpu_torch import kernels
from istio_tpu_torch.testing import workloads

for src, info in kernels.build().items():
    for line in info["log"].splitlines():
        if "registers" in line:
            print(f"BUILD {src}: {line.strip()}")
rate, _ = cs.int_ops_per_s()
rows = []
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
    for r in phase(rate)["rows"]:
        rows.append({"phase": phase.__name__, **r})
        subs = {**r.get("entries", {}),
                **({"authz": r["authz"]} if "authz" in r else {})}
        for k, sub in subs.items():
            rows.append({"phase": phase.__name__,
                         **sub, "name": f"{r['name']}.{k}"})
keep = ("phase", "name", "ms", "call_ms", "plain_ms", "bound_ms",
        "bound_by", "ms_source")
print("ROWS " + json.dumps([{k: r.get(k) for k in keep} for r in rows]))
"""


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
    args = ap.parse_args()
    card = smi()
    print(card, flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rc = 0
    with open(args.out, "a") as out:
        for i, d in enumerate(args.dirs):
            p = subprocess.run([sys.executable, "-c", _CHILD], cwd=d,
                               capture_output=True, text=True)
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
                print(f"run {i} {d}: {r['phase']:10s} {r['name']:18s} "
                      f"{r['ms']:.5f} ms [{r['ms_source']}]  plain "
                      f"{r['plain_ms']:.5f}  bound {r['bound_ms']:.5f} "
                      f"({r['bound_by']})", flush=True)
            out.write(json.dumps({"run": i, "dir": d, "card": card,
                                  "rows": rows[0]}) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
