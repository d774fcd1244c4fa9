#!/usr/bin/env python3
"""Time launch-plan variants of the field_eval and atom_eval kernels on
one card, on the launches the served paths give them.

    python3 scripts/torch_fe_variants.py [--out FILE] [--variants V,...]

From the root of a checkout on the machine with the card. It captures
the launches of field_eval on the telemetry world's report trip
(chip_smoke.telemetry_server, 60 fields) and of atom_eval on the authz
world (make_rbac_store(1000), 306 atoms), each at B = 64, 256 and 2,048,
the route select (make_route_world(10_000), 13 atoms, B = 2,048) and the
6b corpus atom world (B = 2,048); then, for every variant, holds each
launch against its plain version and times it: the median of 7 profiler
windows of 20 calls. The variants run in the order given and then in
reverse, so each is timed twice, apart in time.

A plan variant is a set of field_ops.launch_plan keywords, launched by
the served build: for its runs the script puts a launch_plan that
passes them in field_ops' namespace, where the wrappers look it up (the
port itself always launches the default plan).

  base       the served plan: up to 8 warps a block, atom groups of 32
             halved down to 8 until a launch has 256 blocks
  min1, min4 atom groups halved down to 1 or 4
  warps4     at most 4 warps a block
  group16    atom groups of at most 16
  nofill     atom groups of 32 whatever the launch's block count
  fill512    atom groups halved until a launch has 512 blocks

A source variant runs the served plan on a copy of
istio_tpu_torch/csrc/field_eval.cu with text edits, built with nvcc into
build/fe_variants/<name>/ and put in place of the served library's
entry points for its runs:

  sync       a block barrier after each group's program starts are read
  anyregs    atom_eval's kernels not asked for 5 blocks an SM
             (__launch_bounds__(256), not (256, kAtomBlocks))

The tile is always 32 records, one per lane. Prints the card line, each
build's ptxas lines (each instantiation's registers, stack frame and
spills), one line per variant run, and writes the rows as JSON lines to
FILE (default chiprun_out/fe_variants.jsonl).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import os
import subprocess
import sys

# name → field_ops.launch_plan keywords
PLAN_VARIANTS = {
    "base": {},
    "min1": dict(min_group=1),
    "min4": dict(min_group=4),
    "warps4": dict(warps=4),
    "group16": dict(atom_group=16),
    "nofill": dict(fill_blocks=0),
    "fill512": dict(fill_blocks=512),
}
_SYNC = [(f"    const Group g = group(G, {p}0, n{p[0]});\n",
          f"    const Group g = group(G, {p}0, n{p[0]});\n"
          f"    __syncthreads();\n") for p in ("f", "a")]
# name → text edits [(old, new)] of csrc/field_eval.cu
SOURCE_VARIANTS = {
    "sync": _SYNC,
    "anyregs": [("__launch_bounds__(kMaxThreads, kAtomBlocks)\n",
                 "__launch_bounds__(kMaxThreads)\n")],
}
VARIANTS = list(PLAN_VARIANTS) + list(SOURCE_VARIANTS)


def build_variant(name: str, kernels) -> tuple:
    """Source variant `name`'s library → (CDLL, ptxas lines)."""
    with open(os.path.join("istio_tpu_torch", "csrc", "field_eval.cu")) as fh:
        text = fh.read()
    for old, new in SOURCE_VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} not once in the source")
        text = text.replace(old, new)
    out_dir = os.path.join("build", "fe_variants", name)
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, f) for f in ("field_eval.cu",
                                                   "libfield_eval.so"))
    with open(src, "w") as fh:
        fh.write(text)
    r = subprocess.run(
        [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", lib, src],
        capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{r.stdout}\n"
                         f"{r.stderr}")
    return ctypes.CDLL(os.path.abspath(lib)), ptxas_lines(r.stdout + r.stderr)


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines() if any(
        k in line for k in ("Compiling entry", "registers", "spill"))]


@contextlib.contextmanager
def swapped(kernels, fo, lib):
    """The wrappers launch `lib`'s entry points in the block (None: the
    served library's)."""
    if lib is None:
        yield
        return
    for sym, args in (("field_eval", fo._FIELD_EVAL_ARGS),
                      ("atom_eval", fo._ATOM_EVAL_ARGS)):
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = list(args), ctypes.c_int
        kernels._funcs[(sym, sym, False)] = fn
    try:
        yield
    finally:
        for sym in ("field_eval", "atom_eval"):
            kernels._funcs.pop((sym, sym, False), None)


@contextlib.contextmanager
def planned(fo, kw: dict):
    """field_ops' wrappers launch launch_plan(..., **kw) in the block."""
    served = fo.launch_plan
    fo.launch_plan = functools.partial(served, **kw)
    try:
        yield
    finally:
        fo.launch_plan = served


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/fe_variants.jsonl")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated subset of " + ",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    if not set(names) <= set(VARIANTS):
        ap.error(f"--variants: choose from {','.join(VARIANTS)}")
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("torch_fe_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.ops import field_ops as fo
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import corpus, workloads

    card = cs.smi("name,power.limit")
    print(card, flush=True)
    served = kernels.build(["field_eval"])["field_eval"]["log"]
    for line in ptxas_lines(served):
        print(f"BUILD {line}", flush=True)
    libs = {}
    for name in names:
        if name in SOURCE_VARIANTS:
            libs[name], lines = build_variant(name, kernels)
            for line in lines:
                print(f"BUILD {name} {line}", flush=True)

    def launch(drive, kernel):
        drive()
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        (ins,) = [x for n, x in cap if n == kernel]
        return ins

    def median_ms(fn):
        ws = [w for w in (cs.device_ms(fn, 20) for _ in range(7))
              if w is not None]
        return sorted(ws)[len(ws) // 2] if ws else None

    sizes = (64, 256, cs.HEADLINE_B)
    tsrv, tstore, _ = cs.telemetry_server("cuda", dict(
        buckets=sizes, max_batch=cs.HEADLINE_B, pipeline=1,
        rulestats_drain_s=0))
    t_bags = [bag_from_mapping(x) for x in
              cs.telemetry_dicts(cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    fields = {b: launch(lambda: tsrv.controller.dispatcher.report(
        t_bags[:b]), "field_eval")[:2] for b in sizes}
    az_store = workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES)
    az = RuntimeServer(az_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST, buckets=sizes,
        rulestats_drain_s=0), device="cuda")
    az_bags = [bag_from_mapping(x) for x in workloads.make_rbac_request_dicts(
        cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    atoms = {f"authz{b}": launch(lambda: az.check_many(az_bags[:b]),
                                 "atom_eval") for b in sizes}
    services, rules = workloads.make_route_world(cs.ROUTE_RULES)
    tbl = RouteTable(services, rules, device="cuda")
    rt_bags = [bag_from_mapping(r) for r in workloads.make_route_requests(
        cs.HEADLINE_B, n_services=len(services), seed=cs.HEADLINE_B)]
    atoms["routes"] = launch(lambda: tbl.select(rt_bags), "atom_eval")
    inputs = [c.input for c in corpus.CORPUS if c.compile_err is None]
    prog, batch = cs.atom_world(
        [c.e for c in corpus.CORPUS], corpus.CORPUS_MANIFEST,
        (inputs * (cs.HEADLINE_B // len(inputs) + 1))[:cs.HEADLINE_B], 128)
    atoms["corpus"] = (batch.to("cuda"), prog,
                       *cs.seeded_planes(cs.HEADLINE_B, prog.n, 1))

    def timed_variant(name: str) -> dict:
        out = {}
        with planned(fo, PLAN_VARIANTS.get(name, {})), \
                swapped(kernels, fo, libs.get(name)):
            for b, (batch, prog) in fields.items():
                cs.assert_equal(f"{name} field_eval {b}",
                                fo.field_eval(batch, prog),
                                fo.field_eval_plain(batch, prog))
                out[f"field_eval.report{b}"] = median_ms(
                    lambda: fo.field_eval(batch, prog))
            for world, (ab, ap, em, _) in atoms.items():
                cs.atom_eval_checked(f"{name} atom_eval {world}", ab, ap,
                                     int(em.shape[1]))
                scratch = cs.seeded_planes(int(ab.ids.shape[0]),
                                           int(em.shape[1]), 2)
                out[f"atom_eval.{world}"] = median_ms(
                    lambda: fo.atom_eval(ab, ap, *scratch))
        return out

    order = names + names[::-1]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as fh:
        for i, name in enumerate(order):
            row = timed_variant(name)
            print(f"run {i} {name:9s} " + "  ".join(
                f"{k} {v:.5f}" if v is not None else f"{k} none"
                for k, v in row.items()), flush=True)
            fh.write(json.dumps({"run": i, "variant": name, "card": card,
                                 "plan": PLAN_VARIANTS.get(name, {}),
                                 "edits": len(SOURCE_VARIANTS.get(name, ())),
                                 "ms": row}) + "\n")
    for x in (tsrv, tstore, az, az_store):
        x.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
