#!/usr/bin/env python3
"""Time source variants of the verdict_fold and check_pack kernels on one
card, on the launches the served Check() path and the authz world give
them, each variant built from an edited copy of the sources.

    python3 scripts/torch_fold_variants.py [--out FILE]

From the root of a checkout on the machine with the card. It serves
make_store(10_000) (bench.py's headline traffic) and make_rbac_store(1000)
at B = 2,048 once each and captures the verdict_fold and check_pack
launches of one batch; then, for every variant, copies
istio_tpu_torch/csrc/{verdict_fold.cu, check_pack.cu, rule_words.cuh}
into build/fold_variants/<name>/, applies the variant's text edits and
-D flags, builds both sources with nvcc, and times the wrappers on the
captured inputs through the copy's entry points (each launch held
against its plain version first): the median of 7 profiler windows of
20 calls. The variants run in the order given and then in reverse, so
each is timed twice, apart in time:

  base        the sources as they are (4 warps a block, 4 words a lane,
              every word of a row loaded)
  warps1/2/8  1, 2 or 8 request rows (warps) a block (-DFOLD_WARPS,
              -DPACK_WARPS)
  unroll2/8   2 or 8 16-byte words a lane in flight (kUnroll)
  gated       a 16-byte word of a row loaded only where the table words
              give it a visible rule the fold or pack reads (the load
              waits on the table words)

Beside them, on the base build, the served fold with no list (its
FoldConsts with has_lists off, outputs not checked): the share of the
list pass. Prints the card line, each build's registers, one line per
variant run, and writes the rows as JSON lines to FILE (default
chiprun_out/fold_variants.jsonl).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

SOURCES = ("verdict_fold.cu", "check_pack.cu", "rule_words.cuh")
UNROLL = ("rule_words.cuh", "constexpr int kUnroll = 4;",
          "constexpr int kUnroll = {};")
# name → (text edits [(file, old, new)], nvcc -D flags)
VARIANTS = {
    "base": ([], []),
    "warps1": ([], ["-DFOLD_WARPS=1", "-DPACK_WARPS=1"]),
    "warps2": ([], ["-DFOLD_WARPS=2", "-DPACK_WARPS=2"]),
    "warps8": ([], ["-DFOLD_WARPS=8", "-DPACK_WARPS=8"]),
    "unroll2": ([(UNROLL[0], UNROLL[1], UNROLL[2].format(2))], []),
    "unroll8": ([(UNROLL[0], UNROLL[1], UNROLL[2].format(8))], []),
    "gated": ([("verdict_fold.cu",
                "mq[u] = m4[c];  // not gated on d / ce: see the header\n"
                "        eq[u] = e4[c];",
                "if (d[u]) mq[u] = m4[c];\n"
                "        if (ce[u]) eq[u] = e4[c];"),
               ("check_pack.cu",
                "mq[u] = m4[c];  // not gated on a: see the header",
                "if (a[u]) mq[u] = m4[c];")], []),
}


def build_variant(name: str, kernels) -> dict:
    """The variant's two libraries → {source: (CDLL, ptxas lines)}."""
    edits, flags = VARIANTS[name]
    src_dir = os.path.join("istio_tpu_torch", "csrc")
    out_dir = os.path.join("build", "fold_variants", name)
    os.makedirs(out_dir, exist_ok=True)
    for f in SOURCES:
        with open(os.path.join(src_dir, f)) as fh:
            text = fh.read()
        for target, old, new in edits:
            if target == f:
                if old not in text:
                    raise SystemExit(f"variant {name}: {old!r} not in {f}")
                text = text.replace(old, new)
        with open(os.path.join(out_dir, f), "w") as fh:
            fh.write(text)
    libs = {}
    for src in ("verdict_fold", "check_pack"):
        lib = os.path.join(out_dir, f"lib{src}.so")
        r = subprocess.run(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags,
             "-o", lib, os.path.join(out_dir, f"{src}.cu")],
            capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"variant {name}: nvcc {src} failed\n"
                             f"{r.stdout}\n{r.stderr}")
        regs = [line.strip() for line in (r.stdout + r.stderr).splitlines()
                if "registers" in line]
        libs[src] = (ctypes.CDLL(os.path.abspath(lib)), regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/fold_variants.jsonl")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("torch_fold_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs, fused
    from istio_tpu_torch.testing import workloads

    card = cs.smi("name,power.limit")
    print(card, flush=True)
    kernels.build(["verdict_fold", "check_pack"])

    def captured(drive):
        drive()
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        return cap

    def median_ms(fn):
        ws = [w for w in (cs.device_ms(fn, 20) for _ in range(7))
              if w is not None]
        return sorted(ws)[len(ws) // 2] if ws else None

    srv, store = cs.served(cs.HEADLINE_RULES, "cuda",
                           dict(buckets=(cs.HEADLINE_B,),
                                rulestats_drain_s=0))
    big = cs.served_traffic("headline", cs.HEADLINE_RULES, cs.HEADLINE_B,
                            seed=1)
    caps = {"served": captured(lambda: srv.check_many(big))}
    az_store = workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES)
    az = RuntimeServer(az_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST, buckets=(cs.HEADLINE_B,),
        rulestats_drain_s=0), device="cuda")
    az_bags = [bag_from_mapping(x) for x in workloads.make_rbac_request_dicts(
        cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    caps["authz"] = captured(lambda: az.check_many(az_bags))
    libs = {}
    for name in VARIANTS:
        libs[name] = build_variant(name, kernels)
        for src, (_, regs) in libs[name].items():
            print(f"BUILD {name} {src}: {regs}", flush=True)

    def timed_variant(name: str) -> dict:
        fold = libs[name]["verdict_fold"][0].verdict_fold
        fold.argtypes, fold.restype = pe._FOLD_ARGS, ctypes.c_int
        pack = libs[name]["check_pack"][0].check_pack
        pack.argtypes, pack.restype = fused._PACK_ARGS, ctypes.c_int
        kernels._funcs[("verdict_fold", "verdict_fold", False)] = fold
        kernels._funcs[("check_pack", "check_pack", False)] = pack
        out = {}
        for world, cap in caps.items():
            for kname, ins in cap:
                if kname == "verdict_fold":
                    m, e, req, batch, params, q, c, ls, kind = ins
                    q0 = q.clone()
                    got = pe.verdict_fold(m, e, req, batch, params,
                                          q0.clone(), c, ls, kind)
                    want = pe.verdict_fold_plain(m, e, req, batch, params,
                                                 q0.clone(), c, ls, kind)
                    for g, w in zip(got, want):
                        cs.assert_equal(f"{name} fold {world}", g, w)
                    out[f"fold.{world}"] = median_ms(lambda: pe.verdict_fold(
                        m, e, req, batch, params, q0, c, ls, kind))
                    if name == "base" and c.has_lists:
                        bare = dataclasses.replace(c, has_lists=False)
                        out[f"fold.{world}.no_lists"] = median_ms(
                            lambda: pe.verdict_fold(m, e, req, batch, params,
                                                    q0, bare, ls, kind))
                elif kname == "check_pack":
                    cs.assert_equal(f"{name} pack {world}",
                                    fused.check_pack(*ins),
                                    fused.check_pack_plain(*ins))
                    out[f"pack.{world}"] = median_ms(
                        lambda: fused.check_pack(*ins))
        return out

    order = list(VARIANTS) + list(reversed(VARIANTS))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as fh:
        for i, name in enumerate(order):
            row = timed_variant(name)
            print(f"run {i} {name:8s} " + "  ".join(
                f"{k} {v:.5f}" if v is not None else f"{k} none"
                for k, v in row.items()), flush=True)
            fh.write(json.dumps({"run": i, "variant": name, "card": card,
                                 "ms": row}) + "\n")
    kernels._funcs.clear()
    for x in (srv, store, az, az_store):
        x.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
