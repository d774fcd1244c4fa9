#!/usr/bin/env python3
"""Time launch-plan variants of the seq_match kernel's chunk_map entry
point (K12) on one card, on the launches sequence-parallel matches give
it.

    python3 scripts/torch_seq_variants.py [--out FILE] [--variants V,...]

From the root of a checkout on the machine with the card. For each of
chip_smoke's SEQ_LAYOUTS it captures the launches of one
sharded_dfa_match on 8 virtual devices of card 0 (workloads'
make_long_subjects under the needle, `needle-[0-9]+`, S 19, whose
filler is lowercase text; and the route paths of
chip_smoke.route_subjects under the largest full-match route regex),
and at the first layout also one match of the needle over rows of
random bytes 0..255 (`bytes`, the same lengths: the lanes of a warp
meet in shared-memory banks far more often than on lowercase text);
then, for every variant, holds each chunk_map launch against its plain
version and times it alone on one stream (chip_smoke.graph_ms: a CUDA
graph of 50 launches between CUDA events), summed into device ms a
match. The variants run in the order given and then in reverse, so each
is timed twice, apart in time.

A plan variant is a set of seq_match.chunk_plan keywords: for its runs
the script puts a chunk_plan that passes them in seq_match's namespace,
where the wrapper looks it up (the port itself always launches the
default plan).

  base       the served plan: sub-chunks of at most 128 bytes
  sub32      sub-chunks of at most 32 bytes
  sub64      sub-chunks of at most 64 bytes
  sub256     sub-chunks of at most 256 bytes
  whole      one thread walks the whole chunk (no sub-chunks)

A source variant runs the served plan on a copy of
istio_tpu_torch/csrc/seq_match.cu with text edits, built with nvcc into
build/seq_variants/<name>/ and put in place of the served chunk_map for
its runs. The first three compute the same maps and are held against
the plain version; the probes compute wrong maps on purpose and are
timed without the equality check:

  t64, t256  64 or 256 threads a block (kThreads)
  noconv     every walk of every entry state to the chunk's end (S
             lookups a byte), no narrow walks
  launch     (probe) the regs kernel returns at once: the launch alone
  columns    (probe) returns after staging the table and its column
             tables
  nowalk     (probe) every walk skips its bytes after the first

Prints the card line, one line per variant run and layout, and writes
the rows as JSON lines to FILE (default chiprun_out/seq_variants.jsonl).
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

# name → seq_match.chunk_plan keywords
VARIANTS = {
    "base": {},
    "sub32": dict(sub_len=32),
    "sub64": dict(sub_len=64),
    "sub256": dict(sub_len=256),
    "whole": dict(sub_len=1 << 20),
}
_KERNEL_TOP = ("    int32_t* __restrict__ maps) {\n"
               "  extern __shared__ __align__(16) int32_t smem[];\n"
               "  constexpr int nt = kThreads;\n")
_THREADS = "constexpr int kThreads = 128;"
_REG_CHECK = ("  __device__ __forceinline__ void check() {\n#pragma unroll\n"
              "    for (int k = 0; k < kS; ++k)\n"
              "      if ((absorb >> st[k]) & 1u) live &= ~(1u << k);\n"
              "    fin = live == 0u;\n  }\n")
# name → text edits [(old, new)] of csrc/seq_match.cu
SOURCE_VARIANTS = {
    "t64": [(_THREADS, _THREADS.replace("128", "64"))],
    "t256": [(_THREADS, _THREADS.replace("128", "256"))],
    "noconv": [("    live = all & ~absorb;\n", "    live = all;\n"),
               (_REG_CHECK, "  __device__ __forceinline__ void check() {}\n"),
               ("  } else if (d <= kNarrow) {\n", "  } else if (false) {\n"),
               ("  __device__ __forceinline__ void check() "
                "{ fin = bit(absorb, x); }\n",
                "  __device__ __forceinline__ void check() {}\n")],
    "launch": [(_KERNEL_TOP, _KERNEL_TOP + "  if (nt > 0) return;\n")],
    "columns": [("  stage_columns<kS>(trans, S, s_tab, s_dist, s_vals, s_idx, "
                 "s_absorb);\n  __syncthreads();\n",
                 "  stage_columns<kS>(trans, S, s_tab, s_dist, s_vals, s_idx, "
                 "s_absorb);\n  __syncthreads();\n  if (nt > 0) return;\n")],
    "nowalk": [("    feed(p + 1, n - 1, w);\n", "")],
}
PROBES = ("launch", "columns", "nowalk")   # wrong maps on purpose


def build_source_variant(name: str, kernels):
    """The variant's chunk_map entry point (typed) and ptxas lines."""
    with open(os.path.join("istio_tpu_torch", "csrc", "seq_match.cu")) as f:
        text = f.read()
    for old, new in SOURCE_VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in seq_match.cu")
        text = text.replace(old, new)
    out_dir = os.path.join("build", "seq_variants", name)
    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "seq_match.cu"), \
        os.path.join(out_dir, "libseq_match.so")
    with open(src, "w") as f:
        f.write(text)
    r = subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
                        "-v", "-o", lib, src], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{r.stdout}\n"
                         f"{r.stderr}")
    return ctypes.CDLL(os.path.abspath(lib)).chunk_map, [
        x.strip() for x in (r.stdout + r.stderr).splitlines()
        if "registers" in x]


@contextlib.contextmanager
def source_variant(kernels, sm, fn):
    """The wrapper's chunk_map entry point swapped for `fn`."""
    key = ("seq_match", "chunk_map", False)
    fn.argtypes, fn.restype = sm._CHUNK_ARGS, ctypes.c_int
    served = kernels.function("seq_match", "chunk_map", sm._CHUNK_ARGS)
    kernels._funcs[key] = fn
    try:
        yield
    finally:
        kernels._funcs[key] = served


@contextlib.contextmanager
def plan_variant(sm, keywords: dict):
    """seq_match.chunk_plan with `keywords` for the wrapper's launches."""
    served = sm.chunk_plan
    sm.chunk_plan = functools.partial(served, **keywords)
    try:
        yield
    finally:
        sm.chunk_plan = served


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/seq_variants.jsonl")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    known = {**VARIANTS, **SOURCE_VARIANTS}
    if not set(names) <= set(known):
        ap.error(f"--variants: choose from {','.join(known)}")
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as cs
    from istio_tpu_torch import kernels, platform
    from istio_tpu_torch.ops.regex_dfa import compile_regex
    from istio_tpu_torch.parallel import seq_match as sm
    from istio_tpu_torch.parallel.mesh import Mesh
    from istio_tpu_torch.testing import workloads

    card = cs.smi("name,power.limit")
    print(card, flush=True)
    kernels.build(["seq_match"])
    built = {}
    for name in dict.fromkeys(names):
        if name in SOURCE_VARIANTS:
            built[name], regs = build_source_variant(name, kernels)
            print(f"BUILD {name}: {regs}", flush=True)
    rx = cs.route_regexes(cs.ROUTE_RULES)
    route = max(rx, key=lambda p: compile_regex(p).transitions.shape[0])
    pats = {"needle": (workloads.LONG_PATTERNS[0], "long"),
            "route": (route, "route")}
    launches = {}
    with platform.force_virtual_devices(cs.N_VIRTUAL, "cuda:0") as devs:
        mesh = Mesh(np.array(devs, dtype=object), ("sp",))
        for b, c, lc in cs.SEQ_LAYOUTS:
            for tag, (pat, kind) in pats.items():
                data, lens = workloads.make_long_subjects(b, c, lc, seed=b) \
                    if kind == "long" else cs.route_subjects(b, c * lc,
                                                             seed=b + 1)
                dfa = compile_regex(pat)
                with kernels.launches.capture() as cap:
                    sm.sharded_dfa_match(mesh, "sp", data.reshape(b, c, lc),
                                         lens, dfa.transitions, dfa.accept)
                torch.cuda.synchronize()
                launches[f"{tag} {b}x{c}x{lc}"] = [
                    x[1:] for n, x in cap if x[0] == "chunk_map"]
                if tag == "needle" and (b, c, lc) == cs.SEQ_LAYOUTS[0]:
                    noise = np.random.default_rng(b + 2).integers(
                        0, 256, data.shape, dtype=np.uint8)
                    with kernels.launches.capture() as cap:
                        sm.sharded_dfa_match(
                            mesh, "sp", noise.reshape(b, c, lc), lens,
                            dfa.transitions, dfa.accept)
                    torch.cuda.synchronize()
                    launches[f"bytes {b}x{c}x{lc}"] = [
                        x[1:] for n, x in cap if x[0] == "chunk_map"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as out:
        for turn, name in enumerate(names + names[::-1]):
            probe = name in PROBES
            with (source_variant(kernels, sm, built[name])
                  if name in SOURCE_VARIANTS else
                  plan_variant(sm, VARIANTS[name])):
                for key, ls in launches.items():
                    per = [cs.graph_ms(lambda a=a: sm.chunk_maps(*a), 50,
                                       want=None if probe else
                                       sm.chunk_maps_plain(*a))
                           for a in ls]
                    plan = sm.chunk_plan(ls[0][0].shape[2],
                                         int(ls[0][2].shape[0]))
                    row = {"variant": name, "turn": turn, "match": key,
                           "ms": sum(per), "per_launch_ms": per,
                           "plan": list(plan), "card": card}
                    print(f"{name:8s} turn {turn:2d}  {key:22s} "
                          f"{row['ms']:.5f} ms a match  plan {list(plan)}",
                          flush=True)
                    out.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
