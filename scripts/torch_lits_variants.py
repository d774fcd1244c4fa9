#!/usr/bin/env python3
"""Time launch-plan variants of the byte_pred and dfa_scan kernels (K3,
K2) on one card, on the launches the served paths give them.

    python3 scripts/torch_lits_variants.py [--out FILE] [--variants V,...]

From the root of a checkout on the machine with the card. It captures
every byte_lits / dfa_lits launch of the headline engine step
(make_engine(10_000)) and of the authz world's served step
(make_rbac_store(1000)), each at B = 64, 256 and 2,048, of the route
select (make_route_world(10_000), B = 2,048), and the REGEX lists'
dfa_scan plane launch of the list world (B = 2,048); then, for every
variant, holds each launch against its plain version and times it: the
median of 7 profiler windows of 20 calls. The variants run in the order
given and then in reverse, so each is timed twice, apart in time.

A variant is a set of bytes_ops.byte_plan and bytes_ops.dfa_plan
keywords: for its runs the script puts plans that pass them in
bytes_ops' namespace, where the wrappers look them up (the port itself
always launches the default plans).

  base      the default plans: K3 a row per group of lanes that gives
            each of its patterns a lane (a warp at 32 patterns or more),
            the lanes splitting the patterns, 256 threads, at most 2
            blocks an SM, rows and patterns staged in shared memory
            (byte_staged; byte_direct only for rows too long for it); K2
            128 to 256 threads, tiles of ceil(B / 2·SMs) rows
  direct    K3 reading rows and patterns in place (byte_direct)
  direct128 K3 direct, blocks of 128 threads
  directw   K3 direct, a warp per row
  warp      K3 a warp per row whatever the pattern count
  lanes     K3 with lanes as rows (a group of 1 lane)
  group8    K3 with 8 lanes a row
  t128      K3 blocks of 128 threads
  bps1      K3 at most 1 block an SM
  bps8      K3 at most 8 blocks an SM
  min32     K2 blocks of as few as 32 threads
  tiles1    K2 tiles of ceil(B / SMs) rows
  tiles4    K2 tiles of ceil(B / 4·SMs) rows

A source variant runs the default plans on a copy of
istio_tpu_torch/csrc/dfa_scan.cu with text edits, built with nvcc into
build/lits_variants/<name>/ and put in place of the served library's
entry points for its runs:

  chains2   K2 with 2 walks a thread, interleaved byte by byte
  chains4   K2 with 4 walks a thread
  global    K2 reading the table through L1 / L2 (no staging)
  walk4     K2 reads a walk's class string a word (four classes) at a
            time, the next word read ahead, the four steps predicated

The chunked walk (B13's composition of transition maps inside one row)
is not among them: it was not tried. Prints the card line, the builds'
ptxas lines, one line per variant run, and writes the rows as JSON lines
to FILE (default chiprun_out/lits_variants.jsonl).
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

# name → (byte_plan keywords, dfa_plan keywords)
VARIANTS = {
    "base": ({}, {}),
    "direct": (dict(staged=False), {}),
    "direct128": (dict(staged=False, threads=128), {}),
    "directw": (dict(staged=False, group=32), {}),
    "warp": (dict(group=32), {}),
    "lanes": (dict(group=1), {}),
    "group8": (dict(group=8), {}),
    "t128": (dict(threads=128), {}),
    "bps1": (dict(blocks_per_sm=1), {}),
    "bps8": (dict(blocks_per_sm=8), {}),
    "min32": ({}, dict(min_threads=32)),
    "tiles1": ({}, dict(tiles_per_sm=1.0)),
    "tiles4": ({}, dict(tiles_per_sm=4.0)),
}
_WALK1 = """      for (int i = 0; i < len; ++i) off = tab[off + cls[i]];
"""
_WALK4 = """      uint32_t cur = len > 0 ? *reinterpret_cast<const uint32_t*>(cls) : 0u;
      for (int i = 0; i < len; i += 4) {
        const uint32_t w = cur;
        cur = i + 4 < len ? *reinterpret_cast<const uint32_t*>(cls + i + 4)
                          : 0u;
        off = tab[off + (int)(w & 255u)];
        if (i + 1 < len) off = tab[off + (int)((w >> 8) & 255u)];
        if (i + 2 < len) off = tab[off + (int)((w >> 16) & 255u)];
        if (i + 3 < len) off = tab[off + (int)(w >> 24)];
      }
"""
# the served kernel's walk loop: one (row, pattern) chain a thread
_ONE_CHAIN = """    for (int c = threadIdx.x; c < rows * N; c += blockDim.x) {
      const int row = c / N, pat = c - row * N;
      const int len = min(max(tlen[row], 0), L);
      const long long b = r0 + row;
      // what the literal pair needs, loaded before the walk so that its
      // latency hides behind it
      int col = 0, mode = 0;
      lits::RowState rst{0, false, false};
      if (kLits) {
        col = __ldg(k.cols + pat);
        mode = __ldg(k.mode + pat);
        rst = lits::row_state(s, b);
      }
      const uint8_t* cls = cstr + row * cs;
      int off = st0[pat] * C;
      for (int i = 0; i < len; ++i) off = tab[off + cls[i]];
      const bool hit = acc[(long long)(off / C) * N + pat] != 0;
      if (kLits) {
        lits::write(out, b, col, mode, rst, hit);
      } else {
        lits::st_global_u8(plane + b * N + pat, hit ? 1u : 0u);
      }
    }
"""


def _chains(n: int) -> str:
    """The walk loop with n (row, pattern) chains a thread, interleaved
    byte by byte, each stopping at its own row's length."""
    return f"""    constexpr int kChains = {n};
    const int total = rows * N;
    for (int c0 = 0; c0 < total; c0 += blockDim.x * kChains) {{
      int off[kChains], len[kChains], row[kChains], pat[kChains];
      int col[kChains], mode[kChains];
      lits::RowState rst[kChains];
      int longest = 0;
#pragma unroll
      for (int j = 0; j < kChains; ++j) {{
        const int c = c0 + threadIdx.x + j * blockDim.x;
        const bool live = c < total;
        row[j] = live ? c / N : 0;
        pat[j] = live ? c - row[j] * N : -1;
        len[j] = live ? min(max(tlen[row[j]], 0), L) : 0;
        off[j] = live ? st0[pat[j]] * C : 0;
        longest = max(longest, len[j]);
        if (kLits && live) {{
          col[j] = __ldg(k.cols + pat[j]);
          mode[j] = __ldg(k.mode + pat[j]);
          rst[j] = lits::row_state(s, r0 + row[j]);
        }}
      }}
      for (int i = 0; i < longest; ++i) {{
#pragma unroll
        for (int j = 0; j < kChains; ++j)
          if (i < len[j]) off[j] = tab[off[j] + cstr[row[j] * cs + i]];
      }}
#pragma unroll
      for (int j = 0; j < kChains; ++j) {{
        if (pat[j] < 0) continue;
        const long long b = r0 + row[j];
        const bool hit = acc[(long long)(off[j] / C) * N + pat[j]] != 0;
        if (kLits) {{
          lits::write(out, b, col[j], mode[j], rst[j], hit);
        }} else {{
          lits::st_global_u8(plane + b * N + pat[j], hit ? 1u : 0u);
        }}
      }}
    }}
"""


_STAGED = "  const bool staged = with_tab <= kMaxSmem;\n"
# name → (source, text edits [(old, new)])
SOURCE_VARIANTS = {
    "chains2": ("dfa_scan", [(_ONE_CHAIN, _chains(2))]),
    "chains4": ("dfa_scan", [(_ONE_CHAIN, _chains(4))]),
    "global": ("dfa_scan", [(_STAGED, "  const bool staged = false;\n")]),
    "walk4": ("dfa_scan", [(_WALK1, _WALK4)]),
}
NAMES = list(VARIANTS) + list(SOURCE_VARIANTS)


def build_variant(name: str, kernels) -> tuple:
    """Source variant `name`'s library → (source, CDLL, ptxas lines)."""
    src_name, edits = SOURCE_VARIANTS[name]
    src_dir = os.path.join("istio_tpu_torch", "csrc")
    with open(os.path.join(src_dir, f"{src_name}.cu")) as fh:
        text = fh.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} not once in the source")
        text = text.replace(old, new)
    out_dir = os.path.join("build", "lits_variants", name)
    os.makedirs(out_dir, exist_ok=True)
    src, lib = (os.path.join(out_dir, f) for f in (f"{src_name}.cu",
                                                   f"lib{src_name}.so"))
    with open(src, "w") as fh:
        fh.write(text)
    r = subprocess.run(
        [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", src_dir, "-o", lib,
         src], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{r.stdout}\n"
                         f"{r.stderr}")
    return src_name, ctypes.CDLL(os.path.abspath(lib)), \
        ptxas_lines(r.stdout + r.stderr)


@contextlib.contextmanager
def swapped(kernels, bytes_ops, built):
    """The wrappers launch the variant library's entry points in the
    block (None: the served library's)."""
    if built is None:
        yield
        return
    src_name, lib, _ = built
    args = {"dfa_scan": (("dfa_scan", bytes_ops._DFA_ARGS),
                         ("dfa_lits", bytes_ops._DFA_LITS_ARGS)),
            "byte_pred": (("byte_pred", bytes_ops._BYTE_PRED_ARGS),
                          ("byte_lits", bytes_ops._BYTE_LITS_ARGS))}
    keys = []
    for sym, argtypes in args[src_name]:
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        key = (src_name, sym, False)
        kernels._funcs[key] = fn
        keys.append(key)
    try:
        yield
    finally:
        for key in keys:
            kernels._funcs.pop(key, None)


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines() if any(
        k in line for k in ("Compiling entry", "registers", "spill"))]


@contextlib.contextmanager
def planned(bytes_ops, byte_kw: dict, dfa_kw: dict):
    """bytes_ops' wrappers launch the plans with these keywords in the
    block."""
    served = bytes_ops.byte_plan, bytes_ops.dfa_plan
    bytes_ops.byte_plan = functools.partial(served[0], **byte_kw)
    bytes_ops.dfa_plan = functools.partial(served[1], **dfa_kw)
    try:
        yield
    finally:
        bytes_ops.byte_plan, bytes_ops.dfa_plan = served


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/lits_variants.jsonl")
    ap.add_argument("--variants", default=",".join(NAMES),
                    help="comma-separated subset of " + ",".join(NAMES))
    args = ap.parse_args()
    names = args.variants.split(",")
    if not set(names) <= set(NAMES):
        ap.error(f"--variants: choose from {','.join(NAMES)}")
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("torch_lits_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.ops import bytes_ops
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads

    card = cs.smi("name,power.limit")
    print(card, flush=True)
    for name, info in kernels.build(["byte_pred", "dfa_scan"]).items():
        for line in ptxas_lines(info["log"]):
            print(f"BUILD {name} {line}", flush=True)
    libs = {}
    for name in names:
        if name in SOURCE_VARIANTS:
            libs[name] = build_variant(name, kernels)
            for line in libs[name][2]:
                print(f"BUILD {name} {line}", flush=True)

    def launches(drive, kind="lits"):
        drive()
        with kernels.launches.capture() as cap:
            drive()
        torch.cuda.synchronize()
        return [(n, x[1:]) for n, x in cap
                if n in ("byte_pred", "dfa_scan") and x[0] == kind]

    def median_ms(fn):
        ws = [w for w in (cs.device_ms(fn, 20) for _ in range(7))
              if w is not None]
        return sorted(ws)[len(ws) // 2] if ws else None

    sizes = (64, 256, cs.HEADLINE_B)
    calls = {}          # "<world><B>.<kernel>#i" → (name, kind, args)
    eng = workloads.make_engine(cs.HEADLINE_RULES, with_quota=True,
                                device="cuda")
    for b in sizes:
        bags, req = cs.headline_batch(eng, b)
        batch = eng.tensorizer.tensorize(bags).to("cuda")
        req_d = torch.as_tensor(req).to("cuda")
        for i, (n, x) in enumerate(launches(lambda: eng.check(batch, req_d))):
            calls[f"headline{b}.{n}#{i}"] = (n, "lits", x)
    az_store = workloads.make_rbac_store(cs.AUTHZ_ROLE_RULES)
    az = RuntimeServer(az_store, ServerArgs(
        default_manifest=workloads.MESH_MANIFEST, buckets=sizes,
        rulestats_drain_s=0), device="cuda")
    az_bags = [bag_from_mapping(x) for x in workloads.make_rbac_request_dicts(
        cs.HEADLINE_B, seed=cs.HEADLINE_B)]
    for b in sizes:
        for i, (n, x) in enumerate(launches(
                lambda: az.check_many(az_bags[:b]))):
            calls[f"authz{b}.{n}#{i}"] = (n, "lits", x)
    services, rules = workloads.make_route_world(cs.ROUTE_RULES)
    tbl = RouteTable(services, rules, device="cuda")
    rt_bags = [bag_from_mapping(r) for r in workloads.make_route_requests(
        cs.HEADLINE_B, n_services=len(services), seed=cs.HEADLINE_B)]
    for i, (n, x) in enumerate(launches(lambda: tbl.select(rt_bags))):
        calls[f"routes{cs.HEADLINE_B}.{n}#{i}"] = (n, "lits", x)
    ls_store = cs.list_world_store()
    ls = RuntimeServer(ls_store, ServerArgs(buckets=sizes,
                                            rulestats_drain_s=0),
                       device="cuda")
    dicts = cs.list_world_dicts()
    ls_bags = [bag_from_mapping(x) for x in
               (dicts * (cs.HEADLINE_B // len(dicts) + 1))[:cs.HEADLINE_B]]
    for i, (n, x) in enumerate(launches(lambda: ls.check_many(ls_bags),
                                        "plane")):
        calls[f"lists{cs.HEADLINE_B}.{n}.plane#{i}"] = (n, "plane", x)
    for key, (n, kind, x) in calls.items():
        data = x[0]
        k = (x[2] if kind == "plane" else x[4]).n
        print(f"CALL {key} B={data.shape[0]} L={data.shape[1]} k={k} "
              f"aligned={bytes_ops._aligned(data)}", flush=True)

    def timed_variant(name: str) -> dict:
        out = {}
        with planned(bytes_ops, *VARIANTS.get(name, ({}, {}))), \
                swapped(kernels, bytes_ops, libs.get(name)):
            for key, (n, kind, x) in calls.items():
                cs.subject_check(n, kind, x, f"{name} {key}")
                planes = None
                if kind == "lits":
                    em = x[7]
                    planes = cs.prefilled_planes(em.shape[0], em.shape[1], 2,
                                                 em.device)
                out[key] = median_ms(
                    lambda: cs.subject_kernel(n, kind, x, planes))
        return out

    order = names + names[::-1]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as fh:
        for i, name in enumerate(order):
            row = timed_variant(name)
            print(f"run {i} {name:8s} " + "  ".join(
                f"{k} {v:.5f}" if v is not None else f"{k} none"
                for k, v in row.items()), flush=True)
            plans = VARIANTS.get(name, ({}, {}))
            fh.write(json.dumps({"run": i, "variant": name, "card": card,
                                 "byte_plan": plans[0], "dfa_plan": plans[1],
                                 "edits": len(SOURCE_VARIANTS.get(
                                     name, ("", ()))[1]),
                                 "ms": row}) + "\n")
    for x in (az, az_store, ls, ls_store):
        x.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
