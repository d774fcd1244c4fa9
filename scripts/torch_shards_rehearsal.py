"""Rehearse chip_smoke.py's phase 16 (the sharded serving plane) on the
CPU at a small size, before a run on the card.

    python3 scripts/torch_shards_rehearsal.py [RULES] [NAMESPACES]

(default 3,000 rules over 64 namespaces; the card runs 100,000 over 512).
Every server phase 16 builds for "cuda" is built on the CPU instead, with
its checkers made strict as a card server's are; the kernel wrappers'
plain versions run, and counting wrappers record their calls as launches
so that the phase's launch gates run; `check_kernels` (the replays
against the plain versions), the profiler and the stream check are
stubbed. Batch sizes, oracle rows and the make_store world are cut to
match. Prints the phase's own log lines; the timings are this host's
CPU, never the card's.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def count_launches() -> None:
    """Wrap each kernel wrapper of phase 16's path so that a call counts
    as the card's launch would (kernels.launched)."""
    from istio_tpu_torch import kernels
    from istio_tpu_torch.compiler import ruleset
    from istio_tpu_torch.models import policy_engine, quota_alloc
    from istio_tpu_torch.ops import bytes_ops
    from istio_tpu_torch.runtime import fused, rulestats

    def count(mod, attr, name, grids=1, kind=None):
        real = getattr(mod, attr)

        def wrapped(*a, **k):
            out = real(*a, **k)
            kernels.launched(name, grids, *(((kind,) if kind else ()) + a))
            return out
        setattr(mod, attr, wrapped)

    count(ruleset, "rule_match", "rule_match", 2)
    count(bytes_ops, "byte_lits", "byte_pred", 1, "lits")
    count(bytes_ops, "dfa_lits", "dfa_scan", 1, "lits")
    count(policy_engine, "verdict_fold", "verdict_fold")
    count(fused, "check_pack", "check_pack")
    count(rulestats, "rule_stats", "rule_stats")
    count(quota_alloc, "quota_alloc", "quota_alloc")


def main(n_rules: int = 3000, n_namespaces: int = 64) -> int:
    import torch
    torch.cuda.synchronize = lambda *a, **k: None
    from istio_tpu_torch import kernels
    kernels.build = lambda *a, **k: {}
    count_launches()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.SHARD_RULES, cs.SHARD_NAMESPACES = n_rules, n_namespaces
    cs.SHARD_B = (64, 256, 512)
    cs.SHARD_ORACLE_ROWS = 128
    cs.SHARD_LANE_ROWS = 256
    cs.SHARD_ITERS = 3
    cs.HEADLINE_RULES = 1300
    cs.device_ms = lambda fn, iters: None
    cs.check_kernels = lambda *a, **k: []
    cs.lane_streams = lambda srv: [object() for _ in srv.batcher.routers]

    import istio_tpu_torch.runtime as rt
    real = rt.RuntimeServer

    def server(store, args=None, device="cuda"):
        srv = real(store, args, device="cpu")
        if device == "cuda":
            srv.resilience.strict_device = True
            for b in (getattr(srv, "_sharded", None) or {}).get("banks", ()):
                b.checker.strict_device = True
        return srv

    rt.RuntimeServer = server
    cs.track_lanes()
    cs._GATE["base"] = cs.resilience_reading()
    t = time.perf_counter()
    cs.shards_phase()
    cs.resilience_gate("[16] end")
    print(f"rehearsal of phase 16 at {n_rules} rules / {n_namespaces} "
          f"namespaces: {time.perf_counter() - t:.1f} s on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:3])))
