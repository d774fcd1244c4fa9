"""Oracle parity surface for the sharded serving plane.

chip_smoke's phase 16 and the sharding tests judge the sharded path
against the SAME independent derivation: per-rule predicate truth via
the compiler's SnapshotOracle programs (the conformance oracle every
device program is pinned against) and per-rule check statuses via
compiler/ruleset.fused_check_status (the one host-side decision-status
truth the canary verification surface already shares).

Namespace visibility is applied by INDEX, not by walking all N rules
per bag — at 100k+ rules the recount must stay seconds, and
`global rules ∪ rules(ns)` is exactly the visible set the resolver
semantics define — but the per-rule evaluation is the SnapshotOracle's
own OracleProgram, unchanged.

Port of istio_tpu/sharding/parity.py.
"""
from __future__ import annotations

from typing import Sequence

from istio_tpu_torch.runtime.dispatcher import DEFAULT_IDENTITY_ATTR


def oracle_check_statuses(snapshot, plan, bags: Sequence,
                          identity_attr: str = DEFAULT_IDENTITY_ATTR
                          ) -> list[dict]:
    """Expected device-path check outcome per bag:

      {"status": int,        # lowest-active-rule non-OK fused status
       "deny_rule": int,     # that rule's GLOBAL index (-1 when OK)
       "active": [int, ...], # matched, namespace-visible rule idxs
       "errors": int}        # visible predicates that raised

    `plan` is the PARENT (monolithic) FusedPlan — its deny_info /
    list_rules are global-index keyed, which is what the sharded
    fold's remapped deny_rule must agree with."""
    from istio_tpu_torch.compiler.ruleset import (SnapshotOracle,
                                                  fused_check_status)
    from istio_tpu_torch.runtime.dispatcher import _namespace_of

    rs = snapshot.ruleset
    n_cfg = len(snapshot.rules)
    oracle = SnapshotOracle(
        rs.rules[:n_cfg], snapshot.finder,
        seed={r: p for r, p in rs.host_fallback.items() if r < n_cfg})
    by_ns: dict[str, list[int]] = {}
    global_idx: list[int] = []
    for ridx in range(n_cfg):
        ns = oracle.rules[ridx].namespace
        if ns:
            by_ns.setdefault(ns, []).append(ridx)
        else:
            global_idx.append(ridx)

    out: list[dict] = []
    for bag in bags:
        req_ns = _namespace_of(bag, identity_attr)
        visible = sorted(global_idx + by_ns.get(req_ns, []))
        active: list[int] = []
        errors = 0
        status, deny_rule = 0, -1
        for ridx in visible:
            try:
                matched = bool(oracle._prog(ridx).evaluate(bag))
            except Exception:
                errors += 1
                continue
            if not matched:
                continue
            active.append(ridx)
            if status == 0:
                s = fused_check_status(snapshot, plan, ridx, bag)
                if s != 0:
                    status, deny_rule = s, ridx
        out.append({"status": status, "deny_rule": deny_rule,
                    "active": active, "errors": errors})
    return out
