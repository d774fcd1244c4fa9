"""Shard planner — pack namespaces onto K banks by predicted budget.

The unit of placement is a NAMESPACE, never a rule: namespace targeting
(resolver.go:110 — default-namespace rules apply to everyone, other
rules only to requests addressed to their namespace) means a request's
visible rule set is `global ∪ rules(ns)`. Keeping each namespace whole
on one shard and replicating the global rules into every bank makes a
single bank sufficient for any request — the shard-routed check is
verdict-identical to the monolithic compile with NO cross-bank
combining per row.

Balance uses the same per-rule device-budget model the static analyzer
applies before compile (analysis/budget.py): all-EQ conjunctions cost
~2.5 int32-equivalent lanes per padded literal on the fused
gather-compare plane, everything else one int32 per literal on the
legacy plane, plus the rule's conjunction-index rows; predicates that
fall back to the host oracle carry a flat host cost (they burn python
per request, the scarcest serving resource). Namespaces are placed
LPT-greedy (largest predicted cost first onto the least-loaded shard)
— deterministic for a given rule list.

Port of istio_tpu/sharding/planner.py: `ShardPlan` and `plan_shards`
(scratch and delta modes), the per-rule cost model `predict_rule_costs`
with its layout-free EQ classification (the reference takes it from
analysis/budget.py), the publish-path `costs_from_ruleset` (prices an
already compiled RuleSetProgram from its retained decomposition) and
`trivial_plan` (the replica-only lanes' plan). Pilot's discovery
snapshots and the sharded serving plane (banks.py, router.py) call it.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Sequence

import numpy as np

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.ruleset import (DEFAULT_DNF_CAP, _AtomTable,
                                              _decompose, _fold_time_const,
                                              _rule_ast)
from istio_tpu_torch.compiler.tensor_expr import HostFallback
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.exprs import Expression

# flat predicted cost for a host-fallback rule: its oracle program runs
# interpreted python per request — weigh it like a fat device rule so
# fallback-heavy namespaces spread across shards instead of piling the
# host work onto one bank's overlay loop
HOST_FALLBACK_COST = 256.0
# a rule's conjunction-index rows (conj_m_idx + conj_n_idx) cost
# 2 int32 entries per conjunction column
RULE_ROW_COST = 2.0


class ShardPlanError(ValueError):
    """The requested plan cannot be built (bad shard count)."""


def _slot_shaped(e: Expression, finder) -> bool:
    """A bare attribute of a non-map type, or a constant-string-key map
    index: the shapes the compiler resolves to a slot (the reference's
    analysis/budget.py:_slot_shaped)."""
    if e.var is not None:
        try:
            vt = finder.get_attribute(e.var.name)
            return vt is not None and vt != ValueType.STRING_MAP
        except Exception:
            return False
    f = e.fn
    return (f is not None and f.name == "INDEX" and len(f.args) == 2
            and f.args[0].var is not None
            and f.args[1].const_ is not None
            and isinstance(f.args[1].const_.value, str))


def _const_shaped(e: Expression) -> bool:
    """A literal, or a foldable ip()/timestamp() over one."""
    if e.const_ is not None:
        return True
    try:
        return _fold_time_const(e) is not None
    except Exception:
        return False


def _eq_shaped(e: Expression, finder) -> bool:
    """The compiler's fused gather-compare eligibility without a layout
    (the reference's analysis/budget.py:_eq_shaped): a bare BOOL
    attribute, or EQ / NEQ between a slot-shaped ref and a constant."""
    if e.var is not None:
        try:
            return finder.get_attribute(e.var.name) == ValueType.BOOL
        except Exception:
            return False
    f = e.fn
    if f is None or f.name not in ("EQ", "NEQ") or len(f.args) != 2:
        return False
    return any(_slot_shaped(x, finder) and _const_shaped(y)
               for x, y in ((f.args[0], f.args[1]),
                            (f.args[1], f.args[0])))


def _dnf_cost(m, n, atom_eq) -> float:
    """One decomposed rule's predicted budget: all-EQ conjunctions on
    the fused eqc_* lanes (2.5 a literal), the rest one lit_idx entry a
    literal, plus the rule's conjunction-index rows."""
    c = 0.0
    for conj in (m | n):
        lanes = max(len(conj), 1)
        if all(atom_eq(a) for a, _kind in conj):
            c += 2.5 * lanes          # fused eqc_* lanes
        else:
            c += float(lanes)         # legacy lit_idx row
    return c + RULE_ROW_COST * max(len(m), len(n), 1)


def predict_rule_costs(preds: Sequence, finder: AttributeDescriptorFinder,
                       dnf_cap: int = DEFAULT_DNF_CAP) -> np.ndarray:
    """Per-rule predicted device budget (float array, len(preds)) —
    the tile-entry model of analysis/budget.check_budgets applied per
    rule instead of per snapshot. `preds` are compiler Rule objects
    (ast or match string). Atoms dedup across rules exactly like the
    compiler (shared _AtomTable), so a namespace of near-identical
    predicates is priced by its real marginal index-tensor footprint,
    not a naive per-rule re-count."""
    table = _AtomTable()
    eq_cache: dict[int, bool] = {}

    def atom_eq(aidx: int) -> bool:
        hit = eq_cache.get(aidx)
        if hit is None:
            hit = _eq_shaped(table.asts[aidx], finder)
            eq_cache[aidx] = hit
        return hit

    costs = np.zeros(max(len(preds), 1), np.float64)
    for ridx, rule in enumerate(preds):
        mark = table.mark()
        try:
            ast = _rule_ast(rule)
            m, n = _decompose(ast, table, dnf_cap)
        except HostFallback:
            table.revert(mark)
            costs[ridx] = HOST_FALLBACK_COST
            continue
        except Exception:
            table.revert(mark)
            costs[ridx] = HOST_FALLBACK_COST
            continue
        costs[ridx] = _dnf_cost(m, n, atom_eq)
    return costs[:len(preds)]


def costs_from_ruleset(rs, finder: AttributeDescriptorFinder
                       ) -> np.ndarray:
    """Per-rule predicted costs from an ALREADY-COMPILED
    RuleSetProgram — the publish-path variant: compile_ruleset just
    ran the full decomposition and retained it (per_rule_dnf /
    atom_asts / host_fallback), so a 100k-rule config swap must not
    pay a second parse + DNF pass on the rebuild thread. Same cost
    model as predict_rule_costs (which remains the standalone entry
    for un-compiled rule lists)."""
    eq_cache: dict[int, bool] = {}

    def atom_eq(aidx: int) -> bool:
        hit = eq_cache.get(aidx)
        if hit is None:
            hit = _eq_shaped(rs.atom_asts[aidx], finder)
            eq_cache[aidx] = hit
        return hit

    n = len(rs.per_rule_dnf)
    costs = np.zeros(max(n, 1), np.float64)
    for ridx, mn in enumerate(rs.per_rule_dnf):
        if mn is None or ridx in rs.host_fallback:
            costs[ridx] = HOST_FALLBACK_COST
            continue
        costs[ridx] = _dnf_cost(*mn, atom_eq)
    return costs[:n]


@dataclasses.dataclass
class ShardPlan:
    """A namespace → shard assignment plus its audit trail.

    `shard_rules[k]` holds the GLOBAL config-rule indices compiled
    into bank k, sorted ascending — global (default-namespace) rules
    replicated into every entry, so relative rule order (and therefore
    lowest-rule-index-wins status combining) is preserved inside each
    bank."""
    n_shards: int
    ns_to_shard: dict[str, int]
    shard_rules: list[list[int]]
    global_rules: list[int]
    shard_cost: list[float]
    ns_cost: dict[str, float]
    plan_wall_s: float = 0.0
    revision: int = 0
    # delta-planning audit trail (plan_shards(prev=...)): namespaces
    # the bounded rebalance relocated this generation (each one costs
    # a bank recompile on BOTH its old and new shard — the budget is
    # the knob that trades balance for republish latency), plus the
    # kept/new/removed accounting the stability tests pin
    moved_ns: list = dataclasses.field(default_factory=list)
    stability: dict = dataclasses.field(default_factory=dict)

    def shard_of(self, ns: str) -> int:
        """Bank for a request namespace. Namespaces the plan never saw
        (no rules configured for them — only global rules apply) hash
        stably onto a shard; crc32, not hash(), so routing agrees
        across processes/restarts regardless of PYTHONHASHSEED."""
        s = self.ns_to_shard.get(ns)
        if s is not None:
            return s
        return zlib.crc32(ns.encode("utf-8", "replace")) % self.n_shards

    def balance(self) -> dict:
        """Shard-balance summary — the fleet bench's
        `fleet_shard_balance` payload and the planner property tests'
        judged surface."""
        costs = [float(c) for c in self.shard_cost]
        mean = sum(costs) / max(len(costs), 1)
        ns_per = [0] * self.n_shards
        for s in self.ns_to_shard.values():
            ns_per[s] += 1
        return {
            "n_shards": self.n_shards,
            "rules_per_shard": [len(r) for r in self.shard_rules],
            "namespaces_per_shard": ns_per,
            "global_rules": len(self.global_rules),
            "cost_per_shard": [round(c, 1) for c in costs],
            "max_over_mean_cost": round(max(costs) / mean, 3)
            if mean > 0 else 1.0,
            "min_over_mean_cost": round(min(costs) / mean, 3)
            if mean > 0 else 1.0,
        }

    def to_json(self) -> dict:
        return {
            "revision": self.revision,
            "plan_wall_ms": round(self.plan_wall_s * 1e3, 3),
            "balance": self.balance(),
            "stability": dict(self.stability) or {"mode": "scratch"},
        }


def trivial_plan(n_lanes: int) -> ShardPlan:
    """The no-sharding plan replica-only serving routes through: K
    lane slots, no namespace assignments — shard_of() falls through to
    the stable hash, giving sticky-by-namespace lane selection without
    a compiled partition."""
    n = max(n_lanes, 1)
    return ShardPlan(n_shards=n, ns_to_shard={},
                     shard_rules=[[] for _ in range(n)],
                     global_rules=[], shard_cost=[0.0] * n, ns_cost={})


def plan_shards(preds: Sequence, finder: AttributeDescriptorFinder,
                n_shards: int,
                costs: np.ndarray | None = None,
                dnf_cap: int = DEFAULT_DNF_CAP,
                revision: int = 0,
                prev: ShardPlan | None = None,
                rebalance_budget: int = 0) -> ShardPlan:
    """Partition compiler Rule preds into an n_shards ShardPlan.

    Scratch mode (prev=None): LPT greedy — namespaces sorted by total
    predicted cost (descending, name tie-break) land on the currently
    least-loaded shard; the replicated global-rule cost is charged to
    every shard up front. Deterministic for a given (preds, n_shards).

    Delta mode (prev= a same-width plan): PLAN STABILITY is the
    contract — every namespace prev knows keeps its shard (its bank's
    content hash, and therefore the bank cache's carry-over decision,
    depends on exactly which namespaces share its bank), new
    namespaces LPT-place onto the least-loaded shard, removed ones
    simply vanish. An optional LPT rebalance then moves at most
    `rebalance_budget` namespaces (largest imbalance first, each move
    strictly reducing the max-shard cost) — every move recompiles two
    banks, so the budget is an explicit latency/balance trade, default
    0. Routing of unchanged namespaces is byte-identical to prev by
    construction (kept assignments + the same crc32 fallback)."""
    if n_shards < 1:
        raise ShardPlanError(f"n_shards must be >= 1, got {n_shards}")
    t0 = time.perf_counter()
    if costs is None:
        costs = predict_rule_costs(preds, finder, dnf_cap)
    by_ns: dict[str, list[int]] = {}
    global_rules: list[int] = []
    for ridx, rule in enumerate(preds):
        ns = getattr(rule, "namespace", "") or ""
        if ns:
            by_ns.setdefault(ns, []).append(ridx)
        else:
            global_rules.append(ridx)
    ns_cost = {ns: float(sum(costs[i] for i in idxs))
               for ns, idxs in by_ns.items()}
    global_cost = float(sum(costs[i] for i in global_rules))

    shard_cost = [global_cost] * n_shards
    shard_ns: list[list[str]] = [[] for _ in range(n_shards)]
    moved: list[str] = []
    stability: dict = {"mode": "scratch"}
    if prev is not None and prev.n_shards == n_shards \
            and prev.ns_to_shard:
        kept = {ns: prev.ns_to_shard[ns] for ns in by_ns
                if ns in prev.ns_to_shard}
        fresh = [ns for ns in by_ns if ns not in kept]
        removed = [ns for ns in prev.ns_to_shard if ns not in by_ns]
        for ns, k in kept.items():
            shard_cost[k] += ns_cost[ns]
            shard_ns[k].append(ns)
        for ns in sorted(fresh, key=lambda ns: (-ns_cost[ns], ns)):
            k = min(range(n_shards), key=lambda s: (shard_cost[s], s))
            shard_cost[k] += ns_cost[ns]
            shard_ns[k].append(ns)
        for _ in range(max(int(rebalance_budget), 0)):
            hi = max(range(n_shards), key=lambda s: (shard_cost[s], -s))
            lo = min(range(n_shards), key=lambda s: (shard_cost[s], s))
            gap = shard_cost[hi] - shard_cost[lo]
            # a move of cost c turns (hi, lo) into (hi-c, lo+c): it
            # strictly improves the pair's peak iff 0 < c < gap; the
            # best c is gap/2 (perfectly splitting the imbalance)
            cands = [ns for ns in shard_ns[hi]
                     if 0.0 < ns_cost[ns] < gap]
            if not cands:
                break
            ns = min(cands,
                     key=lambda x: (abs(ns_cost[x] - gap / 2.0), x))
            shard_ns[hi].remove(ns)
            shard_ns[lo].append(ns)
            shard_cost[hi] -= ns_cost[ns]
            shard_cost[lo] += ns_cost[ns]
            moved.append(ns)
        # a relocated FRESH namespace never sat on a shard before —
        # it costs one new-bank compile either way and must not be
        # booked as a previously-placed namespace churning off its
        # shard (only moves of KEPT namespaces cost two recompiles)
        moved_kept = [ns for ns in moved if ns in kept]
        stability = {"mode": "delta",
                     "kept": len(kept) - len(moved_kept),
                     "new": len(fresh), "removed": len(removed),
                     "moved": list(moved),
                     "moved_kept": moved_kept,
                     "rebalance_budget": int(rebalance_budget)}
    else:
        order = sorted(by_ns, key=lambda ns: (-ns_cost[ns], ns))
        for ns in order:
            k = min(range(n_shards), key=lambda s: (shard_cost[s], s))
            shard_cost[k] += ns_cost[ns]
            shard_ns[k].append(ns)
    ns_to_shard = {ns: k for k, nss in enumerate(shard_ns)
                   for ns in nss}
    shard_rules = []
    for k in range(n_shards):
        idxs = list(global_rules)
        for ns in shard_ns[k]:
            idxs.extend(by_ns[ns])
        shard_rules.append(sorted(idxs))
    return ShardPlan(n_shards=n_shards, ns_to_shard=ns_to_shard,
                     shard_rules=shard_rules,
                     global_rules=sorted(global_rules),
                     shard_cost=shard_cost, ns_cost=ns_cost,
                     plan_wall_s=time.perf_counter() - t0,
                     revision=revision,
                     moved_ns=moved, stability=stability)
