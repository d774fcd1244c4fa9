"""Shard banks — each shard compiled into a full serving stack.

A bank is NOT a thinner code path: it is a sub-Snapshot (the shard's
rules + every replicated global rule, sharing the parent's finder,
handlers, instances and InternTable) compiled through the SAME
pipeline the monolithic path uses — compile_ruleset for the predicate
program, build_fused_plan for the device engine (deny/list fusion,
host-overlay map, per-rule telemetry, canary recorder tap), a real
Dispatcher on top. On the card every bank trip is one fused trip
through the existing kernels (rule_match, dfa_lits / byte_lits where
the bank has subject groups, verdict_fold, check_pack, rule_stats with
telemetry on).

Host-overlay rules are pinned to their home shard by construction
(assignment is by namespace; a rule's host actions and host-fallback
oracle program recompile inside its own bank). Quota rules route
correctly across banks because quota STATE never lives in a bank:
device quota pools are controller-owned, keyed by handler name, and
the bank's check response carries (bank dispatcher, bank-local active
quota rules) as its quota_context — exactly the contract
RuntimeServer.quota_fused already honors, so a global quota rule
replicated into every bank still allocates once per request from the
one shared pool. The in-step quota merge is the one quota shape that
CANNOT cross banks (one merged device program per pool) — the server
refuses it under sharding (instep_quota_target → None).

Port of istio_tpu/sharding/banks.py. Each bank's ruleset compiles onto
the parent ruleset's device. The reference hands the parent's
DecompCache to every bank compile; the port has none (ROADMAP.md), so
a bank parses and decomposes its rules again.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Sequence

import numpy as np

from istio_tpu_torch.compiler.layout import Tensorizer
from istio_tpu_torch.compiler.ruleset import compile_ruleset
from istio_tpu_torch.runtime.config import Snapshot
from istio_tpu_torch.runtime.dispatcher import Dispatcher
from istio_tpu_torch.sharding.planner import ShardPlan
from istio_tpu_torch.utils.log import scope

log = scope("sharding.banks")


class ShardingUnsupported(RuntimeError):
    """The snapshot cannot shard (e.g. device-lowered rbac pseudo-rule
    rows reference absolute ruleset positions) — the server falls back
    to monolithic serving and says why."""


@dataclasses.dataclass
class ShardBank:
    """One compiled shard: sub-snapshot + dispatcher + index map."""
    shard_id: int
    snapshot: Snapshot
    dispatcher: Dispatcher
    # bank-local rule index → parent (global) config rule index; the
    # router's fold remaps deny attribution through this
    local_to_global: np.ndarray
    predicted_cost: float = 0.0
    # per-bank ResilientChecker (runtime/resilience.py): each bank
    # carries its OWN circuit breaker + CPU-oracle fallback over the
    # bank's rules — a flapping bank degrades to its oracle without
    # touching its siblings. Wired by RuntimeServer._rebuild_sharded
    # (it owns the ResilienceConfig); None = raw dispatcher.check
    # (tests driving banks directly).
    checker: Any = None
    # delta-compilation bookkeeping (bank_content_key / the server's
    # content-addressed bank cache): the content hash this bank was
    # compiled for, and the config generation that compiled it — a
    # carried bank keeps built_revision while serving newer plans
    content_key: str = ""
    built_revision: int = 0

    def check(self, bags, deadline: float | None = None) -> list:
        """The router's per-bank entry: resilient when wired."""
        if self.checker is not None:
            return list(self.checker.run_batch(bags,
                                               deadline=deadline))
        return self.dispatcher.check(bags, deadline=deadline)

    @property
    def n_rules(self) -> int:
        return len(self.snapshot.rules)

    def bank_bytes(self) -> int:
        """Resident device bytes of the bank's compiled programs (the
        ruleset's index tensors + the engine's tables)."""
        total = 0
        plan = self.dispatcher.fused
        params: Mapping[str, Any] = plan.engine.params \
            if plan is not None else self.snapshot.ruleset.params
        for v in params.values():
            total += int(getattr(v, "nbytes", 0) or 0)
        return total

    def stats(self) -> dict:
        out = {
            "shard": self.shard_id,
            "rules": self.n_rules,
            "host_overlay_rules":
                len(self.dispatcher.fused.host_rule_idx)
                if self.dispatcher.fused is not None else 0,
            "bank_bytes": self.bank_bytes(),
            "predicted_cost": round(self.predicted_cost, 1),
            "built_revision": self.built_revision,
        }
        if self.content_key:
            out["content_key"] = self.content_key[:12]
        if self.checker is not None:
            out["breaker"] = self.checker.breaker.state
        return out


def snapshot_static_digest(parent: Snapshot, *, identity_attr: str,
                           buckets: Sequence[int],
                           rule_telemetry: bool) -> str:
    """Digest of the COMPILE-ENVIRONMENT inputs every bank of a
    snapshot shares: the attribute manifest (type decisions), the
    exact compile_ruleset kwargs (layout columns, byte slots, extern
    ingest, max_str_len, rule_pad), and the serving knobs baked into
    a bank's dispatcher at construction. Any change here invalidates
    EVERY bank — correct, because these are the inputs a compiled
    program cannot revalidate after the fact."""
    from istio_tpu_torch.compiler.cache import (manifest_digest,
                                                stable_digest)

    return stable_digest({
        "manifest": manifest_digest(parent.finder),
        "compile_kwargs": parent.compile_kwargs,
        "identity_attr": identity_attr,
        "buckets": sorted(int(b) for b in buckets),
        "rule_telemetry": bool(rule_telemetry),
    })


def bank_content_key(parent: Snapshot, plan: ShardPlan, k: int,
                     static_digest: str) -> str:
    """Deterministic content hash of shard k's ruleset decomposition —
    THE key of the content-addressed bank cache. Covers, in bank-local
    rule order: each rule's name/namespaces/match source and its
    action wiring, plus the content digests of every handler and
    instance those actions reference, on top of the shared
    static digest (manifest + compile_kwargs + serving knobs). Global
    rules are replicated into every shard's list, so editing one
    changes every bank's key — the full-rebuild case, by design.
    Deliberately NOT covering global rule indices: a delta elsewhere
    in the config renumbers them without changing this bank's
    compiled artifact (rebind_bank refreshes the index map instead).
    """
    h = hashlib.sha256(static_digest.encode("ascii"))
    ref_handlers: set[str] = set()
    ref_instances: set[str] = set()
    for i in plan.shard_rules[k]:
        rc = parent.rules[i]
        pred = parent.ruleset.rules[i]
        h.update(json.dumps(
            [rc.name, rc.namespace, pred.namespace, rc.match,
             [[a.handler, list(a.instances)] for a in rc.actions]],
            sort_keys=True, separators=(",", ":")).encode("utf-8"))
        for a in rc.actions:
            ref_handlers.add(a.handler)
            ref_instances.update(a.instances)
    for name in sorted(ref_handlers):
        hc = parent.handlers.get(name)
        sig = hc.signature if hc is not None else "<missing>"
        h.update(f"H|{name}|{sig}".encode("utf-8"))
    for name in sorted(ref_instances):
        dig = parent.instance_digests.get(name, "<missing>")
        h.update(f"I|{name}|{dig}".encode("utf-8"))
    return h.hexdigest()


def rebind_bank(bank: ShardBank, plan: ShardPlan, k: int) -> ShardBank:
    """Carry a content-matched bank into a new generation's plan:
    the compiled artifact (sub-snapshot, dispatcher, warmed shapes,
    breaker, telemetry accumulators) is equivalent by key, but the
    PARENT-side bookkeeping is not — global rule indices renumber
    under deltas elsewhere in the config, so the local→global map is
    rebuilt from the new plan (the bank's local rule order is
    ascending global order in both generations, and a matching
    content key pins the two sequences element-for-element).

    NOTE for banks that are LIVE on a serving generation:
    `local_to_global` is read by in-flight folds, so the server's
    rebuild path carries a shallow copy instead
    (RuntimeServer._rebuild_sharded) — this convenience helper applies
    everything in place and is meant for banks not currently serving
    (tests, offline tools)."""
    bank.shard_id = k
    bank.local_to_global = np.asarray(plan.shard_rules[k], np.int64)
    bank.predicted_cost = float(plan.shard_cost[k]) \
        if plan.shard_cost else 0.0
    return bank


def shard_snapshot(parent: Snapshot, plan: ShardPlan,
                   k: int) -> tuple[Snapshot, np.ndarray]:
    """Compile shard k's sub-Snapshot → (snapshot, local_to_global).

    Shares the parent's finder/handlers/instances and — critically —
    its InternTable, so every bank agrees on constant ids and a bag
    tensorizes identically no matter which bank serves it. The rule
    list keeps ascending global order, so lowest-rule-index-wins
    status combining inside a bank equals the monolithic order
    restricted to the request's visible set. The bank's ruleset lives
    on the parent ruleset's device."""
    if parent.n_config_rules != len(parent.ruleset.rules):
        raise ShardingUnsupported(
            "snapshot carries synthesized pseudo-rule rows (device-"
            "lowered rbac) that reference absolute ruleset positions; "
            "sharding such a snapshot would renumber them — serve it "
            "monolithically")
    idxs = plan.shard_rules[k]
    preds = [parent.ruleset.rules[i] for i in idxs]
    rules = [parent.rules[i] for i in idxs]
    interner = parent.ruleset.interner
    ruleset = compile_ruleset(preds, parent.finder, interner=interner,
                              device=parent.ruleset.device,
                              **parent.compile_kwargs)
    sub = Snapshot(
        revision=parent.revision, finder=parent.finder,
        handlers=parent.handlers, instances=parent.instances,
        instance_templates=parent.instance_templates,
        rules=rules, ruleset=ruleset,
        tensorizer=Tensorizer(ruleset.layout, interner),
        roles=[], bindings=[], errors=[],
        n_config_rules=len(rules), rbac_groups={},
        compile_kwargs=dict(parent.compile_kwargs))
    return sub, np.asarray(idxs, np.int64)


def compile_shard_bank(parent: Snapshot, handlers: Mapping[str, Any],
                       plan: ShardPlan, k: int, *,
                       identity_attr: str,
                       buckets: Sequence[int] = (),
                       rule_telemetry: bool = True,
                       recorder: Any = None,
                       executor: Any = None,
                       grants: Any = None,
                       overlap_h2d: bool = False) -> ShardBank:
    """Compile ONE shard of `plan` into a ShardBank — the unit the
    delta-compilation path pays per CHANGED shard (unchanged shards
    carry their previous bank instead). `executor`: the server's
    AdapterExecutor — host-overlay rules pinned to this bank run their
    adapter work on its lanes like the monolithic path (lanes are per
    HANDLER, shared across banks: the backend behind a handler is one
    resource however many banks call it). `grants`: the GrantPolicy,
    per bank like the monolithic dispatcher. `overlap_h2d=True` raises
    NotPorted (the Dispatcher's)."""
    from istio_tpu_torch.runtime.fused import build_fused_plan

    sub, l2g = shard_snapshot(parent, plan, k)
    fused = build_fused_plan(sub, rule_telemetry=rule_telemetry)
    disp = Dispatcher(sub, handlers, identity_attr,
                      fused=fused, buckets=tuple(buckets),
                      recorder=recorder, executor=executor,
                      grants=grants, overlap_h2d=overlap_h2d)
    cost = float(plan.shard_cost[k]) if plan.shard_cost else 0.0
    return ShardBank(shard_id=k, snapshot=sub, dispatcher=disp,
                     local_to_global=l2g, predicted_cost=cost,
                     built_revision=parent.revision)


def build_shard_banks(parent: Snapshot,
                      handlers: Mapping[str, Any],
                      plan: ShardPlan, *,
                      identity_attr: str,
                      buckets: Sequence[int] = (),
                      rule_telemetry: bool = True,
                      recorder: Any = None,
                      executor: Any = None,
                      grants: Any = None,
                      overlap_h2d: bool = False) -> list[ShardBank]:
    """Compile every shard of `plan` into a ShardBank. Raises
    ShardingUnsupported when the snapshot cannot shard; individual
    bad rules never fail a bank (compile_ruleset demotes them to the
    bank's host-fallback oracle, same as monolithic)."""
    banks = [compile_shard_bank(parent, handlers, plan, k,
                                identity_attr=identity_attr,
                                buckets=buckets,
                                rule_telemetry=rule_telemetry,
                                recorder=recorder,
                                executor=executor,
                                grants=grants,
                                overlap_h2d=overlap_h2d)
             for k in range(plan.n_shards)]
    log.info("built %d shard banks (%s rules/bank, %d global rules "
             "replicated)", len(banks),
             "/".join(str(b.n_rules) for b in banks),
             len(plan.global_rules))
    return banks


def full_bank(parent: Snapshot, handlers: Mapping[str, Any],
              shard_id: int, *, identity_attr: str,
              buckets: Sequence[int] = (),
              rule_telemetry: bool = True,
              recorder: Any = None,
              dispatcher: Dispatcher | None = None,
              executor: Any = None,
              grants: Any = None,
              overlap_h2d: bool = False) -> ShardBank:
    """A bank over the WHOLE snapshot — the replica-only mode's lane
    executor (each replica owns its own FusedPlan over the full rule
    set). `dispatcher` reuses an existing one (lane 0 rides the
    controller's published dispatcher; other lanes build their own
    plan)."""
    from istio_tpu_torch.runtime.fused import build_fused_plan

    if dispatcher is None:
        fused = build_fused_plan(parent,
                                 rule_telemetry=rule_telemetry)
        dispatcher = Dispatcher(parent, handlers, identity_attr,
                                fused=fused, buckets=tuple(buckets),
                                recorder=recorder, executor=executor,
                                grants=grants,
                                overlap_h2d=overlap_h2d)
    return ShardBank(
        shard_id=shard_id, snapshot=parent, dispatcher=dispatcher,
        local_to_global=np.arange(len(parent.rules), dtype=np.int64),
        built_revision=parent.revision)
