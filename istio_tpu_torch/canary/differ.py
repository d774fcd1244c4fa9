"""Divergence classification over (recorded, replayed) decision pairs.

Port of istio_tpu/canary/differ.py. Three divergence kinds, mirroring the decision surface the recorder
captures:

  status_flip   — the google.rpc status code changed (OK→deny,
                  deny→OK, or a different non-OK code);
  precondition  — same status, but the TTL / use-count budget the
                  client may cache the verdict under changed;
  quota         — the set of active QUOTA-variety rules changed (a
                  quota rule newly gating, or silently dropping out).

Divergences aggregate per qualified rule name (the rulestats naming),
with bounded reservoir exemplars carrying the replayable compressed
bag + the recorded trace id. `confirm_exemplars` re-evaluates exemplar
bags through BOTH snapshots' CPU oracles (compiler/ruleset.SnapshotOracle
+ fused_check_status) so a reported flip is independently confirmed
off the device.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Iterable, Sequence

from istio_tpu_torch.canary.recorder import CanaryEntry, _ca_to_json
from istio_tpu_torch.canary.replay import ReplayResult

UNATTRIBUTED = "(unattributed)"


@dataclasses.dataclass
class Divergence:
    kind: str                 # status_flip | precondition | quota
    rule: str                 # attributed qualified rule name
    entry_index: int
    recorded: dict
    replayed: dict


@dataclasses.dataclass
class CanaryReport:
    """JSON-able diff report for one candidate replay."""
    n_rows: int = 0
    n_divergent: int = 0              # non-waived divergent rows
    n_waived: int = 0
    by_kind: dict = dataclasses.field(default_factory=dict)
    # rule name → {"total", "status_flip", "precondition", "quota",
    #              "waived", "exemplars": [...]}
    per_rule: dict = dataclasses.field(default_factory=dict)
    divergence_rate: float = 0.0      # non-waived rows / replayed rows
    replay_rows_per_s: float = 0.0
    replay_wall_s: float = 0.0
    candidate_revision: int | None = None
    # filled by the gate
    mode: str = ""
    verdict: str = ""                 # publish | warn | veto
    threshold: float = 0.0
    waivers: tuple = ()
    # the reference's /debug/canary fills it with the diverging rules
    # its static analyzer also flags (neither is ported: stays empty)
    analyzer_overlap: list = dataclasses.field(default_factory=list)
    note: str = ""

    def diverging_rules(self) -> list[str]:
        """Non-waived diverging rule names, worst-first."""
        ranked = sorted(
            ((name, c) for name, c in self.per_rule.items()
             if not c.get("waived")),
            key=lambda kv: (-kv[1]["total"], kv[0]))
        return [name for name, _ in ranked]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# exemplar attribute rendering is shared with the rule-stats exemplars —
# one contract, one helper (runtime/rulestats.preview_attributes)
from istio_tpu_torch.runtime.rulestats import preview_attributes  # noqa: E402


def diff_decisions(entries: Sequence[CanaryEntry], replay: ReplayResult,
                   waivers: Iterable[str] = (),
                   exemplars_per_rule: int = 4,
                   seed: int = 0) -> CanaryReport:
    """Classify per-row divergence between recorded and replayed
    decisions → CanaryReport. `waivers` are qualified rule names whose
    divergences are reported but excluded from the gating rate (the
    operator's "yes, this rule is SUPPOSED to change" escape hatch)."""
    if len(entries) != replay.n_rows:
        raise ValueError(f"corpus/replay row mismatch: {len(entries)} "
                         f"entries vs {replay.n_rows} replayed")
    waived = frozenset(waivers)
    rng = random.Random(seed)
    rep = CanaryReport(n_rows=len(entries),
                       replay_rows_per_s=round(replay.rows_per_s, 1),
                       replay_wall_s=replay.wall_s,
                       waivers=tuple(sorted(waived)))
    seen_per_rule: dict[str, int] = {}
    for i, e in enumerate(entries):
        r_status = replay.status[i]
        r_dur = replay.valid_duration_s[i]
        r_uses = replay.valid_use_count[i]
        r_deny = replay.deny_rule[i]
        r_quota = replay.quota_rules[i]
        kind = None
        rule = UNATTRIBUTED
        if r_status != e.status:
            kind = "status_flip"
            # attribute to the side that denies: the candidate's deny
            # rule when it answers non-OK, else the rule whose recorded
            # deny the candidate no longer produces
            rule = (r_deny if r_status != 0 and r_deny else
                    e.deny_rule or r_deny or UNATTRIBUTED)
        elif abs(r_dur - e.valid_duration_s) > 1e-6 or \
                r_uses != e.valid_use_count:
            kind = "precondition"
            rule = r_deny or e.deny_rule or UNATTRIBUTED
        elif frozenset(r_quota) != frozenset(e.quota_rules):
            kind = "quota"
            delta = sorted(frozenset(r_quota) ^
                           frozenset(e.quota_rules))
            rule = delta[0] if delta else UNATTRIBUTED
        if kind is None:
            continue
        is_waived = rule in waived
        if is_waived:
            rep.n_waived += 1
        else:
            rep.n_divergent += 1
            rep.by_kind[kind] = rep.by_kind.get(kind, 0) + 1
        c = rep.per_rule.setdefault(rule, {
            "total": 0, "status_flip": 0, "precondition": 0,
            "quota": 0, "waived": is_waived, "exemplars": []})
        c["total"] += 1
        c[kind] += 1
        seen = seen_per_rule.get(rule, 0) + 1
        seen_per_rule[rule] = seen
        # reservoir slot FIRST: a candidate flipping every replayed
        # row must not decode+re-encode every bag just to keep K
        # exemplars — exemplar construction is O(kept), not O(rows)
        bucket = c["exemplars"]
        slot = len(bucket) if len(bucket) < exemplars_per_rule \
            else rng.randrange(seen)
        if slot >= exemplars_per_rule:
            continue
        ex = {
            "kind": kind,
            "entry_index": i,
            "attributes": preview_attributes(e.bag()),
            "trace_id": e.trace_id,
            "recorded": {"status": e.status,
                         "valid_duration_s": e.valid_duration_s,
                         "valid_use_count": e.valid_use_count,
                         "deny_rule": e.deny_rule,
                         "quota_rules": list(e.quota_rules)},
            "replayed": {"status": r_status,
                         "valid_duration_s": r_dur,
                         "valid_use_count": r_uses,
                         "deny_rule": r_deny,
                         "quota_rules": list(r_quota)},
            # the replayable bag itself: an offline replay can re-run
            # exactly this request against any candidate
            "bag": _ca_to_json(e.ca),
        }
        if slot == len(bucket):
            bucket.append(ex)
        else:
            bucket[slot] = ex
    n = max(rep.n_rows, 1)
    rep.divergence_rate = round(rep.n_divergent / n, 6)
    return rep


# ---------------------------------------------------------------------------
# oracle re-evaluation (exemplar confirmation)
# ---------------------------------------------------------------------------

def oracle_decision(snapshot: Any, plan: Any, bag: Any,
                    identity_attr: str = "destination.service"
                    ) -> tuple[int, str]:
    """(status_code, winning qualified rule name) for one bag, derived
    entirely on CPU: SnapshotOracle rule resolution in device combine
    order (lowest rule index wins) + `fused_check_status` per active
    rule. Independent of the device path being judged — the
    confirmation bar for canary exemplars."""
    from istio_tpu_torch.compiler.ruleset import (SnapshotOracle,
                                                  fused_check_status)
    from istio_tpu_torch.runtime.dispatcher import _namespace_of

    rs = snapshot.ruleset
    n_cfg = len(snapshot.rules)
    oracle = getattr(snapshot, "_canary_oracle", None)
    if oracle is None:
        oracle = SnapshotOracle(
            rs.rules[:n_cfg], snapshot.finder,
            seed={r: p for r, p in rs.host_fallback.items()
                  if r < n_cfg})
        snapshot._canary_oracle = oracle
    names = snapshot.qualified_rule_names()
    req_ns = _namespace_of(bag, identity_attr)
    active, _visible, _errs = oracle.resolve(bag, req_ns)
    for ridx in active:
        st = fused_check_status(snapshot, plan, ridx, bag)
        if st != 0:
            return st, names[ridx] if ridx < len(names) else ""
    return 0, ""


def confirm_exemplars(report: CanaryReport,
                      base_snapshot: Any, base_plan: Any,
                      cand_snapshot: Any, cand_plan: Any,
                      identity_attr: str = "destination.service"
                      ) -> None:
    """Mark every status-flip exemplar with `oracle_confirmed`: the
    recorded status re-derives from the BASE snapshot's oracle and the
    replayed status from the CANDIDATE's — both off-device. A
    confirmed exemplar proves the flip is a semantic config change,
    not device noise. Mutates the report in place."""
    from istio_tpu_torch.attribute.compressed import decode
    from istio_tpu_torch.canary.recorder import _ca_from_json

    for c in report.per_rule.values():
        for ex in c["exemplars"]:
            if ex.get("kind") != "status_flip":
                continue
            try:
                bag = decode(_ca_from_json(ex["bag"]))
                base_st, _ = oracle_decision(base_snapshot, base_plan,
                                             bag, identity_attr)
                cand_st, _ = oracle_decision(cand_snapshot, cand_plan,
                                             bag, identity_attr)
            except Exception as exc:
                ex["oracle_confirmed"] = False
                ex["oracle_error"] = f"{type(exc).__name__}: {exc}"
                continue
            ex["oracle_confirmed"] = (
                base_st == ex["recorded"]["status"]
                and cand_st == ex["replayed"]["status"])
            ex["oracle_status"] = {"base": base_st,
                                   "candidate": cand_st}
