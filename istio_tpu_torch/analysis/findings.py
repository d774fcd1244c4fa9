"""Structured findings — the analyzer's output contract.

Port of istio_tpu/analysis/findings.py.

Every check in istio_tpu/analysis emits Finding records so the three
consumers (the `analyze` CLI, the admission hook, the introspect
/debug/analysis view) and CI gates share one severity/shape vocabulary
instead of parsing prose. Network-config practice (Batfish answer
rows) is the model: a finding names WHAT is wrong (code), HOW bad
(severity), WHERE (rule ids), and — for semantic claims like overlap —
a concrete WITNESS input that reproduces it through the oracle.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping


class Severity(enum.IntEnum):
    """Ordered so gates can threshold (`sev >= WARNING`)."""
    INFO = 0       # advisory: host fallback, non-total predicate
    WARNING = 1    # degraded/suspicious but serveable config
    ERROR = 2      # wrong by construction: reject before device compile


# finding codes — single vocabulary across checks, tests and gates
TYPE_ERROR = "type-error"              # ill-typed / unknown attr / arity
NON_TOTAL = "non-total-predicate"      # can evaluate to error at runtime
SHADOWED_RULE = "shadowed-rule"        # fully covered by another rule
ALLOW_DENY_CONFLICT = "allow-deny-conflict"
SHADOWED_ROUTE = "shadowed-route"      # route row that can never win
STATE_BUDGET = "state-budget"          # regex DFA exceeds the state cap
DNF_BUDGET = "dnf-budget"              # predicate DNF past dnf_cap
TILE_BUDGET = "tile-budget"            # index tensors past device budget
BANK_BUDGET = "dfa-bank-budget"        # regex bank past one-hot tiers
PLANE_DIVERGENCE = "plane-divergence"  # pilot vs mixer disagree
PLANE_UNPROVEN = "plane-unproven"      # equivalence not established
HOST_FALLBACK = "host-fallback"        # rule serves via the CPU oracle
ANALYSIS_TRUNCATED = "analysis-truncated"
CONFIG_ERROR = "config-error"          # snapshot builder soft error


@dataclasses.dataclass
class Finding:
    """One analysis verdict.

    `witness` is an attribute-bag mapping (attr → value; string-map
    attrs map to dicts) that REPRODUCES the claim when replayed through
    expr/oracle.py — mandatory for overlap/divergence findings, set
    whenever derivable otherwise. `confirmed` records that the analyzer
    itself replayed the witness before reporting (candidate findings
    that fail replay are dropped, never reported)."""
    code: str
    severity: Severity
    message: str
    rules: tuple[str, ...] = ()
    witness: Mapping[str, Any] | None = None
    confirmed: bool = False

    def to_dict(self) -> dict:
        return {"code": self.code,
                "severity": self.severity.name,
                "message": self.message,
                "rules": list(self.rules),
                "witness": dict(self.witness)
                if self.witness is not None else None,
                "confirmed": self.confirmed}


@dataclasses.dataclass
class AnalysisReport:
    """A whole snapshot's findings plus the stats gates key on."""
    findings: list[Finding] = dataclasses.field(default_factory=list)
    n_rules: int = 0
    wall_ms: float = 0.0
    truncated: bool = False

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def by_severity(self, sev: Severity) -> list[Finding]:
        return [f for f in self.findings if f.severity == sev]

    @property
    def errors(self) -> list[Finding]:
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self) -> list[Finding]:
        return self.by_severity(Severity.WARNING)

    @property
    def has_errors(self) -> bool:
        return any(f.severity == Severity.ERROR for f in self.findings)

    def codes(self) -> set[str]:
        return {f.code for f in self.findings}

    def to_dict(self) -> dict:
        counts: dict[str, int] = {}
        for f in self.findings:
            counts[f.code] = counts.get(f.code, 0) + 1
        return {"n_rules": self.n_rules,
                "wall_ms": round(self.wall_ms, 3),
                "truncated": self.truncated,
                "n_errors": len(self.errors),
                "n_warnings": len(self.warnings),
                "counts_by_code": counts,
                "findings": [f.to_dict() for f in self.findings]}
