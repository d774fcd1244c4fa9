"""Cross-plane consistency: Pilot route matchers vs Mixer predicates.

Port of istio_tpu/analysis/planes.py.

The shared-automaton north star compiles ONE source of truth (a route
rule's match block) into two consumers: Pilot's `pilot/route_nfa`
RouteTable and the Mixer-side policy predicates embedded in a ruleset
(e.g. `testing/workloads.make_full_mesh`'s route rows). A divergence —
a tampered predicate, a stale recompile, a lowering change on one side
only — silently answers routing and policy from DIFFERENT languages
under live traffic. This pass proves pairs equivalent where it can
(mutual DNF implication over the shared atom semantics) and otherwise
hunts for a DIFFERENTIAL WITNESS: a request on which the two planes'
oracles disagree. A reported divergence always carries that witness.
"""
from __future__ import annotations

from typing import Any, Sequence

from istio_tpu_torch.analysis.findings import (Finding, PLANE_DIVERGENCE,
                                         PLANE_UNPROVEN, Severity)
from istio_tpu_torch.analysis.reach import RuleUniverse
from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder, TypeError_)
from istio_tpu_torch.expr.exprs import Expression
from istio_tpu_torch.expr.oracle import OracleProgram
from istio_tpu_torch.expr.parser import ParseError, parse


def _to_ast(pred: "str | Expression") -> Expression:
    if isinstance(pred, Expression):
        return pred
    return parse(pred or "true")


def _verdict(ast: Expression, finder: AttributeDescriptorFinder,
             bag: dict[str, Any]) -> "bool | str":
    """True / False / 'error' under the oracle semantics."""
    try:
        return bool(OracleProgram.from_ast(ast, finder)
                    .evaluate(DictBag(bag)))
    except Exception:
        return "error"


def check_plane_pairs(pairs: Sequence[tuple[str, Any, Any]],
                      finder: AttributeDescriptorFinder,
                      *, max_samples: int = 8,
                      warn_unproven: bool = True) -> list[Finding]:
    """`pairs`: (name, pilot predicate, mixer predicate) — text or AST.
    Emits PLANE_DIVERGENCE (ERROR, witness-confirmed) when the two
    disagree on a concrete request, PLANE_UNPROVEN (WARNING) when
    equivalence can be neither proved nor refuted."""
    findings: list[Finding] = []
    for name, pilot, mixer in pairs:
        if isinstance(pilot, str) and isinstance(mixer, str) \
                and pilot.strip() == mixer.strip():
            continue
        try:
            past, mast = _to_ast(pilot), _to_ast(mixer)
        except (ParseError, TypeError_) as exc:
            findings.append(Finding(
                code=PLANE_DIVERGENCE, severity=Severity.ERROR,
                message=f"route {name!r}: plane predicate does not "
                        f"parse: {exc}",
                rules=(name,)))
            continue
        if str(past) == str(mast):
            continue
        uni = RuleUniverse([(f"{name}/pilot", "", past),
                            (f"{name}/mixer", "", mast)], finder)
        if uni.shadows(0, 1) and uni.shadows(1, 0):
            continue                       # proved language-equivalent
        witness = _hunt_divergence(uni, past, mast, finder,
                                   max_samples)
        if witness is not None:
            bag, vp, vm = witness
            findings.append(Finding(
                code=PLANE_DIVERGENCE, severity=Severity.ERROR,
                message=(f"route {name!r}: pilot and mixer planes "
                         f"disagree on the witness request (pilot="
                         f"{vp}, mixer={vm})"),
                rules=(name,), witness=bag, confirmed=True))
        elif warn_unproven:
            findings.append(Finding(
                code=PLANE_UNPROVEN, severity=Severity.WARNING,
                message=(f"route {name!r}: pilot and mixer predicates "
                         f"differ and equivalence could not be proved "
                         f"(opaque atoms or budget)"),
                rules=(name,)))
    return findings


def _hunt_divergence(uni: RuleUniverse, past: Expression,
                     mast: Expression,
                     finder: AttributeDescriptorFinder,
                     max_samples: int
                     ) -> tuple[dict, Any, Any] | None:
    """Probe bags drawn from BOTH sides' accepting conjunctions (each
    side's witnesses are exactly the inputs most likely to expose a
    one-sided match), plus the empty bag."""
    probes: list[dict] = [{}]
    for pred in uni.preds:
        if pred.m_dnf is None:
            continue
        for conj in pred.m_dnf[:max_samples]:
            bag = uni.witness_for([conj])
            if bag is not None:
                probes.append(bag)
    seen: set[str] = set()
    for bag in probes[: 2 * max_samples + 1]:
        key = repr(sorted(bag.items(), key=str))
        if key in seen:
            continue
        seen.add(key)
        vp = _verdict(past, finder, bag)
        vm = _verdict(mast, finder, bag)
        if vp != vm and (vp is True or vm is True):
            return bag, vp, vm
    return None
