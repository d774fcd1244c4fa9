"""Rule reachability, shadowing and ALLOW/DENY conflict analysis.

Port of istio_tpu/analysis/reach.py.

Batfish-style reasoning specialized to the mesh's predicate language:
every rule's match clause decomposes into the compiler's own monotone
M/N DNFs over primitive atoms (`compiler/ruleset._decompose` — the
exact structure the device executes), and pairwise claims reduce to
conjunction-level implication / disjointness over `analysis/atoms`
semantics, with regex/prefix/glob literals decided by product-DFA
construction on `ops/regex_dfa` transition tensors.

Soundness contract: a SHADOW claim is proof-based (DNF implication —
universally quantified) plus a non-vacuity witness; an OVERLAP claim
(allow/deny conflict) is witness-based only — a candidate pair that
cannot produce a bag on which BOTH predicates oracle-evaluate True is
never reported. False positives are structurally excluded; missed
findings (opaque atoms, budget exhaustion) are the accepted trade.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from istio_tpu_torch.analysis import atoms as A
from istio_tpu_torch.analysis.findings import (ALLOW_DENY_CONFLICT,
                                         ANALYSIS_TRUNCATED, Finding,
                                         NON_TOTAL, SHADOWED_ROUTE,
                                         SHADOWED_RULE, Severity)
from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.compiler.ruleset import (DEFAULT_DNF_CAP, _AtomTable,
                                        _decompose)
from istio_tpu_torch.compiler.tensor_expr import HostFallback
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.exprs import Expression
from istio_tpu_torch.expr.oracle import OracleProgram

DEFAULT_PAIR_CHECK_BUDGET = 250_000
IDENTITY_ATTR = "destination.service"


@dataclasses.dataclass
class PredInfo:
    """One rule's analyzable form."""
    index: int
    name: str
    namespace: str
    ast: Expression
    m_dnf: list[list[tuple[int, str]]] | None   # None = not decomposable
    # fast pruning map per conjunction: positive-eq subject → value
    eq_maps: list[dict] | None = None


class RuleUniverse:
    """Shared decomposition + atom semantics for a rule list."""

    def __init__(self, rules: Sequence[tuple[str, str, Expression]],
                 finder: AttributeDescriptorFinder,
                 dnf_cap: int = DEFAULT_DNF_CAP):
        self.finder = finder
        self.table = _AtomTable()
        self.preds: list[PredInfo] = []
        self._sem_cache: dict[tuple[int, str], A.AtomSem] = {}
        self._impl_cache: dict[tuple, bool | None] = {}
        self._disj_cache: dict[tuple, bool | None] = {}
        for idx, (name, ns, ast) in enumerate(rules):
            try:
                mark = self.table.mark()
                m, _n = _decompose(ast, self.table, dnf_cap)
                m_dnf = [sorted(conj) for conj in m]
            except HostFallback:
                self.table.revert(mark)
                m_dnf = None
            info = PredInfo(index=idx, name=name, namespace=ns,
                            ast=ast, m_dnf=m_dnf)
            if m_dnf is not None:
                info.eq_maps = [self._eq_map(conj) for conj in m_dnf]
            self.preds.append(info)

    # -- atom-level, memoized --

    def sem(self, lit: tuple[int, str]) -> A.AtomSem:
        cached = self._sem_cache.get(lit)
        if cached is None:
            aidx, kind = lit
            cached = A.atom_sem(self.table.asts[aidx], self.finder)
            if kind == "n":
                cached = A.negate(cached)
            self._sem_cache[lit] = cached
        return cached

    def _eq_map(self, conj) -> dict:
        out = {}
        for lit in conj:
            sem = self.sem(lit)
            if sem.kind == "eq" and not sem.negated \
                    and sem.subject is not None:
                out[sem.subject.id] = sem.value
        return out

    def _lit_implies(self, la, lb) -> bool | None:
        if la == lb:
            return True
        key = (la, lb)
        if key not in self._impl_cache:
            self._impl_cache[key] = A.atom_implies(self.sem(la),
                                                   self.sem(lb))
        return self._impl_cache[key]

    def _lit_disjoint(self, la, lb) -> bool | None:
        key = (min(la, lb), max(la, lb))
        if key not in self._disj_cache:
            self._disj_cache[key] = A.atoms_disjoint(self.sem(la),
                                                     self.sem(lb))
        return self._disj_cache[key]

    # -- conjunction-level --

    def conj_implies(self, ca, cb) -> bool:
        """Proved: every input satisfying ca satisfies cb."""
        for lb in cb:
            if not any(self._lit_implies(la, lb) is True for la in ca):
                return False
        return True

    def conj_disjoint(self, ca, cb) -> bool:
        """Proved: no input satisfies both."""
        for la in ca:
            for lb in cb:
                if self._lit_disjoint(la, lb) is True:
                    return True
        return False

    # -- rule-level --

    def shadows(self, i: int, j: int) -> bool:
        """Proved: every input matching rule j also matches rule i
        (predicate inclusion; namespace visibility checked by caller)."""
        pi, pj = self.preds[i], self.preds[j]
        if pi.m_dnf is None or pj.m_dnf is None or not pj.m_dnf:
            return False
        for cj in pj.m_dnf:
            if not any(self.conj_implies(cj, ci) for ci in pi.m_dnf):
                return False
        return True

    def overlap_candidates(self, i: int, j: int):
        """Conjunction pairs not provably disjoint, cheapest-first —
        witness construction order for overlap confirmation."""
        pi, pj = self.preds[i], self.preds[j]
        if pi.m_dnf is None or pj.m_dnf is None:
            return
        for a, ci in enumerate(pi.m_dnf):
            for b, cj in enumerate(pj.m_dnf):
                em_i, em_j = pi.eq_maps[a], pj.eq_maps[b]
                if any(em_j.get(k, v) != v for k, v in em_i.items()):
                    continue              # eq constants clash
                if self.conj_disjoint(ci, cj):
                    continue
                yield ci, cj

    # -- witnesses --

    def witness_for(self, conjs: Sequence[Sequence[tuple[int, str]]]
                    ) -> dict[str, Any] | None:
        """Attribute bag satisfying the UNION of the conjunctions, or
        None (unsat / unknown)."""
        sems = [self.sem(lit) for conj in conjs for lit in conj]
        try:
            return A.solve_subjects(sems, self.finder)
        except (A.WitnessUnsat, A.WitnessUnknown):
            return None

    def confirm(self, bag: dict[str, Any], *indices: int) -> bool:
        """Oracle replay: every listed rule's predicate evaluates True
        on the bag AND every rule is namespace-visible to the request
        the bag describes. The final soundness filter before a finding
        ships."""
        ns = _request_ns(bag)
        for idx in indices:
            p = self.preds[idx]
            if p.namespace and p.namespace != ns:
                return False
            try:
                if OracleProgram.from_ast(
                        p.ast, self.finder).evaluate(DictBag(bag)) \
                        is not True:
                    return False
            except Exception:
                return False
        return True

    def pin_namespace(self, bag: dict[str, Any],
                      i: int, j: int) -> dict[str, Any] | None:
        """Make the request's namespace compatible with both rules: if
        neither predicate pinned the identity attribute, synthesize
        one addressed to the (single) non-default namespace."""
        ns_i, ns_j = self.preds[i].namespace, self.preds[j].namespace
        specific = {ns for ns in (ns_i, ns_j) if ns}
        if len(specific) > 1 and ns_i != ns_j:
            return None
        if IDENTITY_ATTR in bag:
            return bag
        if specific:
            ns = next(iter(specific))
            bag = dict(bag)
            bag[IDENTITY_ATTR] = f"analyzer.{ns}.svc.cluster.local"
        return bag


def _request_ns(bag: dict[str, Any]) -> str:
    v = bag.get(IDENTITY_ATTR)
    if not isinstance(v, str):
        return ""
    parts = v.split(".")
    return parts[1] if len(parts) >= 2 and parts[1] else ""


def _ns_covers(ns_i: str, ns_j: str) -> bool:
    """Rule i visible whenever rule j is."""
    return ns_i == "" or ns_i == ns_j


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def find_shadowed(uni: RuleUniverse,
                  eligible: Callable[[int, int], bool],
                  *, code: str = SHADOWED_RULE,
                  weight: Sequence[int] | None = None,
                  pair_budget: int = DEFAULT_PAIR_CHECK_BUDGET
                  ) -> tuple[list[Finding], bool]:
    """Rules fully covered by another rule.

    `eligible(i, j)` gates which ordered pairs are semantically
    shadow-capable (same deny action, earlier config order, ...);
    `weight` switches to route semantics: i shadows j only when
    weight[i] > weight[j] (higher-precedence rule always wins).
    Returns (findings, truncated)."""
    out: list[Finding] = []
    checked = 0
    truncated = False
    n = len(uni.preds)
    shadowed: set[int] = set()
    for j in range(n):
        if uni.preds[j].m_dnf is None:
            continue
        for i in range(n):
            if i == j or j in shadowed:
                continue
            if weight is not None and weight[i] <= weight[j]:
                continue
            if weight is None and i > j:
                continue     # report against the earlier rule only
            if not _ns_covers(uni.preds[i].namespace,
                              uni.preds[j].namespace):
                continue
            if not eligible(i, j):
                continue
            checked += 1
            if checked > pair_budget:
                truncated = True
                break
            if not uni.shadows(i, j):
                continue
            # non-vacuity witness: a bag rule j actually matches
            # (and therefore rule i matches too)
            bag = None
            for cj in uni.preds[j].m_dnf:
                bag = uni.witness_for([cj])
                if bag is None:
                    continue
                bag = uni.pin_namespace(bag, i, j)
                if bag is not None and uni.confirm(bag, i, j):
                    break
                bag = None
            if bag is None:
                continue          # unsat/unknown: withhold the claim
            pi, pj = uni.preds[i], uni.preds[j]
            out.append(Finding(
                code=code, severity=Severity.ERROR,
                message=(f"rule {pj.name!r} is fully shadowed by "
                         f"{pi.name!r}: every request it matches "
                         f"already matches the covering rule"),
                rules=(pi.name, pj.name), witness=bag, confirmed=True))
            shadowed.add(j)
        if truncated:
            break
    return out, truncated


def find_conflicts(uni: RuleUniverse,
                   deny_idx: Sequence[int], allow_idx: Sequence[int],
                   *, pair_budget: int = DEFAULT_PAIR_CHECK_BUDGET
                   ) -> tuple[list[Finding], bool]:
    """ALLOW/DENY overlaps: a deny rule and an allow(list) rule that
    can match the SAME request — the allow verdict is unreachable for
    the overlap (deny always wins in combineResults), which is policy
    wrong by construction. Witness-confirmed only."""
    out: list[Finding] = []
    checked = 0
    truncated = False
    for d in deny_idx:
        for a in allow_idx:
            if d == a:
                continue     # one rule carrying both is explicit config
            ns_d = uni.preds[d].namespace
            ns_a = uni.preds[a].namespace
            if ns_d and ns_a and ns_d != ns_a:
                continue     # never visible together
            found = False
            for cd, ca in uni.overlap_candidates(d, a):
                checked += 1
                if checked > pair_budget:
                    truncated = True
                    break
                bag = uni.witness_for([cd, ca])
                if bag is None:
                    continue
                bag = uni.pin_namespace(bag, d, a)
                if bag is None or not uni.confirm(bag, d, a):
                    continue
                pd, pa = uni.preds[d], uni.preds[a]
                out.append(Finding(
                    code=ALLOW_DENY_CONFLICT, severity=Severity.ERROR,
                    message=(f"deny rule {pd.name!r} and allow rule "
                             f"{pa.name!r} both match the witness "
                             f"request: the allow verdict is dead for "
                             f"the overlap"),
                    rules=(pd.name, pa.name), witness=bag,
                    confirmed=True))
                found = True
                break
            if found or truncated:
                break
        if truncated:
            break
    if truncated:
        out.append(Finding(
            code=ANALYSIS_TRUNCATED, severity=Severity.INFO,
            message=f"conflict analysis stopped after {checked} "
                    f"conjunction pairs (budget)"))
    return out, truncated


# ---------------------------------------------------------------------------
# totality
# ---------------------------------------------------------------------------

def _hard_refs(e: Expression, soft: bool, out: set) -> None:
    """Attribute references evaluated in HARD context (absence is a
    runtime error, not a fallback) — mirrors oracle.py's nmJmpOnValue
    reach: soft mode covers only Var / INDEX / nested-OR shapes."""
    if e.var is not None:
        if not soft:
            out.add(e.var.name)
        return
    f = e.fn
    if f is None:
        return
    if f.name == "OR":
        _hard_refs(f.args[0], True, out)
        _hard_refs(f.args[1], soft, out)
        return
    if f.name == "INDEX":
        _hard_refs(f.args[0], soft, out)
        _hard_refs(f.args[1], False, out)
        return
    if f.name in ("LAND", "LOR"):
        # short-circuit CAN mask right-side errors, but only data-
        # dependently; left side is always evaluated
        _hard_refs(f.args[0], False, out)
        for arg in f.args[1:]:
            _hard_refs(arg, False, out)
        return
    if f.target is not None:
        _hard_refs(f.target, False, out)
    for a in f.args:
        _hard_refs(a, False, out)


def find_non_total(rules: Sequence[tuple[str, str, Expression]],
                   finder: AttributeDescriptorFinder) -> list[Finding]:
    """Predicates that can evaluate to ERROR at runtime (an absent
    attribute read in hard context). Advisory: the runtime counts these
    as resolve errors, not matches — but a predicate that is total by
    construction (`(attr | default) == ...`) never burns an error
    budget. Confirmed by oracle replay on the empty bag."""
    out: list[Finding] = []
    for name, _ns, ast in rules:
        refs: set = set()
        _hard_refs(ast, False, refs)
        if not refs:
            continue
        try:
            OracleProgram.from_ast(ast, finder).evaluate(DictBag({}))
            continue          # evaluated fine: masked by short-circuit
        except Exception:
            pass
        out.append(Finding(
            code=NON_TOTAL, severity=Severity.INFO,
            message=(f"rule {name!r} errors when "
                     f"{sorted(refs)} are absent (no `|` fallback)"),
            rules=(name,), witness={}, confirmed=True))
    return out


__all__ = ["RuleUniverse", "find_shadowed", "find_conflicts",
           "find_non_total", "SHADOWED_ROUTE", "DEFAULT_PAIR_CHECK_BUDGET"]
