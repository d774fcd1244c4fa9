"""Semantic interpretation of predicate atoms for static reasoning.

Port of istio_tpu/analysis/atoms.py.

The ruleset compiler (`compiler/ruleset._decompose`) reduces every
predicate to monotone DNFs over primitive atoms; this module gives the
analyzer a DECISION layer over those atoms: when are two atoms
disjoint, when does one imply another, and how do you construct a
concrete attribute value satisfying one. String predicates
(matches/startsWith/endsWith/match-glob with constant patterns) all
normalize into the SAME dense byte DFAs the device executes
(`ops/regex_dfa`), so implication and disjointness between them are
product-DFA decisions (`analysis/dfa_ops`), Hyperscan-feasibility
style, not syntax comparisons.

Everything here is deliberately THREE-VALUED: `True` means proved,
`False` means disproved, `None` means unknown — callers must treat
unknown conservatively (no finding without a confirmed witness).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from istio_tpu_torch.analysis import dfa_ops
from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.exprs import Expression
from istio_tpu_torch.ops.regex_dfa import DFA, UnsupportedRegex, compile_regex

V = ValueType


def _escape_literal(s: str) -> str:
    """Literal string → regex matching exactly that string's bytes."""
    out = []
    for ch in s:
        if ch in ".*+?()[]{}|^$\\":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _compile_checked(pattern: str) -> DFA | None:
    try:
        return compile_regex(pattern)
    except (UnsupportedRegex, Exception):
        return None


@dataclasses.dataclass(frozen=True)
class Subject:
    """Where an atom reads its value from, as a witness-bag setter.

    kind 'var'  → scalar attribute `name`
    kind 'map'  → string-map attribute `name`, constant key `key`
    `default` is the fallback constant of a `(ref | "dflt")` probe
    (None = no probe: absence makes the atom error, not default)."""
    kind: str
    name: str
    key: str | None = None
    default: Any = None
    has_default: bool = False

    @property
    def id(self) -> tuple:
        return (self.kind, self.name, self.key)


def subject_of(e: Expression) -> Subject | None:
    """Resolve an operand expression to a settable Subject: a variable,
    INDEX(map, const), or a `(x | const)` fallback probe over either.
    None = not a shape the witness builder can control."""
    if e.var is not None:
        return Subject("var", e.var.name)
    f = e.fn
    if f is None:
        return None
    if f.name == "INDEX" and f.args[0].var is not None \
            and f.args[1].const_ is not None \
            and isinstance(f.args[1].const_.value, str):
        return Subject("map", f.args[0].var.name,
                       key=f.args[1].const_.value)
    if f.name == "OR" and len(f.args) == 2 \
            and f.args[1].const_ is not None:
        inner = subject_of(f.args[0])
        if inner is not None and not inner.has_default:
            return dataclasses.replace(inner,
                                       default=f.args[1].const_.value,
                                       has_default=True)
    return None


@dataclasses.dataclass
class AtomSem:
    """Decidable meaning of one atom (polarity already applied).

    kind 'eq'   — subject == value (negated: subject != value)
    kind 'str'  — subject's string is accepted by `dfa`
    kind 'eqv'  — subject == other subject (slot vs slot)
    kind 'opaque' — no static model; witness replay is the only filter
    """
    kind: str
    subject: Subject | None = None
    value: Any = None
    negated: bool = False
    dfa: DFA | None = None
    other: Subject | None = None
    source: str = ""          # str(atom ast), for diagnostics


def _const_value(e: Expression) -> tuple[bool, Any]:
    if e.const_ is not None:
        return True, e.const_.value
    return False, None


def atom_sem(ast: Expression,
             finder: AttributeDescriptorFinder) -> AtomSem:
    """Atom AST → AtomSem. Unknown shapes come back 'opaque' — sound
    because every consumer treats opaque as undecidable."""
    src = str(ast)
    if ast.var is not None and finder.get_attribute(ast.var.name) == V.BOOL:
        return AtomSem("eq", subject=Subject("var", ast.var.name),
                       value=True, source=src)
    f = ast.fn
    if f is None:
        return AtomSem("opaque", source=src)

    if f.name in ("EQ", "NEQ") and len(f.args) == 2:
        neg = f.name == "NEQ"
        for x, y in ((f.args[0], f.args[1]), (f.args[1], f.args[0])):
            subj = subject_of(x)
            if subj is None:
                continue
            is_const, val = _const_value(y)
            if is_const:
                return AtomSem("eq", subject=subj, value=val,
                               negated=neg, source=src)
        sa, sb = subject_of(f.args[0]), subject_of(f.args[1])
        if sa is not None and sb is not None:
            return AtomSem("eqv", subject=sa, other=sb, negated=neg,
                           source=src)
        return AtomSem("opaque", source=src)

    # constant-pattern string predicates → device DFA semantics
    pattern: str | None = None
    subj_expr: Expression | None = None
    if f.name == "matches" and f.target is not None \
            and f.target.const_ is not None:
        pattern = str(f.target.const_.value)      # unanchored search
        subj_expr = f.args[0]
    elif f.name in ("startsWith", "endsWith") and f.target is not None \
            and f.args and f.args[0].const_ is not None:
        lit = _escape_literal(str(f.args[0].const_.value))
        pattern = f"^{lit}" if f.name == "startsWith" else f"{lit}$"
        subj_expr = f.target
    elif f.name == "match" and len(f.args) == 2 \
            and f.args[1].const_ is not None:
        # externs.go glob: trailing '*' = prefix, leading '*' = suffix,
        # else exact (suffix-star checked first)
        g = str(f.args[1].const_.value)
        if g.endswith("*"):
            pattern = "^" + _escape_literal(g[:-1])
        elif g.startswith("*"):
            pattern = _escape_literal(g[1:]) + "$"
        else:
            pattern = "^" + _escape_literal(g) + "$"
        subj_expr = f.args[0]
    if pattern is not None and subj_expr is not None:
        subj = subject_of(subj_expr)
        dfa = _compile_checked(pattern)
        if subj is not None and dfa is not None:
            return AtomSem("str", subject=subj, dfa=dfa, source=src)
    return AtomSem("opaque", source=src)


def negate(sem: AtomSem) -> AtomSem:
    """The 'n'-literal meaning: atom definitely false (no error)."""
    if sem.kind in ("eq", "eqv"):
        return dataclasses.replace(sem, negated=not sem.negated)
    if sem.kind == "str":
        return dataclasses.replace(sem, dfa=dfa_ops.complement(sem.dfa))
    return dataclasses.replace(sem, negated=not sem.negated)


def _dfa_accepts(dfa: DFA, value: Any) -> bool | None:
    if not isinstance(value, str):
        return None
    from istio_tpu_torch.ops.regex_dfa import dfa_matches_host
    return dfa_matches_host(dfa, value.encode("utf-8"))


def atoms_disjoint(a: AtomSem, b: AtomSem, *,
                   pair_budget: int = dfa_ops.DEFAULT_PAIR_BUDGET
                   ) -> bool | None:
    """Can no input satisfy both? True = proved disjoint."""
    if a.kind == "opaque" or b.kind == "opaque":
        # opposite-polarity literals of the SAME atom never co-hold
        # (m = definitely-true, n = definitely-false)
        if a.kind == b.kind == "opaque" and a.source == b.source:
            return True if a.negated != b.negated else None
        return None
    if a.subject is None or b.subject is None \
            or a.subject.id != b.subject.id:
        return None
    if a.kind == "eq" and b.kind == "eq":
        if not a.negated and not b.negated:
            return a.value != b.value
        if a.negated != b.negated:
            return a.value == b.value
        return None                      # neq vs neq always overlap-ish
    if a.kind == "eq" and b.kind == "str":
        a, b = b, a
    if a.kind == "str" and b.kind == "eq":
        acc = _dfa_accepts(a.dfa, b.value)
        if acc is None:
            return None
        if not b.negated:
            return not acc
        return None                      # str ∧ (!= c): rarely empty
    if a.kind == "str" and b.kind == "str":
        return dfa_ops.languages_disjoint(a.dfa, b.dfa,
                                          pair_budget=pair_budget)
    return None


def atom_implies(a: AtomSem, b: AtomSem, *,
                 pair_budget: int = dfa_ops.DEFAULT_PAIR_BUDGET
                 ) -> bool | None:
    """Does every input satisfying `a` satisfy `b`? True = proved."""
    if a.kind == "opaque" or b.kind == "opaque":
        # identical source AND polarity only — the m- and n-literals
        # of one atom share a source but are mutually exclusive
        return True if (a.source == b.source
                        and a.negated == b.negated
                        and a.kind == b.kind) else None
    if a.kind == "eqv" or b.kind == "eqv":
        return (a.source == b.source and a.negated == b.negated
                and a.kind == b.kind) or None
    if a.subject is None or b.subject is None \
            or a.subject.id != b.subject.id:
        return None
    if a.kind == "eq" and not a.negated:
        if b.kind == "eq":
            if not b.negated:
                return a.value == b.value
            return a.value != b.value
        if b.kind == "str":
            return _dfa_accepts(b.dfa, a.value)
    if a.kind == "eq" and a.negated:
        if b.kind == "eq" and b.negated:
            return a.value == b.value
        return None
    if a.kind == "str":
        if b.kind == "str":
            return dfa_ops.language_includes(b.dfa, a.dfa,
                                             pair_budget=pair_budget)
        if b.kind == "eq" and b.negated:
            acc = _dfa_accepts(a.dfa, b.value)
            if acc is None:
                return None
            return not acc
    return None


# ---------------------------------------------------------------------------
# witness construction
# ---------------------------------------------------------------------------

class WitnessUnsat(Exception):
    """The constraint set provably has no satisfying assignment."""


class WitnessUnknown(Exception):
    """Couldn't construct an assignment (opaque atoms, exotic types)."""


_FRESH = "zz~w{n}"


def _fresh_value(vtype: ValueType | None, taken: set, n: int) -> Any:
    """A value of the subject's declared type distinct from `taken`."""
    for k in range(n, n + 64):
        if vtype in (None, V.STRING):
            v: Any = _FRESH.format(n=k)
        elif vtype == V.INT64:
            v = 10_000_019 + k
        elif vtype == V.DOUBLE:
            v = 10_000_019.5 + k
        elif vtype == V.BOOL:
            v = bool(k % 2)
        else:
            raise WitnessUnknown(f"no fresh generator for {vtype}")
        if v not in taken:
            return v
    raise WitnessUnknown("fresh-value space exhausted")


def solve_subjects(sems: list[AtomSem],
                   finder: AttributeDescriptorFinder) -> dict[str, Any]:
    """Constraint list (a conjunction of AtomSems) → attribute bag
    mapping satisfying it, or raise WitnessUnsat / WitnessUnknown.

    Per subject: at most one required eq value, a forbidden set from
    neq literals, and the product of all DFA constraints; eqv literals
    unify (or split) subjects after the per-subject solve."""
    by_subj: dict[tuple, dict] = {}
    eqv_pairs: list[AtomSem] = []
    for sem in sems:
        if sem.kind == "opaque":
            raise WitnessUnknown(f"opaque atom {sem.source}")
        if sem.kind == "eqv":
            eqv_pairs.append(sem)
            continue
        slot = by_subj.setdefault(sem.subject.id, {
            "subject": sem.subject, "eq": [], "neq": set(), "dfas": []})
        # keep the richest probe view (a later literal may carry the
        # defaulted form of the same subject)
        if sem.subject.has_default:
            slot["subject"] = sem.subject
        if sem.kind == "eq":
            (slot["eq"].append(sem.value) if not sem.negated
             else slot["neq"].add(sem.value))
        else:
            slot["dfas"].append(sem.dfa)

    values: dict[tuple, Any] = {}
    n = 0
    for sid, slot in by_subj.items():
        subj: Subject = slot["subject"]
        eqs = set(slot["eq"])
        if len(eqs) > 1:
            raise WitnessUnsat(f"conflicting eq on {sid}")
        if eqs:
            v = next(iter(eqs))
            if v in slot["neq"]:
                raise WitnessUnsat(f"eq/neq clash on {sid}")
            for dfa in slot["dfas"]:
                acc = _dfa_accepts(dfa, v)
                if acc is False:
                    raise WitnessUnsat(f"eq vs pattern clash on {sid}")
                if acc is None:
                    raise WitnessUnknown(f"non-string pattern on {sid}")
            values[sid] = v
        elif slot["dfas"]:
            dfa = slot["dfas"][0]
            for other in slot["dfas"][1:]:
                # narrow by product: enumerate from the intersection
                r = dfa_ops.product_intersect(dfa, other)
                if r.empty is True:
                    raise WitnessUnsat(f"empty pattern product on {sid}")
                if r.empty is None:
                    raise WitnessUnknown(f"pattern budget on {sid}")
            forbid = frozenset(v for v in slot["neq"]
                               if isinstance(v, str))
            found = None
            for w in dfa_ops.accepted_strings(
                    _product_all(slot["dfas"]), limit=8, forbid=forbid):
                try:
                    found = w.decode("utf-8")
                    break
                except UnicodeDecodeError:
                    continue
            if found is None:
                raise WitnessUnknown(f"no decodable witness for {sid}")
            values[sid] = found
        else:
            vtype = finder.get_attribute(subj.name) \
                if subj.kind == "var" else V.STRING
            if subj.kind == "map":
                vtype = V.STRING
            values[sid] = _fresh_value(vtype, slot["neq"], n)
            n += 1

    for sem in eqv_pairs:
        ida, idb = sem.subject.id, sem.other.id
        va, vb = values.get(ida), values.get(idb)
        if not sem.negated:
            if va is None and vb is None:
                vtype = finder.get_attribute(sem.subject.name) \
                    if sem.subject.kind == "var" else V.STRING
                va = vb = _fresh_value(vtype, set(), n)
                n += 1
            elif va is None:
                va = vb
            elif vb is None:
                vb = va
            elif va != vb:
                raise WitnessUnsat("eqv subjects pinned to different "
                                   "values")
            values[ida], values[idb] = va, vb
            by_subj.setdefault(ida, {"subject": sem.subject, "eq": [],
                                     "neq": set(), "dfas": []})
            by_subj.setdefault(idb, {"subject": sem.other, "eq": [],
                                     "neq": set(), "dfas": []})
        else:
            if va is not None and vb is not None and va == vb:
                raise WitnessUnsat("neqv subjects pinned equal")
            if va is None:
                vtype = finder.get_attribute(sem.subject.name) \
                    if sem.subject.kind == "var" else V.STRING
                values[ida] = _fresh_value(
                    vtype, {vb} if vb is not None else set(), n)
                n += 1
                by_subj.setdefault(ida, {"subject": sem.subject,
                                         "eq": [], "neq": set(),
                                         "dfas": []})
            if vb is None:
                vtype = finder.get_attribute(sem.other.name) \
                    if sem.other.kind == "var" else V.STRING
                values[idb] = _fresh_value(vtype, {values[ida]}, n)
                n += 1
                by_subj.setdefault(idb, {"subject": sem.other,
                                         "eq": [], "neq": set(),
                                         "dfas": []})

    bag: dict[str, Any] = {}
    for sid, v in values.items():
        subj = by_subj[sid]["subject"]
        if subj.has_default and v == subj.default:
            continue                 # absence yields the default value
        if subj.kind == "var":
            bag[subj.name] = v
        else:
            bag.setdefault(subj.name, {})[subj.key] = \
                v if isinstance(v, str) else str(v)
    return bag


def _product_all(dfas: list[DFA]) -> DFA:
    """Fold DFAs into one intersection automaton (explicit product;
    used only for witness enumeration, sizes pre-checked by caller)."""
    import numpy as np

    cur = dfas[0]
    for other in dfas[1:]:
        sa, sb = cur.transitions.shape[0], other.transitions.shape[0]
        if sa * sb > 4096:
            raise WitnessUnknown("witness product too large")
        trans = (cur.transitions[:, None, :] * sb
                 + other.transitions[None, :, :]).reshape(sa * sb, -1)
        accept = (cur.accept[:, None]
                  & other.accept[None, :]).reshape(-1)
        cur = DFA(transitions=trans.astype(np.int32), accept=accept,
                  pattern=f"({cur.pattern})&({other.pattern})")
    return cur
