"""RBAC → device ruleset lowering (the fused NFA authz showcase).

Reference semantics: mixer/adapter/rbac/rbac.go:181 HandleAuthorization —
a request is ALLOWED iff some ServiceRoleBinding in the action's
namespace binds the request's subject to a ServiceRole with an access
rule matching the action; otherwise "RBAC: permission denied". Every
comparison is stringMatch (rbac.go: exact, `*`, prefix `ab*`, suffix
`*ab`) over values the authorization-template instance computed from
attributes.

Instead of running that nested host loop per request, the policy is
compiled into the SAME monotone-DNF ruleset machinery that matches rule
predicates (compiler/ruleset.py): each (binding, subject, role-rule)
triple becomes one PSEUDO-RULE whose match expression is the
conjunction of its subject/action clauses — built by substituting the
instance's field expressions into the pattern atoms:

    user == "alice"            →  EQ(<subject.user expr>, "alice")
    services: ["*.prod.svc"]   →  endsWith(<action.service expr>, ...)
    constraint k in {v1, v2}   →  LOR(EQ(props[k], v1), EQ(props[k], v2))

A request is allowed iff ANY pseudo-rule matches — a row-wise OR the
PolicyEngine evaluates with one gather (models/policy_engine.RbacSpec).
This is the TPU-shaped formulation: 1k role rules are 1k extra ROWS in
the one batched match program, not 1k host loop iterations per request.

Host/device parity for evaluation errors: the host path builds the
whole instance first and any field-expression error (missing attribute
without `|` fallback) aborts the action with INTERNAL
(runtime/dispatcher.py _safe_check). The lowering therefore also emits
one GUARD pseudo-rule per instance — the conjunction of EQ(e, e) for
every field expression e, which is definitely-true iff every field
evaluates and inconclusive iff any errors — and the engine maps
guard-not-matched to INTERNAL, exactly mirroring the host path.

Host-oracle conformance: adapters/rbac.py remains the semantics oracle;
tests/test_rbac_lower.py checks device == host verdict over a
property-rich corpus. Constructs outside the lowerable subset (non-
string property expressions, patterns against empty-string sentinel
semantics the host computes differently) raise RbacLowerError and the
whole action stays on the host overlay — never a silent divergence.

Port of istio_tpu/compiler/rbac_lower.py: host code, the reference's
own, so the port's snapshot lowers the same pseudo-rules in the same
order.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder,
                                    DEFAULT_FUNCS, eval_type)
from istio_tpu_torch.expr.exprs import Expression, const_expr, fn_expr

V = ValueType


class RbacLowerError(ValueError):
    """Policy/instance shape the device lowering does not cover —
    callers keep the action on the host adapter."""


@dataclasses.dataclass
class LoweredRbac:
    """Synthesized predicates for one (policy set, instance) pair."""
    allow_asts: list[Expression]     # pseudo-rule per (binding,subject,rule)
    guard_ast: Expression | None     # None: instance has no expressions
    n_triples: int                   # diagnostics: triples considered


# --- tiny AST builders (constant-folded where the value is known) ----

_TRUE = object()    # sentinel: clause statically true → drop from AND
_FALSE = object()   # sentinel: clause statically false → kill the conj


def _sconst(v: str) -> Expression:
    # json.dumps text keeps the dedup key (str(ast), see
    # ruleset._AtomTable) collision-free for values with quotes
    return const_expr(v, V.STRING, text=json.dumps(v))


def _land(clauses: list) -> Any:
    real = [c for c in clauses if c is not _TRUE]
    if any(c is _FALSE for c in real):
        return _FALSE
    if not real:
        return _TRUE
    out = real[0]
    for c in real[1:]:   # binary left-nesting: the checker's LAND is 2-ary
        out = fn_expr("LAND", out, c)
    return out


def _lor(alts: list) -> Any:
    real = [a for a in alts if a is not _FALSE]
    if any(a is _TRUE for a in real):
        return _TRUE
    if not real:
        return _FALSE
    out = real[0]
    for a in real[1:]:
        out = fn_expr("LOR", out, a)
    return out


def _string_match_clause(pattern: str, field: Expression | str) -> Any:
    """stringMatch(pattern, field) as an expression clause; `field` is
    the instance expression AST, or a python string when the instance
    omits the field (the host then compares against "", rbac.go's
    zero-value read) — folded to a constant verdict here."""
    if pattern == "*":
        return _TRUE
    if isinstance(field, str):   # constant fold against the known value
        if pattern.endswith("*"):
            ok = field.startswith(pattern[:-1])
        elif pattern.startswith("*"):
            ok = field.endswith(pattern[1:])
        else:
            ok = pattern == field
        return _TRUE if ok else _FALSE
    if pattern.endswith("*"):
        return fn_expr("startsWith", _sconst(pattern[:-1]), target=field)
    if pattern.startswith("*"):
        return fn_expr("endsWith", _sconst(pattern[1:]), target=field)
    return fn_expr("EQ", field, _sconst(pattern))


def _any_match_clause(patterns: Sequence[str], field) -> Any:
    """rbac.go _any_match: empty pattern list matches everything."""
    if not patterns:
        return _TRUE
    return _lor([_string_match_clause(str(p), field) for p in patterns])


def _eq_clause(field: Expression | str, value: str) -> Any:
    if isinstance(field, str):
        return _TRUE if field == value else _FALSE
    return fn_expr("EQ", field, _sconst(value))


# --- instance expression access ------------------------------------


def _field(tree: Mapping[str, Any], *path: str) -> Expression | str:
    """Expression AST at subject/action path, or "" when omitted (the
    host handler's .get(..., "") default)."""
    node: Any = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return ""
        node = node[p]
    if isinstance(node, Expression):
        return node
    return ""


def _prop(tree: Mapping[str, Any], group: str, key: str
          ) -> Expression | str:
    props = tree.get(group, {})
    props = props.get("properties", {}) if isinstance(props, Mapping) \
        else {}
    node = props.get(key, "")
    return node if isinstance(node, Expression) else ""


def _require_string(e: Expression | str, what: str,
                    finder: AttributeDescriptorFinder) -> None:
    if isinstance(e, Expression):
        t = eval_type(e, finder, DEFAULT_FUNCS)
        if t != V.STRING:
            # host compares str(value) — a non-string device EQ would
            # compare raw intern ids and diverge (e.g. int 5 vs "5")
            raise RbacLowerError(
                f"{what}: non-STRING expression ({t.name}) — host "
                f"stringifies, device cannot")


# --- the lowering ----------------------------------------------------


def lower_rbac(roles: Sequence[Mapping[str, Any]],
               bindings: Sequence[Mapping[str, Any]],
               inst_exprs: Mapping[str, Any],
               finder: AttributeDescriptorFinder,
               max_pseudo_rules: int = 20_000) -> LoweredRbac:
    """Lower one rbac policy set against one authorization instance.

    `inst_exprs` is the instance's expression tree
    ({"subject": {"user": Expression, "properties": {k: Expression}},
    "action": {...}}, from InstanceBuilder.expr_tree()). Raises
    RbacLowerError when any construct is outside the fusable subset.
    """
    role_by_key = {(str(r.get("namespace", "")), str(r.get("name", ""))): r
                   for r in roles}

    ns_field = _field(inst_exprs, "action", "namespace")
    user_field = _field(inst_exprs, "subject", "user")
    group_field = _field(inst_exprs, "subject", "groups")
    svc_field = _field(inst_exprs, "action", "service")
    method_field = _field(inst_exprs, "action", "method")
    path_field = _field(inst_exprs, "action", "path")
    for e, what in ((ns_field, "action.namespace"),
                    (user_field, "subject.user"),
                    (group_field, "subject.groups"),
                    (svc_field, "action.service"),
                    (method_field, "action.method"),
                    (path_field, "action.path")):
        _require_string(e, what, finder)

    allow: list[Expression] = []
    n_triples = 0
    for b in bindings:
        bns = str(b.get("namespace", ""))
        ns_clause = _eq_clause(ns_field, bns)
        if ns_clause is _FALSE:
            continue
        role = role_by_key.get(
            (bns, str((b.get("roleRef") or {}).get("name", ""))))
        if role is None:
            continue
        for subj in (b.get("subjects") or ()):
            s_clauses = [ns_clause]
            # host parity (rbac.go _subject_bound): user/group compare
            # RAW config values against string instance fields — a
            # non-string value (unquoted YAML number) can never equal a
            # string, so the subject is statically unbindable
            if "user" in subj and subj["user"] != "*":
                if not isinstance(subj["user"], str):
                    continue
                s_clauses.append(_eq_clause(user_field, subj["user"]))
            if "group" in subj and subj["group"] != "*":
                if not isinstance(subj["group"], str):
                    continue
                s_clauses.append(_eq_clause(group_field, subj["group"]))
            for k, v in sorted((subj.get("properties") or {}).items()):
                pf = _prop(inst_exprs, "subject", str(k))
                _require_string(pf, f"subject.properties[{k}]", finder)
                s_clauses.append(_eq_clause(pf, str(v)))
            subj_clause = _land(s_clauses)
            if subj_clause is _FALSE:
                continue
            for rule in (role.get("rules") or ()):
                n_triples += 1
                pats = {}
                for fld in ("services", "methods", "paths"):
                    pats[fld] = list(rule.get(fld) or ())
                    for p in pats[fld]:
                        if not isinstance(p, str):
                            # host _string_match would AttributeError →
                            # adapter-panic INTERNAL; keep on host
                            raise RbacLowerError(
                                f"{fld}: non-string pattern "
                                f"{type(p).__name__}")
                clauses = [subj_clause,
                           _any_match_clause(pats["services"],
                                             svc_field),
                           _any_match_clause(pats["methods"],
                                             method_field),
                           _any_match_clause(pats["paths"], path_field)]
                ok = True
                for c in (rule.get("constraints") or ()):
                    key = str(c.get("key", ""))
                    vals = [str(v) for v in (c.get("values") or ())]
                    pf = _prop(inst_exprs, "action", key)
                    _require_string(pf, f"constraint[{key}]", finder)
                    cc = _lor([_eq_clause(pf, v) for v in vals])
                    if cc is _FALSE:
                        ok = False
                        break
                    clauses.append(cc)
                if not ok:
                    continue
                conj = _land(clauses)
                if conj is _FALSE:
                    continue
                if conj is _TRUE:
                    conj = const_expr(True, V.BOOL)
                allow.append(conj)
                if len(allow) > max_pseudo_rules:
                    raise RbacLowerError(
                        f"policy expands past {max_pseudo_rules} "
                        f"pseudo-rules")

    guard = _land([fn_expr("EQ", e, e)
                   for e in _walk_exprs(inst_exprs)])
    guard_ast = None if guard in (_TRUE, _FALSE) else guard
    return LoweredRbac(allow_asts=allow, guard_ast=guard_ast,
                       n_triples=n_triples)


def _walk_exprs(tree: Any) -> list[Expression]:
    out: list[Expression] = []
    if isinstance(tree, Expression):
        return [tree]
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            out.extend(_walk_exprs(tree[k]))
    return out
